"""Device time under the spans around ``Simulation._rebuild`` (the wrap and
the list build), per rebuild in the traced sub-window.  The slab driver
builds its local list inside its own block, with no ``_rebuild``: the
metric lists the one-card cells."""

from ucg_bench.metrics import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, "rebuild")
