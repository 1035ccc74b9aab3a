"""Device time under the packing spans (``colpack.pack``,
``colpack.pack_slots``, ``Simulation._to_slots`` and ``_from_slots``) per
step of the traced sub-window (mean over ranks)."""

from ucg_bench.metrics import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "pack")
