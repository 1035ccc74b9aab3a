"""Device time under the span around ``Simulation._cswitch_event`` (the
wrap, the contact list, the labels and the flips), per event in the traced
sub-window."""

from ucg_bench.metrics import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, "event")
