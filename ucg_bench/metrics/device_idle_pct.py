"""The share of the traced sub-window in which no kernel, copy or fill ran
on the device (the union of the trace's device intervals against the
sub-window's host-clock length), mean over ranks.  It carries the
profiler's own host overhead."""

from ucg_bench.metrics import traced


def read(ctx):
    ranks = traced(ctx)
    if not ranks:
        return None
    return sum(100.0 * (1.0 - r["trace"]["busy"] / r["trace_s"])
               for r in ranks) / len(ranks)
