"""One reader a metric, found by the metric's name in BENCHMARK.json:
``read(ctx)`` returns the number, or None where the run has nothing to
read (the harness then leaves the metric out).  ``ctx`` holds rank 0's
window readings at the top level and every rank's under ``ranks``."""

import numpy as np


def traced(ctx):
    return [r for r in ctx["ranks"] if "trace" in r]


def span_ms_per_step(ctx, name):
    ranks = traced(ctx)
    if not ranks:
        return None
    return float(np.mean([1e3 * r["trace"]["span"].get(name, (0, 0.0))[1]
                          / r["trace_steps"] for r in ranks]))


def span_ms_per_call(ctx, name):
    calls = sum(r["trace"]["span"].get(name, (0, 0.0))[0]
                for r in traced(ctx))
    if not calls:
        return None
    return 1e3 * sum(r["trace"]["span"][name][1] for r in traced(ctx)
                     if name in r["trace"]["span"]) / calls
