"""Device time under the spans around the simulation's pair pass, less the
packing spans inside them, per step of the traced sub-window (mean over
ranks)."""

from ucg_bench.metrics import traced


def read(ctx):
    ranks = traced(ctx)
    if not ranks:
        return None
    vals = [1e3 * (r["trace"]["span"].get("pair", (0, 0.0))[1]
                   - r["trace"]["pack_in_pair"]) / r["trace_steps"]
            for r in ranks]
    return sum(vals) / len(vals)
