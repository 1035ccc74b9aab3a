"""The least time of a step's pair work (``ucg_bench/roofline``) over the
measured pair time a step (``pair_ms_per_step``), in percent.  On several
ranks the whole system's work is shared evenly."""

from ucg_bench import roofline
from ucg_bench.metrics import pair_ms_per_step


def read(ctx):
    r0 = ctx["ranks"][0]
    ms = pair_ms_per_step.read(ctx)
    if not ms or "pairs" not in r0:
        return None
    nt, tl = r0["physics_tables"]
    least = roofline.least_seconds(ctx["config"]["pair_style"], r0["pairs"],
                                   r0["n_atoms"], nt, tl) / ctx["world"]
    return 100.0 * least / (ms * 1e-3)
