"""``Ring.stats`` seconds over every kind of exchange (migration, halo,
refresh), per step of the counted sub-window, mean over ranks.  The counter
synchronizes the device around each exchange, so it runs in the traced
run's second sub-window, after the profiled one."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r.get("ring_stats")]
    if not ranks:
        return None
    return sum(1e3 * sum(v[1] for v in r["ring_stats"].values())
               / r["stats_steps"] for r in ranks) / len(ranks)
