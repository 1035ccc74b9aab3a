"""``Ring.stats`` bytes sent over every kind of exchange, per step of the
counted sub-window, in MB (10^6 bytes), mean over ranks."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r.get("ring_stats")]
    if not ranks:
        return None
    return sum(1e-6 * sum(v[2] for v in r["ring_stats"].values())
               / r["stats_steps"] for r in ranks) / len(ranks)
