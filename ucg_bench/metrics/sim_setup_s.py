"""Host seconds from the runner's ``_make_sim`` (kernel selection, the
table fit, the column spec) through the simulation's first ``setup``,
ending in a device synchronization; the slowest rank."""


def read(ctx):
    return max(r["sim_setup_s"] for r in ctx["ranks"])
