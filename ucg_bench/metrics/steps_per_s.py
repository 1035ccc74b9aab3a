"""Steps of the window's ``run`` over that call's wall time (host clock,
ending in a device synchronization): every rebuild, thermo row, event and,
on slabs, the final gather is inside it."""


def read(ctx):
    return ctx["steps"] / ctx["window_s"]
