"""The label sweeps an event ran, as the event reports them, mean over the
window's events."""


def read(ctx):
    sw = ctx["sweeps"]
    return sum(sw) / len(sw) if sw else None
