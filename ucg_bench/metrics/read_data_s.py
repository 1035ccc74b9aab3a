"""Host seconds of the deck's ``read_data`` command, on the slowest rank."""


def read(ctx):
    return max(r["read_data_s"] for r in ctx["ranks"])
