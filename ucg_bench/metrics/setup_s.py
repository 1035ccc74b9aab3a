"""From the kernels' loading (and, in a run that compiles, their build)
and the runner's first deck command through the end of the warm-up, on the
slowest rank.  The benchmark's writing of the data file is printed apart."""


def read(ctx):
    return max(r["setup_s"] for r in ctx["ranks"])
