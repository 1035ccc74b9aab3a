"""The 95th percentile over all blocks of the window of the interval
between successive block starts on rank 0, read from CUDA events recorded
at each block's entry (device timestamps; the last block runs to the end of
the ``run`` call).  A block is ``reneigh_every`` steps with whatever
rebuild, event or thermo row the run loop adds to it."""

import numpy as np


def read(ctx):
    ms = ctx["block_ms"]
    return float(np.percentile(ms, 95)) if len(ms) else None
