"""``fix cluster_switch molID_seed mol_offset cutoff seed rateFreq f
rateFile r contactFile c``: the event's settings and its two side files
(the event itself: ``reference/switch.py``)."""

from __future__ import annotations

import os


def parse(args: list, workdir: str) -> dict:
    opts = dict(zip(args[4::2], args[5::2]))
    rates = open(os.path.join(workdir, opts["rateFile"])).read().split()
    nsw = int(rates[1])
    cont = open(os.path.join(workdir, opts["contactFile"])).read().splitlines()
    pairs = [tuple(int(v) for v in ln.split()) for ln in cont[2:]
             if ln.strip()]
    return {"switch": dict(
        mol_seed=int(args[0]), mol_offset=int(args[1]),
        cutoff=float(args[2]), freq=int(opts["rateFreq"]),
        probON=float(rates[0]), on=[int(v) for v in rates[2:2 + nsw]],
        off=[int(v) for v in rates[2 + nsw:2 + 2 * nsw]], contacts=pairs)}
