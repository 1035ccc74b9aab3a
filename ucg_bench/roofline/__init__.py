"""The least time of one step's pair work on the card, from the physics
alone: the step's in-cutoff pairs, counted by the benchmark's own cell list
over the positions at the traced sub-window's start, times a fixed count of
operations per pair written in ``<pair_style>.py``, and each bead's inputs
read once, its outputs written once and the tables read once.  Nothing comes
from the program's list, its padding, its table fit or the kernel variant
that ran, so a redesign of any of them leaves the yardstick where it was."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch

from ucg_bench.reference.pairs import pairs_within

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> dict:
    with open(PEAKS) as fh:
        return json.load(fh)


def count_pairs(ph, x, typ, L) -> int:
    """Unordered pairs closer than their type pair's table cutoff."""
    i, j = pairs_within(x, L, ph.max_cutoff, half=True)
    typ = typ.long()
    xd = x.double()
    Lt = torch.as_tensor(L, dtype=torch.float64, device=x.device)
    dr = xd[i] - xd[j]
    dr = dr - Lt * torch.round(dr / Lt)
    cutsq = torch.as_tensor(ph.cutsq, dtype=torch.float64, device=x.device)
    return int(((dr * dr).sum(-1) < cutsq[typ[i], typ[j]]).sum())


def work(style: str, pairs: int, n_atoms: int, n_tables: int,
         table_len: int):
    """(operations, bytes) of one step's pair work of ``style``."""
    m = importlib.import_module(f"ucg_bench.roofline.{style}")
    return (pairs * m.OPS_PER_PAIR,
            n_atoms * m.BYTES_PER_BEAD
            + n_tables * table_len * m.TABLE_CHANNELS * 4)


def least_seconds(style, pairs, n_atoms, n_tables, table_len) -> float:
    ops, nbytes = work(style, pairs, n_atoms, n_tables, table_len)
    pk = peaks()
    return max(ops / pk["flops_per_s"], nbytes / pk["bytes_per_s"])
