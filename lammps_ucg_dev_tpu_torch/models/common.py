"""Shared per-pair machinery for the UCG pair styles (port of
``lammps_ucg_dev_tpu/models/common.py``).

The per-atom-owned (newton-off) formulation means each directed pair (i, j)
contributes only to atom i's tallies; summing over the full list reproduces
the reference's half-list + reverse-comm totals.
"""

from __future__ import annotations

import torch

from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.table import TableBank


def row_slices(n: int, chunk: int):
    """Row blocks of a per-atom-owned pair pass: ``chunk`` rows each (the
    last may be shorter), or one block when ``chunk`` is 0 or >= n.  Every
    tally is per-atom-owned, so chunking is exact; it bounds the (rows, K)
    working set."""
    step = chunk if chunk and n > chunk else max(n, 1)
    return [slice(r0, min(n, r0 + step)) for r0 in range(0, n, step)]


def pair_rows(state, nbr, rows: slice, cutsq: torch.Tensor,
              typ: torch.Tensor):
    """Geometry of one row block of a full neighbor list: (jc, tj, within,
    dr, rsq) with ``within`` the real pairs inside ``cutsq[ti, tj]``
    (``typ`` indexes ``cutsq``)."""
    n = state.n_atoms
    idx = nbr.idx[rows]
    valid = idx < n
    jc = torch.where(valid, idx, torch.zeros_like(idx))
    dr = state.box.min_image(state.x[rows][:, None, :] - state.x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    tj = typ[jc]
    within = valid & (rsq < take2d(cutsq, typ[rows][:, None], tj))
    return jc, tj, within, dr, rsq


def take2d(arr: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """arr[i, j] for a small 2-D-indexed table through one flat-index take."""
    n1 = arr.shape[1]
    flat = arr.reshape((arr.shape[0] * n1,) + tuple(arr.shape[2:]))
    return flat[i * n1 + j]


def eval_state_block(bank: TableBank, tp: UCGTypeParams, ti: torch.Tensor,
                     tj: torch.Tensor, rsq: torch.Tensor,
                     within: torch.Tensor):
    """Evaluate the up-to-4 state-combination tables for every pair.

    ti: (N, 1) actual types of i (broadcast), tj: (N, K) of j.
    Returns (e4, fp4, oob_lo, oob_hi): e4/fp4 have shape (N, K, 2, 2) with
    axes [..., si, sj], zeroed outside ``within``.  With a uniform bank
    (LINEAR only, ``TableBank.from_built``) the range flags are the same
    for all four combinations, so each pair counts once (the JAX package's
    gather path); otherwise, every other style included, each combination
    counts.
    """
    t4 = take2d(tp.tab4, ti.expand_as(tj), tj)              # (N, K, 2, 2)
    e4, fp4, lo, hi = bank.interp(t4, rsq[..., None, None])
    w4 = within[..., None, None]
    zero = torch.zeros((), dtype=e4.dtype, device=e4.device)
    e4 = torch.where(w4, e4, zero)
    fp4 = torch.where(w4, fp4, zero)
    if bank.uniform:
        lo, hi, w4 = lo[..., 0, 0], hi[..., 0, 0], within
    return e4, fp4, torch.sum(w4 & lo), torch.sum(w4 & hi)


def lambda_weights(tp: UCGTypeParams, typ: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """Per-atom state weights: [1-λ, λ] for UCG atoms, [1, 0] otherwise
    (unifies the reference's four per-pair scenarios,
    pair_table_ucgld.cpp:219-519)."""
    w1 = torch.where(tp.n_states[typ] > 1, lam, torch.zeros_like(lam))
    return torch.stack([1.0 - w1, w1], dim=-1)           # (N, 2)


def mix(e4: torch.Tensor, wi: torch.Tensor, wj: torch.Tensor) -> torch.Tensor:
    """Σ_{si,sj} wi[si] wj[sj] e4[..., si, sj] → (N, K)."""
    return torch.einsum("ns,nkt,nkst->nk", wi, wj, e4)


def pair_virial(fmix: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """Per-pair virial components, full-list double counting halved.
    Order: xx yy zz xy xz yz (LAMMPS convention)."""
    w = 0.5 * fmix
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    return torch.stack([torch.sum(w * dr[..., a] * dr[..., b])
                        for a, b in pairs])


def softmax_posterior(scores: torch.Tensor, is_ucg: torch.Tensor,
                      clip_lo: float = 1e-6) -> torch.Tensor:
    """ucgp = clamp(softmax(scores)[1]) as in FixUCGState::post_force
    (fix_ucgstate.cpp:105-111): exp clamp at 700, result clamped to
    [1e-6, 1-1e-6]; 1 for non-UCG atoms."""
    s = torch.clamp(scores, max=700.0)
    s = s - torch.max(s, dim=-1, keepdim=True).values
    ex = torch.exp(s)
    p1 = ex[..., 1] / torch.sum(ex, dim=-1)
    p1 = torch.clamp(p1, clip_lo, 1.0 - clip_lo)
    return torch.where(is_ucg, p1, torch.ones_like(p1))
