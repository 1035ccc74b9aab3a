"""Every pair of beads closer than a cutoff in a periodic orthogonal box, by
a cell list of the benchmark's own: cells at least one cutoff wide, each
bead against the 27 cells around its own, in row blocks so that the
candidates fit.  Distances in float64, whatever the caller computes in."""

from __future__ import annotations

import torch

CANDIDATES = 1 << 25        # candidate pairs a row block may hold


def pairs_within(x: torch.Tensor, L, cutoff: float, half: bool = False):
    """(i, j) int64 of every directed pair (i ≠ j) with minimum-image
    distance below ``cutoff``; ``half`` keeps i < j only.  ``x`` is (N, 3)
    in any frame (it is wrapped here); ``L`` the box lengths.  A row that
    is not finite has no pairs."""
    dev = x.device
    x = x.to(torch.float64)
    L = torch.as_tensor(L, dtype=torch.float64, device=dev)
    good = torch.isfinite(x).all(1).nonzero().squeeze(1)
    if good.numel() < x.shape[0]:
        i, j = pairs_within(x[good], L, cutoff, half)
        return good[i], good[j]
    n = x.shape[0]
    m = torch.clamp(torch.floor(L / cutoff), min=1).to(torch.int64)
    if bool((m < 3).any()):
        raise ValueError("the box is under three cutoffs wide")
    xw = x - L * torch.floor(x / L)
    c = torch.minimum((xw / (L / m)).to(torch.int64), m - 1)
    cid = (c[:, 0] * m[1] + c[:, 1]) * m[2] + c[:, 2]
    order = torch.argsort(cid)
    counts = torch.bincount(cid, minlength=int(m.prod()))
    start = torch.cumsum(counts, 0) - counts
    cmax = int(counts.max())
    off = torch.stack(torch.meshgrid(*[torch.arange(-1, 2, device=dev)] * 3,
                                     indexing="ij"), -1).reshape(27, 3)
    slot = torch.arange(cmax, device=dev)
    cut2 = cutoff * cutoff
    out_i, out_j = [], []
    block = max(1, CANDIDATES // (27 * cmax))
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(n, r0 + block), device=dev)
        nc = torch.remainder(c[rows][:, None, :] + off[None], m)   # (B,27,3)
        ncid = (nc[..., 0] * m[1] + nc[..., 1]) * m[2] + nc[..., 2]
        k = start[ncid][..., None] + slot                           # (B,27,C)
        ok = slot < counts[ncid][..., None]
        j = order[torch.where(ok, k, 0)].reshape(len(rows), -1)
        ok = ok.reshape(len(rows), -1) & (j != rows[:, None])
        if half:
            ok &= rows[:, None] < j
        dr = xw[rows][:, None, :] - xw[j]
        dr = dr - L * torch.round(dr / L)
        ok &= (dr * dr).sum(-1) < cut2
        ii, kk = ok.nonzero(as_tuple=True)
        out_i.append(rows[ii])
        out_j.append(j[ii, kk])
    return torch.cat(out_i), torch.cat(out_j)


def min_image(dr: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return dr - L * torch.round(dr / L)
