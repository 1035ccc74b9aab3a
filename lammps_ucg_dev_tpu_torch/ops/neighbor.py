"""Fixed-shape full neighbor lists (port of
``lammps_ucg_dev_tpu/ops/neighbor.py``).

A **full** padded list (every atom sees all of its neighbors; newton-off
semantics) lets each atom own its force, λ-force and score tallies with no
reverse scatter.  Only the ``nsq`` (all-pairs) method is ported; it is the
reference pair path's list and the correctness oracle.  The binned ``cell``
method is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box


@dataclasses.dataclass(frozen=True)
class NeighborList:
    idx: torch.Tensor            # (N, K) int64; padded entries == N
    x0: torch.Tensor             # (N, 3) positions at build time
    overflow: torch.Tensor       # () bool — capacity exceeded (list invalid)
    max_occupancy: torch.Tensor  # () int — max real neighbors seen
    capacity: int

    @property
    def n_atoms(self) -> int:
        return self.idx.shape[0]


@dataclasses.dataclass(frozen=True)
class NeighborSpec:
    """Static neighbor-search configuration (host-side)."""

    cutoff: float                  # largest interaction cutoff
    skin: float = 0.3
    capacity: int = 64             # K, max neighbors per atom
    chunk: int = 4096              # rows per all-pairs block

    @property
    def rc(self) -> float:
        return self.cutoff + self.skin


def estimate_capacity(n_atoms: int, box_lengths, cutoff: float,
                      skin: float, safety: float = 1.6) -> int:
    """Heuristic K from mean density: mean + 6σ + slack (the JAX package's
    ``estimate_capacities`` K)."""
    vol = float(np.prod(np.asarray(box_lengths, dtype=np.float64)))
    rho = n_atoms / vol
    rc = cutoff + skin
    mean_k = rho * 4.0 / 3.0 * math.pi * rc**3
    return int(math.ceil(max(safety * mean_k,
                             mean_k + 6.0 * math.sqrt(max(mean_k, 1.0))))) + 8


def make_spec(n_atoms: int, box_lengths, cutoff: float, skin: float = 0.3,
              method: str = "nsq", capacity: int | None = None,
              chunk: int = 4096) -> NeighborSpec:
    if method != "nsq":
        raise NotImplementedError(
            f"neighbor method {method!r} is not ported yet (nsq only)")
    return NeighborSpec(
        cutoff=cutoff, skin=skin, chunk=chunk,
        capacity=(capacity if capacity is not None else
                  estimate_capacity(n_atoms, box_lengths, cutoff, skin)))


def build_nsq(x: torch.Tensor, box: Box, spec: NeighborSpec) -> NeighborList:
    """All-pairs list, evaluated in row blocks of ``spec.chunk``.  Each
    row keeps its first K in-range partners in ascending index order (the
    JAX package's ``_compact_topk`` order)."""
    n = x.shape[0]
    K = spec.capacity
    rc2 = torch.as_tensor(spec.rc**2, dtype=x.dtype, device=x.device)
    cols = torch.arange(n, device=x.device)
    idx_blocks, count_blocks = [], []
    for r0 in range(0, n, spec.chunk):
        r1 = min(n, r0 + spec.chunk)
        dr = box.min_image(x[r0:r1, None, :] - x[None, :, :])
        rsq = torch.sum(dr * dr, dim=-1)
        rows = torch.arange(r0, r1, device=x.device)
        mask = (rsq < rc2) & (cols[None, :] != rows[:, None])
        cand = torch.where(mask, cols[None, :], n)
        srt = torch.sort(cand, dim=1).values
        if srt.shape[1] < K:
            srt = torch.nn.functional.pad(srt, (0, K - srt.shape[1]), value=n)
        idx_blocks.append(srt[:, :K])
        count_blocks.append(mask.sum(dim=1))
    count = torch.cat(count_blocks)
    mx = count.max()
    return NeighborList(idx=torch.cat(idx_blocks), x0=x, overflow=mx > K,
                        max_occupancy=mx, capacity=K)


def displacement_check(nbr, x: torch.Tensor, box: Box,
                       skin: float) -> torch.Tensor:
    """True if any atom moved more than skin/2 since the structure ``nbr``
    (a NeighborList or a ColumnList) was built — the LAMMPS 'dangerous
    build' condition."""
    dr = box.min_image(x - nbr.x0)
    return torch.max(torch.sum(dr * dr, dim=-1)) > (0.5 * skin) ** 2
