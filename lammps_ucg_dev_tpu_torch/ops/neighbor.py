"""Fixed-shape full neighbor lists (port of
``lammps_ucg_dev_tpu/ops/neighbor.py``).

A **full** padded list (every atom sees all of its neighbors; newton-off
semantics) lets each atom own its force, λ-force and score tallies with no
reverse scatter.  Two builders, both the reference pair path's lists:

* ``nsq`` — O(N²) all-pairs, evaluated in row blocks (small systems, the
  correctness oracle);
* ``cell`` — O(N) binned: atoms are scattered into a capacity-padded cell
  grid, candidates gathered from the 27-cell stencil and compacted to a
  fixed ``(N, K)`` index array; candidate evaluation is chunked over atoms so
  peak memory is ``chunk × 27·cell_capacity``.

Both keep each row's first K partners in candidate order (ascending index
for ``nsq``, stencil order for ``cell``) — the JAX package's
``_compact_topk`` order — so the lists equal the JAX package's row for row.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box

# the 27-cell stencil, x-major (the JAX package's order)
STENCIL = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)], dtype=np.int64)


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
    method: str = "cell"           # "cell" | "nsq"
    cell_capacity: int = 32        # max atoms per cell
    cells_per_side: tuple = ()     # computed at setup for "cell"
    chunk: int = 4096              # atoms per candidate block

    @property
    def rc(self) -> float:
        return self.cutoff + self.skin


def estimate_capacities(n_atoms: int, box_lengths, cutoff: float,
                        skin: float, safety: float = 1.6):
    """Heuristic (K, cell_capacity) from mean density: mean + 6σ + slack,
    so dilute uniform fluids stay within capacity too."""
    vol = float(np.prod(np.asarray(box_lengths, dtype=np.float64)))
    rho = n_atoms / vol
    rc = cutoff + skin
    mean_k = rho * 4.0 / 3.0 * math.pi * rc**3
    k = int(math.ceil(max(safety * mean_k,
                          mean_k + 6.0 * math.sqrt(max(mean_k, 1.0))))) + 8
    cc = int(math.ceil(safety * rho * rc**3)) + 4
    return k, cc


def make_spec(n_atoms: int, box_lengths, cutoff: float, skin: float = 0.3,
              method: str | None = None, capacity: int | None = None,
              cell_capacity: int | None = None,
              chunk: int = 4096) -> NeighborSpec:
    """Build a :class:`NeighborSpec`, choosing method and capacities as the
    JAX package does: ``cell`` once every side has >= 3 cells and
    n > 512, else ``nsq``."""
    L = np.asarray(box_lengths, dtype=np.float64)
    rc = cutoff + skin
    cps = np.maximum(np.floor(L / rc).astype(int), 1)
    if method is None:
        method = "cell" if (np.all(cps >= 3) and n_atoms > 512) else "nsq"
    if method == "cell" and np.any(cps < 3):
        raise ValueError(
            f"cell list needs >= 3 cells per side (got {tuple(cps)}); use nsq"
        )
    k_est, _ = estimate_capacities(n_atoms, L, cutoff, skin)
    # cell capacity from the actual cell volume (cells are >= rc when the
    # box does not divide evenly), with a Poisson-tail margin
    rho = n_atoms / float(np.prod(L))
    mean_occ = rho * float(np.prod(L / np.maximum(cps, 1)))
    cc_est = int(math.ceil(mean_occ + 6.0 * math.sqrt(max(mean_occ, 1.0)) + 8))
    return NeighborSpec(
        cutoff=cutoff, skin=skin,
        capacity=capacity if capacity is not None else k_est,
        method=method,
        cell_capacity=cell_capacity if cell_capacity is not None else cc_est,
        cells_per_side=tuple(int(c) for c in cps) if method == "cell" else (),
        chunk=chunk)


def compact_first(cand: torch.Tensor, mask: torch.Tensor, k: int, n: int):
    """The first k masked candidates of each row, in order, padded with n
    (the JAX package's ``_compact_topk``).  Returns (idx, count)."""
    rows, width = cand.shape
    count = mask.sum(dim=1)
    if width <= k:
        # as JAX: a row that fits is masked in place, not compacted
        idx = torch.where(mask, cand, n)
        return torch.nn.functional.pad(idx, (0, k - width), value=n), count
    pos = torch.cumsum(mask, dim=1) - 1
    dest = torch.where(mask & (pos < k), pos, k)      # k: a dump column
    out = torch.full((rows, k + 1), n, dtype=cand.dtype, device=cand.device)
    out.scatter_(1, dest, torch.where(mask, cand, n))
    return out[:, :k], count


def _excluded(cand: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """(rows, W) bool: candidate listed in its row of ``excl`` (rows, S)."""
    return torch.any(cand[:, :, None] == excl[:, None, :], dim=-1)


def build_nsq(x: torch.Tensor, box: Box, spec: NeighborSpec,
              excl: torch.Tensor | None = None) -> NeighborList:
    """All-pairs list, evaluated in row blocks of ``spec.chunk``: each row
    keeps its first K partners in ascending index order.  ``excl`` (N, S)
    rows are special partners (LAMMPS weight-0 ``special_bonds``) removed
    from each row's list, sentinel n."""
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
        cand = cols.expand(r1 - r0, n)
        if excl is not None:
            mask = mask & ~_excluded(cand, excl[r0:r1])
        idx, cnt = compact_first(cand, mask, K, n)
        idx_blocks.append(idx)
        count_blocks.append(cnt)
    count = torch.cat(count_blocks)
    mx = count.max()
    return NeighborList(idx=torch.cat(idx_blocks), x0=x, overflow=mx > K,
                        max_occupancy=mx, capacity=K)


def cell_index(x: torch.Tensor, box: Box, cps: np.ndarray):
    """(flat cell index, (N, 3) cell coordinates) of each atom on the
    static grid; atoms are assumed wrapped, the clip guards the open
    boundary edge."""
    cps_t = torch.as_tensor(np.asarray(cps), device=x.device)
    frac = (x - box.lo) / box.lengths
    c3 = torch.minimum(torch.clamp((frac * cps_t).to(torch.int64), min=0),
                       cps_t - 1)
    return (c3[:, 0] * int(cps[1]) + c3[:, 1]) * int(cps[2]) + c3[:, 2], c3


def stencil_cells(c3: torch.Tensor, cps: np.ndarray) -> torch.Tensor:
    """(rows, 27) flat indices of the 27 cells around cell coordinates
    ``c3`` (rows, 3), with periodic wrap, in stencil order."""
    cps_t = torch.as_tensor(np.asarray(cps), device=c3.device)
    nc3 = (c3[:, None, :] + torch.as_tensor(STENCIL, device=c3.device)) % cps_t
    return (nc3[..., 0] * int(cps[1]) + nc3[..., 1]) * int(cps[2]) + nc3[..., 2]


def build_cell(x: torch.Tensor, box: Box, spec: NeighborSpec,
               valid: torch.Tensor | None = None,
               i_valid: torch.Tensor | None = None,
               excl: torch.Tensor | None = None) -> NeighborList:
    """Binned builder with the 27-cell stencil, chunked candidate
    evaluation.  ``valid`` rows=False are parked in a shadow cell no stencil
    reaches, so they never appear as candidates; ``i_valid`` rows=False get
    empty lists (ghost rows own no tallies); ``excl`` (N, S) rows are
    special partners removed from each row's list (sentinel n).  ``x`` must
    be wrapped into the box."""
    if box.is_triclinic:
        raise ValueError("binned cell lists require an orthogonal box; "
                         "use method='nsq' for triclinic")
    n = x.shape[0]
    dev = x.device
    cps = np.asarray(spec.cells_per_side, dtype=np.int64)
    ncells = int(np.prod(cps))
    C, K = spec.cell_capacity, spec.capacity

    cid, c3 = cell_index(x, box, cps)
    if valid is not None:
        cid = torch.where(valid, cid, ncells)

    # scatter atoms into (ncells [+1 shadow], C) by sort + rank within cell
    order = torch.sort(cid, stable=True).indices
    sorted_cid = cid[order]
    nbins = ncells + (1 if valid is not None else 0)
    count = torch.bincount(cid, minlength=nbins)
    rank = (torch.arange(n, device=dev)
            - (torch.cumsum(count, 0) - count)[sorted_cid])
    if valid is not None:
        rank_real = torch.where(sorted_cid < ncells, rank, 0)
    else:
        rank_real = rank
    cell_overflow = torch.max(rank_real) >= C
    # (on overflow the clipped ranks collide; the flag discards the list)
    slot = torch.clamp(sorted_cid * C + torch.clamp(rank, 0, C - 1),
                       max=nbins * C - 1)
    cell_atoms = torch.full((nbins * C,), n, dtype=torch.int64, device=dev)
    cell_atoms[slot] = order
    if valid is not None:
        # shadow-cell rows are candidates nowhere; blank the bin so a
        # clipped overflow of parked rows cannot leak atom ids
        cell_atoms[ncells * C:] = n
    cell_atoms = cell_atoms.reshape(nbins, C)
    # cell-blocked positions, +inf on empty slots (rsq = inf: masked)
    occupied = (cell_atoms < n).reshape(-1, 1)
    xcells = torch.where(occupied, x[torch.clamp(cell_atoms.reshape(-1),
                                                 max=n - 1)],
                         torch.full((), math.inf, dtype=x.dtype, device=dev))
    xcells = xcells.reshape(nbins, C, 3)
    rc2 = torch.as_tensor(spec.rc**2, dtype=x.dtype, device=dev)

    idx_blocks, count_blocks = [], []
    for r0 in range(0, n, spec.chunk):
        r1 = min(n, r0 + spec.chunk)
        ncid = stencil_cells(c3[r0:r1], cps)                 # (rows, 27)
        cand = cell_atoms[ncid].reshape(r1 - r0, 27 * C)
        xj = xcells[ncid].reshape(r1 - r0, 27 * C, 3)
        dr = box.min_image(x[r0:r1, None, :] - xj)
        rsq = torch.sum(dr * dr, dim=-1)
        rows = torch.arange(r0, r1, device=dev)
        mask = (cand != n) & (cand != rows[:, None]) & (rsq < rc2)
        if i_valid is not None:
            mask = mask & i_valid[r0:r1, None]
        if excl is not None:
            mask = mask & ~_excluded(cand, excl[r0:r1])
        idx, cnt = compact_first(cand, mask, K, n)
        idx_blocks.append(idx)
        count_blocks.append(cnt)
    count = torch.cat(count_blocks)
    mx = count.max()
    return NeighborList(idx=torch.cat(idx_blocks), x0=x,
                        overflow=cell_overflow | (mx > K), max_occupancy=mx,
                        capacity=K)


def build(x: torch.Tensor, box: Box, spec: NeighborSpec,
          valid: torch.Tensor | None = None,
          i_valid: torch.Tensor | None = None,
          excl: torch.Tensor | None = None) -> NeighborList:
    """The list of ``spec.method``; the masks are :func:`build_cell`'s
    (the nsq builder takes ``excl`` only)."""
    if spec.method == "nsq":
        if not (valid is None and i_valid is None):
            raise ValueError("the nsq builder takes no row masks; use 'cell'")
        return build_nsq(x, box, spec, excl)
    if spec.method == "cell":
        return build_cell(x, box, spec, valid, i_valid, excl)
    raise ValueError(f"unknown neighbor method {spec.method!r}")


def displacement_check(nbr, x: torch.Tensor, box: Box,
                       skin: float) -> torch.Tensor:
    """True if any atom moved more than skin/2 since the structure ``nbr``
    (a NeighborList, a ColumnList or a ClusterList) was built — the LAMMPS
    'dangerous build' condition."""
    dr = box.min_image(x - nbr.x0)
    return torch.max(torch.sum(dr * dr, dim=-1)) > (0.5 * skin) ** 2
