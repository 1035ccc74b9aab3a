"""Cell-padded cluster pair lists, the input structure of K8
(ops/hopper_cluster.py) — port of the JAX package's round-1 cluster lists
(``attic/clusters.py``).

Layout: atoms are binned into cells of side >= cutoff+skin, padded to a
fixed per-cell capacity that is a multiple of CL ("slots").  Every cluster
of 8 consecutive slots belongs to exactly ONE cell, so for any atom pair
within the cutoff (whose cells are adjacent by construction) the partner's
cluster is found by the 27-cell stencil — this is what makes the stencil
provably sufficient.  (Clusters of 8 consecutive cell-sorted atoms would
straddle cells, and then their cells can differ by up to ±3: that dropped
~5% of pairs at 128k atoms in the JAX package.  Padded slots fix it.)

Within a cell, atoms are sub-sorted by quantized z so consecutive 8-slot
clusters are spatially compact: small bounding spheres are what give the
candidate prune its power.  A pair of clusters is kept iff
dist(centers) < cutoff+skin+r_i+r_j, which cannot drop any atom pair within
cutoff+skin.

Produced per reneighbor:
    atom_slot (N,)        atom -> slot row
    slot_atom (N_s,)      slot -> atom (N = padding sentinel)
    jcl (n_scl, KC)       per i-cluster candidate j-cluster ids, each row's
                          real entries first, then pads (n_scl)
    occupied (n_occ,)     the i-clusters that hold atoms, ascending (K8's
                          grid; its length is read on the host)

Every row is compacted, real entries first, which K8's walk relies on (it
stops at a row's first pad).  The attic compacts a row only when the
stencil holds more than KC clusters and otherwise masks it in place; the
entries are the same, in another order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box
from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod

CL = 8   # atoms per cluster


@dataclasses.dataclass(frozen=True)
class ClusterList:
    jcl: torch.Tensor            # (n_scl, KC) int32, padded with n_scl
    atom_slot: torch.Tensor      # (N,) int64
    slot_atom: torch.Tensor      # (N_s,) int64, padding = N
    x0: torch.Tensor             # positions at build time (displacement check)
    overflow: torch.Tensor       # () bool (cell capacity or KC exceeded)
    max_occupancy: torch.Tensor  # () int — most candidate j-clusters kept
    kc: int
    occupied: torch.Tensor       # (n_occ,) int32 i-clusters holding atoms

    @property
    def n_clusters(self) -> int:
        return self.jcl.shape[0]

    @property
    def n_slots(self) -> int:
        return self.slot_atom.shape[0]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    cutoff: float
    skin: float
    kc: int                  # max j-clusters per i-cluster (multiple of 16)
    cells_per_side: tuple
    cell_capacity: int       # atoms per cell (multiple of CL)
    chunk: int = 2048        # i-clusters per candidate block

    @property
    def rc(self) -> float:
        return self.cutoff + self.skin

    @property
    def clusters_per_cell(self) -> int:
        return self.cell_capacity // CL


def make_spec(n_atoms: int, box_lengths, cutoff: float, skin: float = 0.4,
              kc: int | None = None, cell_capacity: int | None = None,
              chunk: int = 2048) -> ClusterSpec:
    """Cell grid and capacities from the mean density: cell capacity mean
    + 6σ + 8 rounded up to CL, KC = 60% of the 27-cell stencil's clusters
    rounded up to 16 (the sphere prune's discount)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    rc = cutoff + skin
    cps = np.maximum(np.floor(L / rc).astype(int), 1)
    if np.any(cps < 3):
        raise ValueError("cluster list needs >= 3 cells per side")
    rho = n_atoms / float(np.prod(L))
    mean_occ = rho * float(np.prod(L / cps))
    if cell_capacity is None:
        cap = mean_occ + 6.0 * math.sqrt(max(mean_occ, 1.0)) + 8
        cell_capacity = int(-(-cap // CL) * CL)
    if cell_capacity % CL:
        raise ValueError(f"cell_capacity must be a multiple of {CL}")
    if kc is None:
        cpc = cell_capacity // CL
        kc = int(-(-27 * cpc * 0.6 // 16) * 16)
    if kc % 16:
        raise ValueError("kc must be a multiple of 16")
    return ClusterSpec(cutoff=cutoff, skin=skin, kc=kc,
                       cells_per_side=tuple(int(c) for c in cps),
                       cell_capacity=int(cell_capacity), chunk=chunk)


def sort_order(x: torch.Tensor, box: Box, spec: ClusterSpec) -> torch.Tensor:
    """Cell-major atom ordering (improves locality; not required for the
    slot mapping to be right)."""
    cid, _ = nbrmod.cell_index(x, box, np.asarray(spec.cells_per_side))
    return torch.sort(cid, stable=True).indices


def build(x: torch.Tensor, box: Box, spec: ClusterSpec) -> ClusterList:
    """Bin, z-sub-sort, lay out the padded cell slots and find each
    i-cluster's sphere-pruned candidate j-clusters.  ``x`` must be wrapped
    into the box."""
    n = x.shape[0]
    dev, dtype = x.device, x.dtype
    cps = np.asarray(spec.cells_per_side, dtype=np.int64)
    ncells = int(np.prod(cps))
    CC, CPC, KC = spec.cell_capacity, spec.clusters_per_cell, spec.kc
    n_scl = ncells * CPC
    n_slots = ncells * CC

    # ---- bin atoms into padded cell slots, z-sub-sorted within a cell ------
    cid, _ = nbrmod.cell_index(x, box, cps)
    zfrac = (x[:, 2] - box.lo[2]) / box.lengths[2] * int(cps[2])
    zsub = torch.clamp(((zfrac - torch.floor(zfrac)) * 64).to(torch.int64),
                       0, 63)
    order = torch.sort(cid * 64 + zsub, stable=True).indices
    sorted_cid = cid[order]
    count = torch.bincount(cid, minlength=ncells)
    rank = (torch.arange(n, device=dev)
            - (torch.cumsum(count, 0) - count)[sorted_cid])
    cell_overflow = rank.max() >= CC
    slot_sorted = sorted_cid * CC + torch.clamp(rank, 0, CC - 1)
    slot_atom = torch.full((n_slots,), n, dtype=torch.int64, device=dev)
    slot_atom[slot_sorted] = order
    atom_slot = torch.zeros(n, dtype=torch.int64, device=dev)
    atom_slot[order] = slot_sorted

    # ---- cluster geometry: centers and radii per slot cluster ---------------
    occupied = slot_atom < n
    xs = torch.where(occupied[:, None], x[torch.clamp(slot_atom, max=n - 1)],
                     torch.zeros((), dtype=dtype, device=dev))
    valid = occupied.reshape(n_scl, CL)
    xc = xs.reshape(n_scl, CL, 3)
    cnt = torch.clamp(valid.sum(dim=1), min=1)
    # atoms of one cell lie inside that cell (wrapped), so the plain masked
    # mean is periodic-safe
    center = (torch.sum(torch.where(valid[..., None], xc, 0.0), dim=1)
              / cnt[:, None].to(dtype))
    dist2 = torch.sum((xc - center[:, None, :]) ** 2, dim=-1)
    radius = torch.sqrt(torch.max(torch.where(valid, dist2, 0.0), dim=1).values)
    has_atoms = valid.any(dim=1)

    # ---- candidates: clusters of the 27-cell stencil, sphere-pruned -------
    scl = torch.arange(n_scl, device=dev)
    cell_of = scl // CPC
    c3 = torch.stack([cell_of // int(cps[1] * cps[2]),
                      (cell_of // int(cps[2])) % int(cps[1]),
                      cell_of % int(cps[2])], dim=1)
    sub = torch.arange(CPC, device=dev)
    jcl_blocks, count_blocks = [], []
    for r0 in range(0, n_scl, spec.chunk):
        r1 = min(n_scl, r0 + spec.chunk)
        ncell = nbrmod.stencil_cells(c3[r0:r1], cps)             # (rows, 27)
        cand = (ncell[:, :, None] * CPC + sub).reshape(r1 - r0, 27 * CPC)
        d = box.min_image(center[r0:r1, None, :] - center[cand])
        dist = torch.sqrt(torch.sum(d * d, dim=-1))
        reach = spec.rc + radius[r0:r1, None] + radius[cand]
        mask = (dist < reach) & has_atoms[cand] & has_atoms[r0:r1, None]
        if cand.shape[1] <= KC:
            # compact_first masks such rows in place; dead columns up to
            # KC + 1 make it compact them too
            extra = (0, KC + 1 - cand.shape[1])
            cand = torch.nn.functional.pad(cand, extra, value=n_scl)
            mask = torch.nn.functional.pad(mask, extra, value=False)
        jc, c = nbrmod.compact_first(cand, mask, KC, n_scl)
        jcl_blocks.append(jc)
        count_blocks.append(c)
    mx = torch.cat(count_blocks).max()
    return ClusterList(
        jcl=torch.cat(jcl_blocks).to(torch.int32), atom_slot=atom_slot,
        slot_atom=slot_atom, x0=x, overflow=cell_overflow | (mx > KC),
        max_occupancy=mx, kc=KC,
        occupied=torch.nonzero(has_atoms).flatten().to(torch.int32))


def as_neighbor_list(cl: ClusterList, n_atoms: int) -> nbrmod.NeighborList:
    """Expand into a padded atom neighbor list in atom order (validation,
    and the reference pair styles on a cluster list)."""
    n_scl = cl.n_clusters
    jcl = cl.jcl.long()
    base = torch.where(jcl < n_scl, jcl * CL, -1)                 # (n_scl, KC)
    rows = base[:, :, None] + torch.arange(CL, device=jcl.device)
    jat = torch.where(base[:, :, None] >= 0,
                      cl.slot_atom[torch.clamp(rows, 0, cl.n_slots - 1)],
                      n_atoms)
    idx_scl = jat.reshape(n_scl, cl.kc * CL)                      # per i-cluster
    idx = idx_scl[cl.atom_slot // CL]                             # (N, KC*CL)
    self_idx = torch.arange(n_atoms, device=idx.device)[:, None]
    idx = torch.where(idx == self_idx, n_atoms, idx)
    return nbrmod.NeighborList(
        idx=idx, x0=cl.x0, overflow=cl.overflow,
        max_occupancy=cl.max_occupancy * CL, capacity=cl.kc * CL)
