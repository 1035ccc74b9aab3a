"""Column-packed pair candidates for the hand-written pair kernel (port of
``lammps_ucg_dev_tpu/ops/colpack.py``).

* Atoms are binned into **x-y columns** of side >= cutoff+skin and sorted by
  z within each column, so consecutive slots are spatially adjacent.
* z-periodicity is handled by **ghost slots**: copies of each column's top
  (bottom) atoms are placed below (above) it with z shifted by -+Lz, so a
  z-range query never wraps.  x/y periodicity is an image shift per stencil
  column (the column grid has >= 3 columns per side).
* For each 8-slot i-cluster and each of the 9 stencil columns, all partners
  within cutoff+skin lie in ONE contiguous span ``[z0, z0+L)`` of that
  column's extended slots.  The kernel loops over those spans directly.

Extended slot space: column c owns rows [c*czp, (c+1)*czp) =
[gz ghost-bottom | count real | <= gzt ghost-top copies | pads].  The real
slot space (kernel i-side and outputs) is the (ncol*cz,) region at offsets
[gz, gz+cz) of each column.  The top copies sit at rows gz + count + rank,
so they may land inside the real region, on its pad slots.

Two ways to fill the kernels' inputs each step:

* :func:`pack` gathers every extended row from atom-ordered arrays (the
  blocks' full steps);
* :func:`pack_slots` takes the i-side rows already in real-slot order (the
  slot-major interior of ``Simulation``, whose per-atom state stays in
  that order for a block's interior steps, :func:`slot_atom_real`) and
  refreshes only the ghost rows, from the block-fixed index sets that
  :func:`build` derives: each bottom row's source rank and liveness, and
  each top copy's flat target.

The spatial drivers (``parallel/spatial.py``) build on a subdomain's
virtual box, whose x (slabs) or x and y (pencils) images come from the
halos, not from periodicity: ``ColumnSpec.periodic_x``/``periodic_y``
False make a neighbour column outside the grid empty (the stencil gives
-1, its spans are ``[0, 0)``, and the kernels skip it), ``build(valid=)``
drops the padding rows of a fixed-capacity block from every column, and
:func:`restrict_i` stops the ghost atoms' i-slots from tallying.

Left out from the JAX structure: the overlapped z-pages, the (G, S) page
geometry, the packed destination lane and NV sizing, and the window
metadata.  They exist only for the TPU's data movement.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box

CL = 8          # atoms per i-cluster (the span granularity)
NSTEN = 9       # 3x3 x-y column stencil
_PAD_POISON = 1.0e17   # pad-slot coordinate: far enough that dx² overflows
                       # any cutoff, small enough that dx² stays finite in f32


@dataclasses.dataclass(frozen=True)
class ColumnList:
    """Per-reneighbor candidate structure (fixed shapes)."""

    slot_atom_ext: torch.Tensor  # (ncol*czp,) int64 atom id; N = padding
    zshift: torch.Tensor         # (ncol*czp,) int8 in {-1, 0, +1} (units of Lz)
    atom_slot: torch.Tensor      # (N,) int64 -> real slot index
    i_valid: torch.Tensor        # (ncol*cz,) bool — real slot holds a real atom
    bsrc: torch.Tensor           # (ncol, gz) int64 — real-region rank each
                                 # bottom ghost row copies
    bok: torch.Tensor            # (ncol, gz) bool — that bottom row is live
    tidx: torch.Tensor           # (ncol, min(gzt, cz)) int64 — flat extended
                                 # row of the top copy of rank t (ncol*czp
                                 # when rank t has none)
    z0: torch.Tensor             # (ncol, cz/8, 9) int32 span start slot
    L: torch.Tensor              # (ncol, cz/8, 9) int32 span length
    x0: torch.Tensor             # (N, 3) build-time positions
    overflow: torch.Tensor       # () bool — column or ghost capacity exceeded
    max_occupancy: torch.Tensor  # () int — most candidates of one cluster
    mx: int
    my: int
    cz: int                      # real slots per column (multiple of 8)
    gz: int                      # bottom ghost-zone slots per column
    gzt: int                     # top ghost-copy capacity per column
    czp: int                     # total slots per column
    periodic_x: bool = True      # False: the x images come from halos
    periodic_y: bool = True
    i_tally: torch.Tensor | None = None  # (ncol*cz,) bool — the real slots
                                 # whose atoms tally (restrict_i); None:
                                 # every real atom

    @property
    def ncol(self) -> int:
        return self.mx * self.my

    @property
    def n_slots(self) -> int:
        return self.ncol * self.cz

    @property
    def periodic(self) -> tuple:
        return (self.periodic_x, self.periodic_y)

    @property
    def i_owner(self) -> torch.Tensor:
        """(ncol*cz,) bool: the i-slots that tally (the kernels' valid
        flag)."""
        return self.i_valid if self.i_tally is None else self.i_tally


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    cutoff: float
    skin: float
    mx: int
    my: int
    cz: int
    gz: int
    gzt: int
    czp: int
    periodic_x: bool = True    # False on a slab's or pencil's virtual box:
    periodic_y: bool = True    # halos provide those images

    @property
    def rc(self) -> float:
        return self.cutoff + self.skin

    @property
    def ncol(self) -> int:
        return self.mx * self.my


def _grid_dims(box_lengths, rc):
    L = np.asarray(box_lengths, np.float64)
    mx, my = (max(int(L[d] / rc), 1) for d in (0, 1))
    if mx < 3 or my < 3:
        raise ValueError(f"column grid needs >= 3 columns per side "
                         f"(got {mx}x{my}); box too small for the kernel path")
    if L[2] < 2.0 * rc:
        raise ValueError("Lz must be >= 2*(cutoff+skin) for ghost-based "
                         "z-periodicity")
    return L, mx, my


def stencil(mx: int, my: int, periodic_x: bool = True,
            periodic_y: bool = True):
    """(ncol, 9) stencil columns and (ncol, 9) x/y image shifts (units of
    Lx/Ly) in x-row-major order: s = (dx+1)*3 + (dy+1).  The shift moves a
    partner's position next to the center column across the periodic
    boundary; the kernel derives the same values by grid arithmetic.  On
    an axis that is not periodic a neighbour outside the grid is -1 (JAX
    ``colpack._stencil``), with shift 0."""
    cx, cy = np.divmod(np.arange(mx * my, dtype=np.int64), my)
    cols, sx, sy = [], [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx, ny = cx + dx, cy + dy
            col = (nx % mx) * my + ny % my
            bad = np.zeros_like(col, dtype=bool)
            if not periodic_x:
                bad |= (nx < 0) | (nx >= mx)
            if not periodic_y:
                bad |= (ny < 0) | (ny >= my)
            cols.append(np.where(bad, -1, col))
            sx.append(np.where(bad, 0, nx // mx))
            sy.append(np.where(bad, 0, ny // my))
    return (np.stack(cols, 1).astype(np.int64), np.stack(sx, 1),
            np.stack(sy, 1))


def measure_spec(x, box_lengths, cutoff: float, skin: float = 0.4,
                 periodic_x: bool = True,
                 periodic_y: bool = True) -> ColumnSpec:
    """Data-driven spec from one (N, 3) configuration already normalized to
    [0, L) per axis (host numpy), or from a list of them measured jointly
    (one spec sized for the worst: the spatial drivers' subdomains in
    their virtual-box frames): column capacity ``cz`` and ghost capacities
    ``gz``/``gzt`` with Poisson margins, as the JAX package sizes them.
    The runtime overflow flag is the backstop as atoms move."""
    configs = x if isinstance(x, (list, tuple)) else [x]
    rc = cutoff + skin
    L, mx, my = _grid_dims(box_lengths, rc)
    ncol = mx * my
    Lz = L[2]
    cmax, need_b, need_t, nmax = 0, 0, 0, 1
    for xc in configs:
        xn = np.asarray(xc, np.float64)
        ccx = np.clip((xn[:, 0] / L[0] * mx).astype(np.int64), 0, mx - 1)
        ccy = np.clip((xn[:, 1] / L[1] * my).astype(np.int64), 0, my - 1)
        col = ccx * my + ccy
        z = np.mod(xn[:, 2], Lz)
        cmax = max(cmax, int(np.bincount(col, minlength=ncol).max()))
        need_b = max(need_b, int(np.bincount(col[z > Lz - rc],
                                             minlength=ncol).max()))
        need_t = max(need_t, int(np.bincount(col[z < rc],
                                             minlength=ncol).max()))
        nmax = max(nmax, xn.shape[0])
    mean_col = max(nmax / ncol, 1.0)
    cap = cmax + 4.0 * math.sqrt(mean_col) + 8
    cz = int(-(-cap // CL) * CL)

    def margin(need):
        return int(-(-(need + 4.0 * math.sqrt(max(need, 1.0)) + 4) // CL) * CL)

    gz, gzt = margin(need_b), margin(need_t)
    # round the column stride to 32 slots (128-byte rows)
    czp = int(-(-(gz + cz + gzt) // 32) * 32)
    return ColumnSpec(cutoff=cutoff, skin=skin, mx=mx, my=my, cz=cz, gz=gz,
                      gzt=gzt, czp=czp, periodic_x=periodic_x,
                      periodic_y=periodic_y)


def build(x: torch.Tensor, box: Box, spec: ColumnSpec,
          valid: torch.Tensor | None = None) -> ColumnList:
    """Bin, z-sort, lay out the extended columns and find every cluster's
    nine candidate spans.  ``x`` must be wrapped into the box.  ``valid``
    (N,) bool: the rows to include (a spatial driver's fixed-capacity
    block, whose rows past the live ones are inert padding); the others
    are in no column, so never candidates, and their ``atom_slot`` is 0,
    whose outputs the caller discards."""
    if box.is_triclinic:
        raise ValueError("the column kernel path requires an orthogonal box")
    dev = x.device
    n = x.shape[0]
    mx, my, cz, gz, gzt, czp = (spec.mx, spec.my, spec.cz, spec.gz, spec.gzt,
                                spec.czp)
    ncol = mx * my
    rc = spec.rc
    L = box.lengths
    Lz = L[2]
    dtype = x.dtype
    i64 = torch.int64

    # ---- bin into columns, z-sort within ------------------------------------
    fx = (x[:, 0] - box.lo[0]) / L[0]
    fy = (x[:, 1] - box.lo[1]) / L[1]
    ccx = torch.clamp((fx * mx).to(i64), 0, mx - 1)
    ccy = torch.clamp((fy * my).to(i64), 0, my - 1)
    col = ccx * my + ccy
    if valid is not None:
        col = torch.where(valid, col, ncol)    # padding sorts past the end
    z = x[:, 2] - box.lo[2]
    # lexsort (z, col): stable sort by z, then stable sort by column
    oz = torch.sort(z, stable=True).indices
    order = oz[torch.sort(col[oz], stable=True).indices]
    sorted_col = col[order]
    count_all = torch.bincount(col, minlength=ncol + (valid is not None))
    count = count_all[:ncol]                                   # (ncol,)
    # rank within the column = sorted position - the column's first position
    first = torch.cumsum(count_all, 0) - count_all
    rank = torch.arange(n, device=dev) - first[sorted_col]
    inr = None if valid is None else sorted_col < ncol
    col_overflow = (rank if inr is None
                    else torch.where(inr, rank, 0)).max() >= cz
    rank_c = torch.clamp(rank, 0, cz - 1)
    rslot_sorted = sorted_col * cz + rank_c

    atom_slot = torch.empty(n, dtype=i64, device=dev)
    atom_slot[order] = (rslot_sorted if inr is None
                        else torch.where(inr, rslot_sorted, 0))
    z_sorted = z[order]
    # real-region z values; pads take z = Lz so every column row is ascending
    # (padding rows write to one row past the end, which is dropped)
    z_real = Lz.expand(ncol * cz + (inr is not None)).clone()
    z_real[rslot_sorted if inr is None
           else torch.where(inr, rslot_sorted, ncol * cz)] = z_sorted
    z_real = z_real[:ncol * cz].reshape(ncol, cz)

    # ---- extended column layout ---------------------------------------------
    # [gz ghost-bottom | count real | <= gzt ghost-top copies | pads]; each
    # sorted atom is scattered to its up-to-three extended rows; invalid
    # copies go to the dump row past the end and are dropped
    cnt_s = count_all[sorted_col]
    ebase = sorted_col * czp
    dump = ncol * czp
    t_real = ebase + gz + rank_c
    qb_at = rank - cnt_s + gz                       # bottom row of this atom
    t_bot = torch.where((qb_at >= 0) & (qb_at < gz), ebase + qb_at, dump)
    qt_at = gz + cnt_s + rank                       # top-copy row
    t_top = torch.where((rank < gzt) & (qt_at < czp), ebase + qt_at, dump)
    if inr is not None:
        t_real = torch.where(inr, t_real, dump)
        t_bot = torch.where(inr, t_bot, dump)
        t_top = torch.where(inr, t_top, dump)

    sa = torch.full((dump + 1,), n, dtype=i64, device=dev)
    sa[t_real] = order
    sa[t_bot] = order
    sa[t_top] = order
    # pads: bottom-zone pads sit below every query (-Lz), all others above
    q = torch.arange(czp, device=dev)
    zext = torch.where(q < gz, -Lz, 3 * Lz).expand(ncol, czp).reshape(-1)
    zext = torch.cat([zext, zext[:1]])
    zext[t_real] = z_sorted
    zext[t_bot] = z_sorted - Lz
    zext[t_top] = z_sorted + Lz
    shift = torch.zeros(dump + 1, dtype=torch.int8, device=dev)
    shift[t_bot] = -1
    shift[t_top] = 1
    slot_atom_ext, zext, zshift = sa[:dump], zext[:dump], shift[:dump]
    zext = zext.reshape(ncol, czp)
    # ghost-top copies inside the real region are not i-atoms
    i_valid = (torch.arange(cz, device=dev)[None, :]
               < count[:, None]).reshape(-1)

    # the ghost rows' block-fixed index sets (pack_slots): bottom row q of
    # a column copies rank q + count - gz; the top copy of rank t sits at
    # row gz + count + t
    qb = torch.arange(gz, device=dev)[None, :]
    bs = count[:, None] - gz + qb
    bok = bs >= 0
    bsrc = torch.clamp(bs, 0, cz - 1)
    tt = torch.arange(min(gzt, cz), device=dev)[None, :]
    trow = gz + count[:, None] + tt
    tok = (tt < count[:, None]) & (trow < czp)
    tidx = torch.where(tok, torch.arange(ncol, device=dev)[:, None] * czp
                       + trow, dump)

    # ghost capacity: every atom within rc of a z face must have a copy
    need_top = count - torch.sum(z_real < (Lz - rc), dim=1)
    need_bot = torch.sum(z_real < rc, dim=1)
    ghost_overflow = ((need_top.max() > gz)
                      | ((count + need_bot).max() > (czp - gz))
                      | (need_bot.max() > gzt))

    # ---- per-(cluster, stencil column) candidate spans ----------------------
    # cluster b of a column covers real slots [8b, 8b+8); its partners lie
    # in z ∈ [z_first - rc, z_last + rc] of each stencil column.  z0 counts
    # extended rows with z < lo (searchsorted left), z1 those with z <= hi
    # (searchsorted right) — the JAX package's compare-and-count bounds
    cpc = cz // CL
    ci = torch.arange(cpc, device=dev)[None, :]
    cnt = count[:, None]
    has = cnt > ci * CL
    lo_i = torch.minimum(ci * CL, torch.clamp(cnt - 1, min=0))
    hi_i = torch.minimum(torch.maximum(cnt - 1, ci * CL), ci * CL + CL - 1)
    far = 4 * Lz                                   # past every extended row
    zlo = torch.where(has, torch.gather(z_real, 1, lo_i) - rc, far)
    zhi = torch.where(has, torch.gather(z_real, 1, hi_i) + rc, far)
    sten_np = stencil(mx, my, spec.periodic_x, spec.periodic_y)[0]
    sten = torch.as_tensor(np.maximum(sten_np, 0), device=dev)  # (ncol, 9)
    zs = zext[sten]                                            # (ncol, 9, czp)
    qlo = zlo[:, None, :].expand(ncol, NSTEN, cpc).contiguous()
    qhi = zhi[:, None, :].expand(ncol, NSTEN, cpc).contiguous()
    z0 = torch.searchsorted(zs, qlo, right=False)
    z1 = torch.searchsorted(zs, qhi, right=True)
    span = torch.clamp(z1 - z0, min=0)
    if np.any(sten_np < 0):
        # a neighbour outside a non-periodic grid: the empty span [0, 0)
        ok = torch.as_tensor(sten_np >= 0, device=dev)[:, :, None]
        z0 = torch.where(ok, z0, 0)
        span = torch.where(ok, span, 0)
    z0 = z0.transpose(1, 2).contiguous().to(torch.int32)   # (ncol, cpc, 9)
    span = span.transpose(1, 2).contiguous().to(torch.int32)

    return ColumnList(
        slot_atom_ext=slot_atom_ext, zshift=zshift, atom_slot=atom_slot,
        i_valid=i_valid, bsrc=bsrc, bok=bok, tidx=tidx, z0=z0, L=span,
        x0=x,
        overflow=col_overflow | ghost_overflow,
        max_occupancy=span.sum(dim=2).max(),
        mx=mx, my=my, cz=cz, gz=gz, gzt=gzt, czp=czp,
        periodic_x=spec.periodic_x, periodic_y=spec.periodic_y)


def restrict_i(cl: ColumnList, i_mask: torch.Tensor) -> ColumnList:
    """Only the atoms with ``i_mask`` (N,) True tally (JAX
    ``colpack.restrict_i``): the spatial drivers' ghost atoms stay
    candidates but their i-slots write zero rows and add nothing to pe
    and the virial.  ``i_valid`` still marks every real atom, so the
    slot-major interior carries the ghosts too."""
    ids = cl.slot_atom_ext.reshape(cl.ncol, cl.czp)[
        :, cl.gz:cl.gz + cl.cz].reshape(-1)                    # (n_slots,)
    m = torch.cat([i_mask, i_mask.new_zeros(1)])[ids]          # id N: False
    return dataclasses.replace(cl, i_tally=cl.i_valid & m)


def _pad_row(dtype, device) -> torch.Tensor:
    """(8,) attributes of a pad slot: positions poisoned far outside the box
    so pad slots fail the rsq < cutsq test geometrically, valid flag 0."""
    row = torch.zeros(8, dtype=dtype, device=device)
    row[:3] = _PAD_POISON
    return row


def pack(cl: ColumnList, box: Box, x: torch.Tensor, lam: torch.Tensor,
         ucgstate: torch.Tensor, dtype=torch.float32,
         aux: torch.Tensor | None = None,
         typ: torch.Tensor | None = None, slot: bool = False):
    """Per-step attribute packing (positions/λ/state change every step; the
    slot mapping persists for the reneighbor block).

    Returns (ipack, cols):
      ipack (ncol*cz, 8) real slots, rows = [x y z λ state valid aux typ]
            (valid is 0 for pads, for ghost-top copies in the region and
            for the slots :func:`restrict_i` leaves out;
            aux and typ are 0 when not given — the Bethe kernel carries its
            i-role prior in aux)
      cols  (ncol, 8, czp) the extended slots, attribute-major

    ``slot=True``: the per-atom arrays are already in real-slot order
    (n_slots rows, the slot-major interior); ipack is their concatenation
    with valid = ``cl.i_valid`` and cols comes from :func:`pack_slots`, so
    no atom→slot gather runs.  cols and ipack's valid rows are then the
    same bits as the atom-ordered packing of the same atoms gives.
    """
    n = x.shape[0]
    dev = x.device
    ones = torch.ones((n, 1), dtype=dtype, device=dev)
    attrs = torch.cat([
        x.to(dtype), lam.to(dtype)[:, None], ucgstate.to(dtype)[:, None],
        cl.i_valid.to(dtype)[:, None] if slot else ones,
        (torch.zeros_like(ones) if aux is None else aux.to(dtype)[:, None]),
        (torch.zeros_like(ones) if typ is None else typ.to(dtype)[:, None]),
    ], dim=1)
    if slot:
        cols = pack_slots(cl, box, attrs)
        if cl.i_tally is not None:
            attrs[:, 5] = cl.i_tally.to(dtype)
        return attrs, cols
    attrs = torch.cat([attrs, _pad_row(dtype, dev)[None]])
    ext = attrs[cl.slot_atom_ext]                               # (ncol*czp, 8)
    ext[:, 2] += cl.zshift.to(dtype) * box.lengths[2].to(dtype)
    ext3 = ext.reshape(cl.ncol, cl.czp, 8)
    ipack = ext3[:, cl.gz:cl.gz + cl.cz, :].reshape(cl.n_slots, 8).clone()
    ipack[:, 5] *= cl.i_owner.to(dtype)
    return ipack, ext3.transpose(1, 2).contiguous()


def pack_slots(cl: ColumnList, box: Box, attrs_real: torch.Tensor):
    """The (ncol, 8, czp) cols of :func:`pack` from the (n_slots, 8) i-side
    rows already in real-slot order, [x y z λ state valid aux typ]; rows
    whose slot holds no real atom (``cl.i_valid`` 0) are ignored.  The
    real rows are written in place, the bottom ghost rows from their
    sources with z − Lz, the pad tail, and then the top copies with z + Lz
    are scattered to their rows, after the real rows because a copy may
    land on a pad slot of the real region."""
    ncol, cz, gz, czp = cl.ncol, cl.cz, cl.gz, cl.czp
    dtype, dev = attrs_real.dtype, attrs_real.device
    Lz = box.lengths[2].to(dtype)
    pad = _pad_row(dtype, dev)
    ext = torch.empty((ncol * czp + 1, 8), dtype=dtype, device=dev)
    ext3 = ext[:-1].view(ncol, czp, 8)         # the last row: tidx's dump
    real3 = ext3[:, gz:gz + cz]
    torch.where(cl.i_valid.view(ncol, cz, 1), attrs_real.view(ncol, cz, 8),
                pad, out=real3)
    bot = torch.gather(real3, 1, cl.bsrc[:, :, None].expand(ncol, gz, 8))
    bot[:, :, 2] -= Lz
    torch.where(cl.bok[:, :, None], bot, pad, out=ext3[:, :gz])
    ext3[:, gz + cz:] = pad
    top = real3[:, :cl.tidx.shape[1]].clone()
    top[:, :, 2] += Lz
    ext[cl.tidx.reshape(-1)] = top.reshape(-1, 8)
    return ext3.transpose(1, 2).contiguous()


def slot_atom_real(cl: ColumnList, n_atoms: int) -> torch.Tensor:
    """(n_slots,) atom id of each real-region slot: real atoms map to
    themselves, pads and ghost-top copies to the sentinel ``n_atoms`` (a
    copy's row is refreshed by :func:`pack_slots`, never integrated)."""
    ids = cl.slot_atom_ext.reshape(cl.ncol, cl.czp)[:, cl.gz:cl.gz + cl.cz]
    return torch.where(cl.i_valid, ids.reshape(-1), n_atoms)
