"""Spatial slab and pencil decomposition with explicit halo exchange (port
of ``lammps_ucg_dev_tpu/parallel/spatial.py``), over ``torch.distributed``
(``parallel/comm.py``).

The reference's MPI domain decomposition, matched, not translated:

* each rank owns the atoms of a spatial subdomain plus a layer of *ghost*
  images of its neighbours' atoms within cutoff + skin
  (``atom_vec_ucg.cpp:66-73``: border fields ucgstate, ucgl, ucgp);
* a forward (halo) exchange refreshes the ghosts' positions and UCG state
  every step; the density styles also exchange ρ and their CV weights
  (``pair_table_rleucg_interface.cpp:277-278``);
* migration moves atoms that left their subdomain, at every rebuild;
* no reverse exchange: every tally is owned by its i-atom (full list,
  newton off), as on one device.

The box is cut into ``Dx`` x-slabs, or ``Dx × Dy`` x-y pencils (the LAMMPS
processor brick without z: halo, refresh and migration stage x, then y,
and the y buffers come from owned and x-ghost rows so the corners ride the
y stage).  One rank per subdomain; each holds fixed-capacity rows

    [0, cap_local)            owned atoms ([0, nloc) live)
    [cap_local, +cap_halo)    ghosts from the lower x neighbour
    [.., +cap_halo)           ghosts from the upper x neighbour
    [.., +2 cap_halo_y)       lower/upper y ghosts (pencils)

packed as 24 float columns (``_MIG_F``).  Ghost x is stored shifted by
±Lx across the periodic seam, so the pair box is not periodic in x (nor
in y for pencils): on the kernel path the column list is built on the
subdomain's virtual box with ``ColumnSpec.periodic_x``/``periodic_y``
False and the ghosts' i-slots leave the tallies (``colpack.restrict_i``);
on the reference path the cell list takes ``valid``/``i_valid`` masks.

Every rank builds the same global state, keeps its subdomain, and seeds
its generator the same way: the tag-keyed draws (``Simulation._uniforms``
draws ``(N, ...)`` and indexes by tag) then give every atom the noise the
single-device run gives it, so a Langevin run matches it.

A block is a rebuild (wrap, migrate, park the non-owned rows, establish
the halos, build) and ``reneigh_every`` Verlet steps with a halo refresh
before every force pass; interior steps run the pair style's fast variant,
slot-major on the column path in float32 for the styles without a halo
hook (K1, K2) and without topology, and the block's last step the full
one.  The overflow and danger flags, the migration count, pe, the virial
and the out-of-table counts are summed over the ranks once per block, in
one ``all_reduce``.

Topology (``bonded``, ``excl_tags``) is replicated: every rank holds the
tag tables, and once per block, after the halos, maps each special list
and each term member through its own tag→row map (bonds are shorter than
the halo, so a term with an owned member has every member here; one that
does not raises the overflow flag).  Only owned rows keep their special
lists: the reference path leaves them out of its cell list, the kernel
path subtracts the style's ``excl_delta`` (the density styles theirs
pass by pass, ρ corrected on the owned rows before the exchange that
sends it to the ghosts).  The bonded terms take each owned member's share
(``bonded.compute_spatial``).  Under r-RESPA the ghosts' positions are
refreshed before every inner bonded evaluation (ghost rows carry no
velocities), fully before the outer pair pass, and the bonded pe and
virial join the block's sums, as thermo adds them on one device.

``fix cluster_switch`` (``cluster_switch=(params, freq)``): the event
rides the first block whose start step is a positive multiple of
``freq`` (``run``; ``run_fused(do_cswitch=True)`` its first block), after
the rebuild: the contact list of the owned rows (the pair list on the
reference path; on the kernel path a cell list at the contact cutoff over
the virtual box), ``fix cluster_switch``'s distributed labelling with the
labels min-merged over the ranks each sweep, the flips drawn from the
replicated generator, and a full force pass at the new types.  Rank 0
writes the logs.

Requirements: at least 3 cuts per decomposed axis, subdomain widths of at
least cutoff + skin, a contact cutoff within cutoff + skin; orthogonal
boxes (``parallel/domain.py`` takes the rest), no ``extra_post_force``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box, ForceOut, SimState
from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as fcs
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.models import bonded as bd
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod
from lammps_ucg_dev_tpu_torch.parallel.comm import Ring
from lammps_ucg_dev_tpu_torch.runtime.sim import CS_CHUNK, Simulation

# packed per-atom columns (24)
_MIG_F = ("x0", "x1", "x2", "v0", "v1", "v2", "i0", "i1", "i2", "tag", "typ",
          "mol", "q", "ucgstate", "ucgl", "ucgvl", "ucgml", "ucgp",
          "f0", "f1", "f2", "ucgforce", "s0", "s1")
_NMIG = len(_MIG_F)
_TERMS = ("bond", "angle", "dihedral", "improper")


def _r8(v: float) -> int:
    return int(-(-v // 8) * 8)


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Decomposition geometry and the local pair structure: ``n_devices``
    x-slabs, or with ``n_dev_y`` > 1 x-y pencils."""

    n_devices: int               # cuts along x
    cap_local: int
    cap_halo: int                # per x face
    cap_mig: int                 # per x direction
    nbr: object                  # NeighborSpec or colpack.ColumnSpec
    n_dev_y: int = 1             # cuts along y (1: slabs)
    cap_halo_y: int = 0          # per y face (sources include x-ghosts)
    cap_mig_y: int = 0

    @property
    def cap_tot(self) -> int:
        return self.cap_local + 2 * self.cap_halo + 2 * self.cap_halo_y

    @property
    def rc(self) -> float:
        return self.nbr.rc

    @property
    def is_2d(self) -> bool:
        return self.n_dev_y > 1

    @property
    def dims(self) -> tuple[int, int]:
        return (self.n_devices, self.n_dev_y)

    @property
    def n_dev_total(self) -> int:
        return self.n_devices * self.n_dev_y


def make_slab_spec(n_atoms: int, box_lengths, cutoff: float, skin: float,
                   n_devices: int, cap_local: int | None = None,
                   cap_halo: int | None = None, cap_mig: int | None = None,
                   nbr_method: str | None = None, x=None,
                   nbr_capacity: int | None = None) -> SlabSpec:
    """Slab, halo and migration capacities from the mean density, or, with
    the setup positions ``x`` (host numpy, relative to the box's lower
    corner), from the measured occupancies with drift margins, as the JAX
    package sizes them; the overflow flags are the backstop.  The local
    list is a cell list unless ``nbr_method`` says otherwise (the port's
    nsq builder takes no row masks)."""
    L = np.asarray(box_lengths, np.float64)
    D = int(n_devices)
    rc = cutoff + skin
    if D < 3:
        raise ValueError(f"spatial decomposition needs >= 3 slabs (got {D}); "
                         "use parallel.domain atom decomposition instead")
    slab_w = L[0] / D
    if slab_w < rc:
        raise ValueError(
            f"slab width {slab_w:.3f} < cutoff+skin {rc:.3f}: ±1-neighbor "
            f"halos are insufficient; use fewer devices or a bigger box")
    mean = n_atoms / D
    sig = math.sqrt(max(mean, 1.0))
    if x is not None:
        xn = np.mod(np.asarray(x, np.float64)[:, 0], L[0])
        s = np.clip((xn / L[0] * D).astype(np.int64), 0, D - 1)
        counts = np.bincount(s, minlength=D)
        if cap_local is None:
            cap_local = _r8(counts.max() + 2.0 * sig + 16)
        if cap_halo is None:
            off = xn - s * slab_w            # position within own slab
            near = max(np.bincount(s[off < rc], minlength=D).max(),
                       np.bincount(s[off >= slab_w - rc], minlength=D).max())
            cap_halo = _r8(near + 2.0 * math.sqrt(max(near, 1.0)) + 16)
    if cap_local is None:
        cap_local = _r8(mean + 6.0 * sig + 16)
    if cap_halo is None:
        mean_h = mean * rc / slab_w
        cap_halo = _r8(mean_h + 6.0 * math.sqrt(max(mean_h, 1.0)) + 16)
    if cap_mig is None:
        # atoms within skin of a face may cross between reneighbors
        mean_m = mean * max(skin, 0.1 * rc) / slab_w
        cap_mig = _r8(mean_m + 6.0 * math.sqrt(max(mean_m, 1.0)) + 16)
    cap_tot = cap_local + 2 * cap_halo
    virt_L = [slab_w + 2 * rc, L[1], L[2]]
    nbr = nbrmod.make_spec(cap_tot, virt_L, cutoff, skin,
                           method=nbr_method or "cell", capacity=nbr_capacity)
    return SlabSpec(n_devices=D, cap_local=int(cap_local),
                    cap_halo=int(cap_halo), cap_mig=int(cap_mig), nbr=nbr)


def make_column_slab_spec(n_atoms: int, box_lengths, cutoff: float,
                          skin: float, n_devices: int, x,
                          **caps) -> SlabSpec:
    """:func:`make_slab_spec` whose local pair structure is the column
    list of the kernels, on the slab's virtual box (not periodic in x):
    one spec serves every rank, sized from the union of every slab's
    local and halo population in its virtual frame.  ``x`` is required."""
    base = make_slab_spec(n_atoms, box_lengths, cutoff, skin, n_devices,
                          x=x, **caps)
    L = np.asarray(box_lengths, np.float64)
    D = int(n_devices)
    rc = cutoff + skin
    eps = 1e-3 * rc                  # as SpatialSimulation._virtual_boxes
    w = L[0] / D
    Lxv = w + 2 * rc + 2 * eps
    xn = np.asarray(x, np.float64)
    configs = []
    for d in range(D):
        xg = np.mod(xn[:, 0] - (d * w - rc - eps), L[0])
        sel = xg < Lxv
        configs.append(np.stack(
            [xg[sel], np.mod(xn[sel, 1], L[1]), np.mod(xn[sel, 2], L[2])],
            axis=1))
    col = colpack.measure_spec(configs, [Lxv, L[1], L[2]], cutoff, skin,
                               periodic_x=False)
    return dataclasses.replace(base, nbr=col)


def make_pencil_spec(n_atoms: int, box_lengths, cutoff: float, skin: float,
                     n_dev_x: int, n_dev_y: int, x=None,
                     cap_local: int | None = None,
                     cap_halo: int | None = None,
                     cap_halo_y: int | None = None,
                     cap_mig: int | None = None,
                     cap_mig_y: int | None = None,
                     nbr_method: str | None = None,
                     nbr_capacity: int | None = None) -> SlabSpec:
    """2-D pencils, ``n_dev_x × n_dev_y`` cuts in x and y: capacities
    measured from ``x`` when given (with drift margins), else from the
    mean density, as the JAX package sizes them."""
    L = np.asarray(box_lengths, np.float64)
    Dx, Dy = int(n_dev_x), int(n_dev_y)
    rc = cutoff + skin
    if Dx < 3 or Dy < 3:
        raise ValueError(f"pencil decomposition needs >= 3 cuts per axis "
                         f"(got {Dx}x{Dy}); use slabs or parallel.domain")
    wx, wy = L[0] / Dx, L[1] / Dy
    if wx < rc or wy < rc:
        raise ValueError(
            f"pencil widths ({wx:.3f}, {wy:.3f}) < cutoff+skin {rc:.3f}: "
            f"±1-neighbor halos are insufficient; use fewer devices")
    ntot = Dx * Dy
    mean = n_atoms / ntot
    sig = math.sqrt(max(mean, 1.0))
    if x is not None:
        xn = np.asarray(x, np.float64)
        px = np.mod(xn[:, 0], L[0])
        py = np.mod(xn[:, 1], L[1])
        sx = np.clip((px / L[0] * Dx).astype(np.int64), 0, Dx - 1)
        sy = np.clip((py / L[1] * Dy).astype(np.int64), 0, Dy - 1)
        d = sx * Dy + sy
        counts = np.bincount(d, minlength=ntot)
        if cap_local is None:
            cap_local = _r8(counts.max() + 2.0 * sig + 16)
        if cap_halo is None:
            offx = px - sx * wx
            near = max(np.bincount(d[offx < rc], minlength=ntot).max(),
                       np.bincount(d[offx >= wx - rc], minlength=ntot).max())
            cap_halo = _r8(near + 2.0 * math.sqrt(max(near, 1.0)) + 16)
        if cap_halo_y is None:
            # per receiving pencil (i, j): senders are (i, j∓1); sources are
            # their owned + x-ghost rows, i.e. atoms with x in column i's
            # rc-extended range and y within rc of the shared face
            need = 0
            for i in range(Dx):
                xg = np.mod(px - (i * wx - rc), L[0])
                in_strip = xg < wx + 2 * rc
                ys = py[in_strip]
                offy = ys - np.floor(ys / wy) * wy
                cnt = np.bincount(
                    np.clip((ys / wy).astype(np.int64), 0, Dy - 1)[offy < rc],
                    minlength=Dy)
                cnt2 = np.bincount(
                    np.clip((ys / wy).astype(np.int64), 0,
                            Dy - 1)[offy >= wy - rc], minlength=Dy)
                need = max(need, int(cnt.max()), int(cnt2.max()))
            cap_halo_y = _r8(need + 2.0 * math.sqrt(max(need, 1.0)) + 16)
    if cap_local is None:
        cap_local = _r8(mean + 6.0 * sig + 16)
    if cap_halo is None:
        mean_h = mean * rc / wx
        cap_halo = _r8(mean_h + 6.0 * math.sqrt(max(mean_h, 1.0)) + 16)
    if cap_halo_y is None:
        mean_hy = mean * (wx + 2 * rc) / wx * rc / wy
        cap_halo_y = _r8(mean_hy + 6.0 * math.sqrt(max(mean_hy, 1.0)) + 16)
    if cap_mig is None:
        mean_m = mean * max(skin, 0.1 * rc) / wx
        cap_mig = _r8(mean_m + 6.0 * math.sqrt(max(mean_m, 1.0)) + 16)
    if cap_mig_y is None:
        mean_m = mean * max(skin, 0.1 * rc) / wy
        cap_mig_y = _r8(mean_m + 6.0 * math.sqrt(max(mean_m, 1.0)) + 16)
    cap_tot = (int(cap_local) + 2 * int(cap_halo) + 2 * int(cap_halo_y))
    virt_L = [wx + 2 * rc, wy + 2 * rc, L[2]]
    nbr = nbrmod.make_spec(cap_tot, virt_L, cutoff, skin,
                           method=nbr_method or "cell", capacity=nbr_capacity)
    return SlabSpec(n_devices=Dx, cap_local=int(cap_local),
                    cap_halo=int(cap_halo), cap_mig=int(cap_mig), nbr=nbr,
                    n_dev_y=Dy, cap_halo_y=int(cap_halo_y),
                    cap_mig_y=int(cap_mig_y))


def make_column_pencil_spec(n_atoms: int, box_lengths, cutoff: float,
                            skin: float, n_dev_x: int, n_dev_y: int, x,
                            **caps) -> SlabSpec:
    """:func:`make_pencil_spec` with the kernels' column list on the
    pencil's virtual box (periodic in neither x nor y), sized from the
    union of every pencil's local and halo population."""
    base = make_pencil_spec(n_atoms, box_lengths, cutoff, skin, n_dev_x,
                            n_dev_y, x=x, **caps)
    L = np.asarray(box_lengths, np.float64)
    Dx, Dy = int(n_dev_x), int(n_dev_y)
    rc = cutoff + skin
    eps = 1e-3 * rc                  # as SpatialSimulation._virtual_boxes
    wx, wy = L[0] / Dx, L[1] / Dy
    Lxv = wx + 2 * rc + 2 * eps
    Lyv = wy + 2 * rc + 2 * eps
    xn = np.asarray(x, np.float64)
    configs = []
    for i in range(Dx):
        xg = np.mod(xn[:, 0] - (i * wx - rc - eps), L[0])
        for j in range(Dy):
            yg = np.mod(xn[:, 1] - (j * wy - rc - eps), L[1])
            sel = (xg < Lxv) & (yg < Lyv)
            configs.append(np.stack(
                [xg[sel], yg[sel], np.mod(xn[sel, 2], L[2])], axis=1))
    col = colpack.measure_spec(configs, [Lxv, Lyv, L[2]], cutoff, skin,
                               periodic_x=False, periodic_y=False)
    return dataclasses.replace(base, nbr=col)


def make_spec(n_atoms: int, box_lengths, spec, dims, x, **caps) -> SlabSpec:
    """The decomposition ``dims = (Dx, Dy)`` (slabs when ``Dy`` is 1, else
    pencils) for the pair path of the single-device list ``spec``: the
    column specs for a ``ColumnSpec``, the reference path's cell-list
    specs for a ``NeighborSpec``; capacities measured from the wrapped
    positions ``x``."""
    dx, dy = int(dims[0]), int(dims[1])
    column = isinstance(spec, colpack.ColumnSpec)
    if not column and not isinstance(spec, nbrmod.NeighborSpec):
        raise NotImplementedError(f"{type(spec).__name__} lists are not "
                                  "decomposed (column or reference lists)")
    if dy == 1:
        mk = make_column_slab_spec if column else make_slab_spec
        return mk(n_atoms, box_lengths, spec.cutoff, spec.skin, dx, x=x,
                  **caps)
    mk = make_column_pencil_spec if column else make_pencil_spec
    return mk(n_atoms, box_lengths, spec.cutoff, spec.skin, dx, dy, x=x,
              **caps)


def spec_for(sim: Simulation, dims, **caps) -> SlabSpec:
    """:func:`make_spec` for ``sim``'s system on its own pair path."""
    state = sim.state
    L = state.box.lengths.double().cpu().numpy()
    x = (state.box.wrap(state.x) - state.box.lo).double().cpu().numpy()
    return make_spec(state.n_atoms, L, sim.nbr_spec, dims, x, **caps)


# ---- packing helpers ---------------------------------------------------------

def _pack_mig(state: SimState, fout: ForceOut) -> torch.Tensor:
    cols = [state.x, state.v, state.image, state.tag[:, None],
            state.typ[:, None], state.mol[:, None], state.q[:, None],
            state.ucgstate[:, None], state.ucgl[:, None],
            state.ucgvl[:, None], state.ucgml[:, None], state.ucgp[:, None],
            fout.f, fout.ucgforce[:, None], fout.scores]
    dt = state.x.dtype
    return torch.cat([c.to(dt) for c in cols], dim=1)


def _unpack_mig(F: torch.Tensor, proto: SimState, fout: ForceOut):
    i32 = torch.int32

    def ints(a, b=None):
        col = F[:, a] if b is None else F[:, a:b]
        return torch.round(col).to(i32)

    state = dataclasses.replace(
        proto, x=F[:, 0:3].contiguous(), v=F[:, 3:6].contiguous(),
        image=ints(6, 9), tag=ints(9), typ=ints(10), mol=ints(11),
        q=F[:, 12].contiguous(), ucgstate=ints(13),
        ucgl=F[:, 14].contiguous(), ucgvl=F[:, 15].contiguous(),
        ucgml=F[:, 16].contiguous(), ucgp=F[:, 17].contiguous())
    fout = dataclasses.replace(
        fout, f=F[:, 18:21].contiguous(), ucgforce=F[:, 21].contiguous(),
        scores=F[:, 22:24].contiguous())
    return state, fout


def _take_first(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` True rows (original order), then the
    others."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices[:cap]


def _with_count(buf: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``buf`` with one more row that carries the live count ``n``."""
    tail = buf.new_zeros((1, buf.shape[1]))
    tail[0, 0] = n.to(buf.dtype)
    return torch.cat([buf, tail])


def _count_of(buf: torch.Tensor):
    return buf[:-1], torch.round(buf[-1, 0]).long()


class SpatialSimulation(Simulation):
    """The slab/pencil-decomposed driver on the single-device
    ``Simulation``'s physics (the same pair entries and kernels, the same
    fix order through ``_forces``, the same thermo), one rank per
    subdomain over ``ring`` (``parallel.comm.Ring``, whose grid is
    ``slab.dims``).  Every rank passes the same global ``state``.

    ``state`` after :meth:`run` and :meth:`gather` is the whole system in
    tag order, on every rank; :meth:`thermo` reduces on the devices.
    ``bonded``, ``excl_tags``, ``cluster_switch``, ``log_dir`` and
    ``cfg.respa_inner`` as ``Simulation`` takes them (module docstring)."""

    def __init__(self, system, state: SimState, pair_compute, pair_params,
                 slab: SlabSpec, cfg, ring: Ring, seed: int = 0,
                 generator: torch.Generator | None = None,
                 mc_generator: torch.Generator | None = None,
                 cluster_switch=None, bonded=None, excl_tags=None,
                 extra_post_force=None, log_dir: str | None = None):
        if extra_post_force is not None:
            raise ValueError("extra_post_force reads the whole system; run "
                             "it on one device or parallel.domain")
        if state.box.is_triclinic:
            raise ValueError("a tilted box does not decompose into slabs "
                             "or pencils: use parallel.domain")
        if cfg.respa_inner != 1 and bonded is None:
            raise ValueError("respa_inner > 1 requires bonded terms (the "
                             "fast level)")
        if cluster_switch is not None:
            cut_cs = float(np.sqrt(float(cluster_switch[0].cutsq)))
            if cut_cs > slab.rc:
                raise ValueError(
                    f"cluster_switch contact cutoff {cut_cs:.3f} exceeds "
                    f"the halo width (cutoff + skin = {slab.rc:.3f}): "
                    "contacts across a face would be invisible")
        if tuple(ring.dims) != slab.dims:
            raise ValueError(f"the ring's grid {ring.dims} is not the "
                             f"decomposition's {slab.dims}")
        if cfg.sort_atoms:
            cfg = dataclasses.replace(cfg, sort_atoms=False)
        super().__init__(system, state, pair_compute, pair_params, slab.nbr,
                         cfg, seed=seed, generator=generator,
                         mc_generator=mc_generator,
                         cluster_switch=cluster_switch,
                         log_dir=log_dir if ring.rank == 0 else None,
                         bonded=bonded, excl_tags=excl_tags)
        self.slab = slab
        self.ring = ring
        self.n_global = state.n_atoms
        self._column = isinstance(slab.nbr, colpack.ColumnSpec)
        # the rows permute under migration: the special rows are mapped
        # per block (_topology), never from the global state
        self._excl_rows_static = None
        if cluster_switch is not None and self._column:
            # the event's contact list over the virtual box (one device's
            # _cs_spec is sized for the global box)
            L = state.box.lengths.double().cpu().numpy()
            virt = [L[0] / slab.n_devices + 2 * slab.rc, L[1], L[2]]
            if slab.is_2d:
                virt[1] = L[1] / slab.n_dev_y + 2 * slab.rc
            self._cs_spec = nbrmod.make_spec(
                slab.cap_tot, virt, float(np.sqrt(float(
                    cluster_switch[0].cutsq))), 0.0, method="cell",
                chunk=CS_CHUNK)
        self.migrations = 0
        self.cswitch_sweeps: list[int] = []
        self._dist(state)

    # ---- distribution and gathering ---------------------------------------

    def _subdomain(self):
        """(x_lo, x_hi, y_lo, y_hi) of this rank's subdomain (float64)."""
        lo, L = self._lo, self._L
        sl = self.slab
        i, j = self.ring.me
        wx, wy = L[0] / sl.n_devices, L[1] / sl.n_dev_y
        return (lo[0] + i * wx, lo[0] + (i + 1) * wx,
                lo[1] + j * wy, lo[1] + (j + 1) * wy)

    def _default_row(self) -> torch.Tensor:
        """A parked row: at the subdomain's centre, inert but finite."""
        x_lo, x_hi, y_lo, y_hi = self._subdomain()
        r = torch.zeros(_NMIG, dtype=self._dtype, device=self._dev)
        r[0] = 0.5 * (x_lo + x_hi)
        r[1] = 0.5 * (y_lo + y_hi)
        r[2] = self._lo[2] + 0.5 * self._L[2]
        r[9] = r[10] = r[16] = 1.0       # tag, typ, ucgml
        return r

    def _dist(self, state: SimState):
        """Sort the atoms into subdomains and keep this rank's, padded to
        ``cap_tot`` rows."""
        sl = self.slab
        self._dtype, self._dev = state.x.dtype, state.device
        self._lo = state.box.lo.double().cpu().numpy()
        self._L = state.box.lengths.double().cpu().numpy()
        self._gbox = state.box
        xw, image = state.box.wrap(state.x, state.image)
        lo, L = state.box.lo, state.box.lengths
        sx = torch.clamp((xw[:, 0] - lo[0]) / L[0] * sl.n_devices, 0,
                         sl.n_devices - 1).to(torch.int64)
        sy = torch.clamp((xw[:, 1] - lo[1]) / L[1] * sl.n_dev_y, 0,
                         sl.n_dev_y - 1).to(torch.int64)
        s = sx * sl.n_dev_y + sy
        counts = torch.bincount(s, minlength=sl.n_dev_total).cpu()
        if int(counts.max()) > sl.cap_local:
            d = int(torch.argmax(counts))
            raise ValueError(f"subdomain {d} holds {int(counts[d])} atoms > "
                             f"cap_local {sl.cap_local}; raise cap_local")
        fz = ForceOut.zeros(self.n_global, dtype=self._dtype,
                            device=self._dev)
        rows = _pack_mig(dataclasses.replace(state, x=xw, image=image),
                         fz)[s == self.ring.rank]
        F = self._default_row().expand(sl.cap_tot, _NMIG).clone()
        F[:rows.shape[0]] = rows
        self._F = F
        self._nloc = torch.tensor(rows.shape[0], device=self._dev)
        self._step = int(state.step)
        self._pe = torch.zeros((), dtype=self._dtype, device=self._dev)
        self._virial = torch.zeros(6, dtype=self._dtype, device=self._dev)
        self._oob = None
        self._setup_done = False
        self.dangerous_builds = 0

    def gather(self):
        """(SimState, ForceOut) of the whole system in tag order, on every
        rank: one all-gather of the fixed blocks and their counts."""
        blocks = self.ring.all_gather(
            _with_count(self._F, self._nloc))
        rows = []
        for b in blocks:
            F, n = _count_of(b)
            rows.append(F[:int(n)])
        rows = torch.cat(rows)
        if rows.shape[0] != self.n_global:
            raise RuntimeError(f"the subdomains hold {rows.shape[0]} atoms, "
                               f"not {self.n_global}")
        rows = rows[torch.argsort(torch.round(rows[:, 9]).long())]
        proto = dataclasses.replace(self.state, step=self._step,
                                    box=self._gbox, n_total=0)
        fz = ForceOut.zeros(self.n_global, dtype=self._dtype,
                            device=self._dev)
        state, fout = _unpack_mig(rows, proto, fz)
        return state, dataclasses.replace(fout, pe=self._pe,
                                          virial=self._virial)

    # ---- one block on this rank -------------------------------------------

    def _virtual_boxes(self):
        """(bin_box, pair_box): the subdomain widened by rc (+ a hair) on
        its cut axes, where the local list bins, and the global box without
        periodicity on those axes, where the pair displacements live."""
        sl = self.slab
        rc = sl.rc
        eps = 1e-3 * rc
        x_lo, x_hi, y_lo, y_hi = self._subdomain()
        lo, L = self._lo, self._L
        per = (False, not sl.is_2d, True)
        blo = [x_lo - rc - eps, lo[1], lo[2]]
        bhi = [x_hi + rc + eps, lo[1] + L[1], lo[2] + L[2]]
        if sl.is_2d:
            blo[1], bhi[1] = y_lo - rc - eps, y_hi + rc + eps
        mk = dict(periodic=per, dtype=self._dtype, device=self._dev)
        return (Box.create(blo, bhi, **mk),
                Box.create(lo, lo + L, **mk))

    def _sim_of(self, F, box):
        """(SimState, ForceOut) of this rank's packed rows on ``box``; the
        tag-keyed draws size their streams by the global atom count."""
        proto = dataclasses.replace(self.state, step=self._step, box=box,
                                    n_total=self.n_global)
        fz = ForceOut(f=F[:, 18:21], ucgforce=F[:, 21], scores=F[:, 22:24],
                      pe=self._pe, virial=self._virial)
        return _unpack_mig(F, proto, fz)

    def _topology(self, state: SimState, valid, i_owned, nloc):
        """This block's topology on this rank's rows: ``{"nloc", "rows"}``
        (``rows`` with bonded terms), the (cap_tot, S) special rows of the
        owned rows (cap_tot elsewhere; None without special lists) and the
        overflow flag of a term with an owned member and an absent one."""
        ng, cap = self.n_global, state.n_atoms
        dev = state.device
        tag = state.tag.long()
        inv = torch.full((ng + 1,), cap, dtype=torch.int64, device=dev)
        inv[torch.where(valid, tag - 1, ng)] = torch.arange(cap, device=dev)

        def look(t):
            return inv[torch.clamp(t - 1, 0, ng - 1)]

        topo, excl = {"nloc": nloc}, None
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        if self.excl_tags is not None:
            et = self.excl_tags[torch.clamp(tag - 1, 0, ng - 1)]
            # parked rows carry garbage tags: only owned rows keep theirs
            excl = torch.where(i_owned[:, None] & (et > 0), look(et), cap)
        if self.bonded is not None:
            bp = self.bonded
            rows = {}
            for key in _TERMS:
                tags = getattr(bp, f"{key}_tags")
                rs = tuple(look(tags[:, m]) for m in range(tags.shape[1]))
                rows[key] = rs
                if tags.shape[0]:
                    owned = functools.reduce(torch.logical_or,
                                             [r < nloc for r in rs])
                    miss = functools.reduce(torch.logical_or,
                                            [r >= cap for r in rs])
                    overflow = overflow | torch.any(owned & miss)
            topo["rows"] = rows
        return topo, excl, overflow

    def _block(self, nsteps: int, run_window, cswitch: bool = False):
        """One rebuild and ``nsteps`` Verlet (or r-RESPA) steps (none: the
        setup's force pass) on this rank, with the cluster_switch event
        after the rebuild when ``cswitch``; returns the per-block flags,
        summed, with the event's (stats, info) under "cswitch"."""
        sl = self.slab
        ring = self.ring
        Dx, Dy = sl.dims
        me_x, me_y = ring.me
        cap_local, cap_halo, cap_tot = sl.cap_local, sl.cap_halo, sl.cap_tot
        cap_hy = sl.cap_halo_y
        y_base = cap_local + 2 * cap_halo
        dt_, dev = self._dtype, self._dev
        rows_i = torch.arange(cap_tot, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        lo = torch.as_tensor(self._lo, dtype=dt_, device=dev)
        L = torch.as_tensor(self._L, dtype=dt_, device=dev)
        x_lo, x_hi, y_lo, y_hi = self._subdomain()
        rc = sl.rc
        bin_box, pair_box = self._virtual_boxes()
        F, nloc = self._F, self._nloc

        # ---- 1. wrap and migrate, x then y --------------------------------
        shift = torch.floor((F[:, 0:3] - lo) / L)
        F = F.clone()
        F[:, 0:3] -= shift * L
        F[:, 6:9] += shift

        def migrate(F, nloc, col, D, me_d, axis, cap_mig):
            owned = rows_i < nloc
            s = torch.clamp((F[:, col] - lo[col]) / L[col] * D, 0,
                            D - 1).to(torch.int64)
            off = torch.remainder(s - me_d, D)
            stay = owned & (off == 0)
            go_hi = owned & (off == 1)
            go_lo = owned & (off == D - 1)
            ovf = torch.any(owned & ~(stay | go_hi | go_lo))  # > 1 hop
            n_hi, n_lo = go_hi.sum(), go_lo.sum()
            ovf = ovf | (n_hi > cap_mig) | (n_lo > cap_mig)
            from_lo, from_hi = ring.exchange(
                axis, _with_count(F[_take_first(go_lo, cap_mig)], n_lo),
                _with_count(F[_take_first(go_hi, cap_mig)], n_hi),
                "migrate")
            in_lo, n_in_lo = _count_of(from_lo)
            in_hi, n_in_hi = _count_of(from_hi)
            nkeep = stay.sum()
            Fs = torch.cat([F[_take_first(stay, cap_tot)],
                            F.new_zeros((1, _NMIG))])
            mi = torch.arange(cap_mig, device=dev)
            for buf, n, first in ((in_lo, n_in_lo, nkeep),
                                  (in_hi, n_in_hi, nkeep + n_in_lo)):
                dst = first + mi
                dst = torch.where((mi < n) & (dst < cap_tot), dst, cap_tot)
                Fs[dst] = buf
            nloc2 = nkeep + n_in_lo + n_in_hi
            return (Fs[:cap_tot], nloc2, ovf | (nloc2 > cap_local),
                    n_lo + n_hi)

        F, nloc, ovf, migrated = migrate(F, nloc, 0, Dx, me_x, 0, sl.cap_mig)
        overflow = overflow | ovf
        if sl.is_2d:
            # diagonal movers arrive by their x hop, then ride the y stage
            F, nloc, ovf, mig_y = migrate(F, nloc, 1, Dy, me_y, 1,
                                          sl.cap_mig_y)
            overflow = overflow | ovf
            migrated = migrated + mig_y

        # park the rows past the owned ones
        owned = rows_i < nloc
        dflt = self._default_row()
        F = torch.where(owned[:, None], F, dflt)

        # ---- 2. establish the halos, x then y ------------------------------
        def halo_feats(F):
            # x3, λ, state, p, typ, tag, mol
            return F[:, [0, 1, 2, 14, 13, 17, 10, 9, 11]]

        def halo_into(F, recv, hval, base, cap):
            z = F.new_zeros((cap, 1))
            rows = torch.cat([recv[:, 0:3], z.expand(cap, 6), recv[:, 7:8],
                              recv[:, 6:7], recv[:, 8:9], z, recv[:, 4:5],
                              recv[:, 3:4], z, torch.ones_like(z),
                              recv[:, 5:6], z.expand(cap, _NMIG - 18)], 1)
            F = F.clone()
            F[base:base + cap] = torch.where(hval[:, None], rows, dflt)
            return F

        def stage(F, elig, coord, c_lo, c_hi, axis, cap, base, seam):
            """One halo stage: the eligible rows within rc of the two faces
            of ``coord`` go to the neighbours; returns (F, sources,
            received-row masks, seam shifts, overflow)."""
            near_lo = elig & (F[:, coord] < c_lo + rc)
            near_hi = elig & (F[:, coord] >= c_hi - rc)
            n_lo, n_hi = near_lo.sum(), near_hi.sum()
            ovf = (n_lo > cap) | (n_hi > cap)
            src_lo = _take_first(near_lo, cap)
            src_hi = _take_first(near_hi, cap)
            hc = halo_feats(F)
            from_lo, from_hi = ring.exchange(
                axis, _with_count(hc[src_lo], n_lo),
                _with_count(hc[src_hi], n_hi), "halo")
            from_lo, nf_lo = _count_of(from_lo)
            from_hi, nf_hi = _count_of(from_hi)
            # ghosts across the periodic seam are shifted next to us
            sh_lo, sh_hi = seam
            from_lo = from_lo.clone()
            from_hi = from_hi.clone()
            from_lo[:, coord] += sh_lo
            from_hi[:, coord] += sh_hi
            hi_ = torch.arange(cap, device=dev)
            hval_lo, hval_hi = hi_ < nf_lo, hi_ < nf_hi
            F = halo_into(F, from_lo, hval_lo, base, cap)
            F = halo_into(F, from_hi, hval_hi, base + cap, cap)
            return F, (src_lo, src_hi), (hval_lo, hval_hi), ovf

        seam_x = (-float(self._L[0]) if me_x == 0 else 0.0,
                  float(self._L[0]) if me_x == Dx - 1 else 0.0)
        F, src_x, hval_x, ovf = stage(F, owned, 0, x_lo, x_hi, 0, cap_halo,
                                      cap_local, seam_x)
        overflow = overflow | ovf
        valid = torch.cat([owned[:cap_local], *hval_x])
        stages = [(0, src_x, hval_x, seam_x, cap_local, cap_halo)]
        if sl.is_2d:
            # owned and x-ghost rows within rc of the y faces (the x-ghosts
            # fill the corners)
            seam_y = (-float(self._L[1]) if me_y == 0 else 0.0,
                      float(self._L[1]) if me_y == Dy - 1 else 0.0)
            elig = torch.cat([valid, torch.zeros(2 * cap_hy, dtype=torch.bool,
                                                 device=dev)])
            F, src_y, hval_y, ovf = stage(F, elig, 1, y_lo, y_hi, 1, cap_hy,
                                          y_base, seam_y)
            overflow = overflow | ovf
            valid = torch.cat([valid, *hval_y])
            stages.append((1, src_y, hval_y, seam_y, y_base, cap_hy))

        # ---- 3. the topology and the local list --------------------------
        # ghosts are candidates but tally nothing: pe and the virial summed
        # over the ranks count each pair twice, as on one device
        i_owned = torch.cat([owned[:cap_local],
                             torch.zeros(2 * cap_halo + 2 * cap_hy,
                                         dtype=torch.bool, device=dev)])
        state, fout = self._sim_of(F, bin_box if self._column else pair_box)
        topo = excl = None
        if self.bonded is not None or self.excl_tags is not None:
            topo, excl, ovf = self._topology(state, valid, i_owned, nloc)
            overflow = overflow | ovf
        if self._column:
            nbr = colpack.restrict_i(
                colpack.build(state.x, bin_box, self.nbr_spec, valid=valid),
                i_owned)
            if excl is not None:
                topo["excl_rows"] = excl     # subtracted (runtime/sim.py)
        else:
            nbr = nbrmod.build(state.x, bin_box, self.nbr_spec, valid=valid,
                               i_valid=i_owned, excl=excl)
        overflow = overflow | nbr.overflow

        # ---- 4. Verlet with a halo refresh before every force pass --------
        def exchange_rows(a, stage_, seam_shift=False, kind="xchg"):
            """Ghost rows of ``a`` ((N, K) or (N,), atom order) from their
            owners along one stage; ``seam_shift`` adds the seam shift to
            the received rows' coordinate of the stage's axis."""
            axis, (s_lo, s_hi), (h_lo, h_hi), seam, base, cap = stage_
            from_lo, from_hi = ring.exchange(axis, a[s_lo], a[s_hi], kind)
            if seam_shift:
                from_lo = from_lo.clone()
                from_hi = from_hi.clone()
                from_lo[:, axis] += seam[0]
                from_hi[:, axis] += seam[1]
            a = a.clone()
            for recv, hval, b in ((from_lo, h_lo, base),
                                  (from_hi, h_hi, base + cap)):
                m = hval if a.dim() == 1 else hval[:, None]
                a[b:b + cap] = torch.where(m, recv, a[b:b + cap])
            return a

        def xchg(a):
            """The density styles' phase-boundary exchange: ghost rows of a
            per-atom array get their owners' values."""
            for st in stages:
                a = exchange_rows(a, st)
            return a

        def dyn(s):
            return torch.stack([s.x[:, 0], s.x[:, 1], s.x[:, 2], s.ucgl,
                                s.ucgstate.to(dt_), s.ucgp], 1)

        def set_dyn(s, d):
            return dataclasses.replace(
                s, x=d[:, 0:3].contiguous(), ucgl=d[:, 3].contiguous(),
                ucgstate=torch.round(d[:, 4]).to(torch.int32),
                ucgp=d[:, 5].contiguous())

        def refresh(s):
            """x, λ, state and p of the ghosts from their owners (the y
            stage reads the x-refreshed rows, so corners follow)."""
            for st in stages:
                s = set_dyn(s, exchange_rows(dyn(s), st, True, "refresh"))
            return s

        asl = nbr.atom_slot if self._column else None

        def refresh_slots(s):
            """:func:`refresh` with the state resident in slot order: the
            sources gather at their slots, the ghosts' rows scatter to
            theirs (the unused rows of the received buffers to a row past
            the end, which is dropped)."""
            n_sl = s.x.shape[0]
            for axis, (s_lo, s_hi), (h_lo, h_hi), seam, base, cap in stages:
                d = dyn(s)
                from_lo, from_hi = ring.exchange(axis, d[asl[s_lo]],
                                                 d[asl[s_hi]], "refresh")
                d = torch.cat([d, d[:1]])
                for recv, hval, b, sh in ((from_lo, h_lo, base, seam[0]),
                                          (from_hi, h_hi, base + cap,
                                           seam[1])):
                    recv = recv.clone()
                    recv[:, axis] += sh
                    d[torch.where(hval, asl[b:b + cap], n_sl)] = recv
                s = set_dyn(s, d[:n_sl])
            return s

        def wrap_pair(fn):
            target = fn if fn is not None else self.pair_compute
            if getattr(target, "supports_halo_xchg", False):
                def with_xchg(s, nb, p, **kw):
                    return target(s, nb, p, xchg=xchg, **kw)
                return with_xchg
            return target

        def clean(fout, rows_valid=True):
            # rows in no column (padding) take slot 0's outputs on the
            # kernel path: zero them, so parked rows never move; the
            # out-of-table counts stay for thermo, the in-pass posterior is
            # already in the state
            fout = dataclasses.replace(fout, ucgp=None)
            if not rows_valid:
                return fout
            return dataclasses.replace(
                fout, f=torch.where(valid[:, None], fout.f, 0.0),
                ucgforce=torch.where(valid, fout.ucgforce, 0.0),
                scores=torch.where(valid[:, None], fout.scores, 0.0))

        def forces(s, pair_fn=None, scores_valid=True):
            return self._forces(s, nbr, run_window, wrap_pair(pair_fn),
                                scores_valid, topo=topo)

        mass_all = self._masses_by_type
        cfg = self.cfg

        def step(s, fout, pair_fn, scores_valid, refresh_fn, rows_valid=True):
            mass = mass_all[s.typ]
            s = fi.initial_integrate(s, fout.f, fout.ucgforce, mass, cfg.dt,
                                     cfg.u.ftm2v, cfg.integrator)
            s = refresh_fn(s)
            s, fout = forces(s, pair_fn, scores_valid)
            fout = clean(fout, rows_valid)
            s = fi.final_integrate(s, fout.f, fout.ucgforce, mass, cfg.dt,
                                   cfg.u.ftm2v, cfg.integrator)
            return dataclasses.replace(s, step=s.step + 1), fout

        def bonded_f(s):
            # the inner level's force at the owners' positions: ghost rows
            # carry no velocity, so they stand still between refreshes
            return bd.compute_spatial(refresh(s), self.bonded, topo["rows"],
                                      nloc)[0]

        def respa_step(s, fout, fbond):
            mass = mass_all[s.typ]
            integ, ftm2v = cfg.integrator, cfg.u.ftm2v
            s = fi.respa_outer_initial(s, fout.f, fout.ucgforce, mass, cfg.dt,
                                       ftm2v, integ)
            for _ in range(cfg.respa_inner):
                s, fbond = fi.respa_inner_step(
                    s, fbond, mass, cfg.dt / cfg.respa_inner, ftm2v, integ,
                    bonded_f)
            s, fout = forces(refresh(s))
            fout = clean(fout)
            s = fi.respa_outer_final(s, fout.f, fout.ucgforce, mass, cfg.dt,
                                     ftm2v, integ)
            return dataclasses.replace(s, step=s.step + 1), fout, fbond

        event = None
        if cswitch:
            # the event after the rebuild (PRE_EXCHANGE), then the forces
            # at the new types (Simulation.run's setup after an event)
            params_cs, _ = self.cswitch
            if self._column:
                nbr_cs = nbrmod.build(state.x, bin_box, self._cs_spec,
                                      valid=valid, i_valid=i_owned)
                overflow = overflow | nbr_cs.overflow
            else:
                nbr_cs = nbr
            flipped, stats, info = fcs.apply(
                self._cs_draws(params_cs), state, nbr_cs, params_cs,
                self.cswitch_stats, ring=ring, valid=valid)
            state = dataclasses.replace(state, typ=flipped.typ)
            event = (stats, info)

        respa = cfg.respa_inner > 1
        if nsteps == 0 or cswitch:
            state, fout = forces(state)
            fout = clean(fout)
        if nsteps and respa:
            fbond = bonded_f(state)
            for _ in range(nsteps):
                state, fout, fbond = respa_step(state, fout, fbond)
        elif nsteps:
            fast_fn = getattr(self.pair_compute, "fast_variant", None)
            fast_scores = True
            if fast_fn is not None and self._scores_inert:
                nos = getattr(self.pair_compute, "fast_variant_noscores",
                              None)
                if nos is not None:
                    fast_fn, fast_scores = nos, False
            use_slot = (self._slot_ok and nsteps > 1
                        and not getattr(self.pair_compute,
                                        "supports_halo_xchg", False))
            if use_slot:
                slot_fn = self.pair_compute.slot_fast
                if not fast_scores:
                    slot_fn = getattr(self.pair_compute,
                                      "slot_fast_noscores", slot_fn)
                ss, sf = self._to_slots(state, clean(fout), nbr)
                for _ in range(nsteps - 1):
                    ss, sf = step(ss, sf, slot_fn, fast_scores,
                                  refresh_slots, rows_valid=False)
                s1, f1 = self._from_slots(state, ss, sf, nbr)
                # padding rows read slot 0 there: they keep their rows
                keep = valid[:, None]
                s1 = dataclasses.replace(
                    s1, x=torch.where(keep, s1.x, state.x),
                    v=torch.where(keep, s1.v, state.v),
                    ucgl=torch.where(valid, s1.ucgl, state.ucgl),
                    ucgvl=torch.where(valid, s1.ucgvl, state.ucgvl),
                    ucgp=torch.where(valid, s1.ucgp, state.ucgp),
                    ucgstate=torch.where(valid, s1.ucgstate,
                                         state.ucgstate))
                state, fout = step(s1, clean(f1), None, True, refresh)
            elif fast_fn is not None and nsteps > 1:
                for _ in range(nsteps - 1):
                    state, fout = step(state, fout, fast_fn, fast_scores,
                                       refresh)
                state, fout = step(state, fout, None, True, refresh)
            else:
                for _ in range(nsteps):
                    state, fout = step(state, fout, None, True, refresh)
        if respa:
            # the pair pass holds no bonded terms under r-RESPA: their pe
            # and virial join the block's sums (one device's thermo)
            _, bpe, bvir = bd.compute_spatial(state, self.bonded,
                                              topo["rows"], nloc)
            pe_vir = (fout.pe + bpe, fout.virial + bvir)
        else:
            pe_vir = (fout.pe, fout.virial)
        danger = nbrmod.displacement_check(nbr, state.x, pair_box,
                                           self.nbr_spec.skin)
        self._last = (state, nbr, valid, i_owned)

        self._F = _pack_mig(state, fout)
        self._nloc = nloc
        self._step = int(state.step)
        # one sum over the ranks: pe, the virial, the out-of-table counts
        # and the flags
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        oob = [zero if c is None else c.double()
               for c in (fout.oob_low, fout.oob_high)]
        tot = ring.all_reduce(torch.cat([
            pe_vir[0].double().reshape(1), pe_vir[1].double(),
            torch.stack(oob), torch.stack([
                overflow.double(), danger.double(), migrated.double()])]))
        host = tot[7:].cpu().tolist()
        self._pe = tot[0].to(dt_)
        self._virial = tot[1:7].to(dt_)
        self._oob = (None if fout.oob_low is None
                     else tot[7:9].round().to(torch.int32))
        flags = {"overflow": host[2] > 0, "danger": int(host[3] > 0),
                 "migrated": int(host[4])}
        if flags["overflow"]:
            occ = nbr.max_occupancy.to(torch.float64).reshape(1)
            flags["max_occ"] = int(ring.all_reduce(occ, "max")[0])
        if event is not None:
            flags["cswitch"] = event
        return flags

    def last_list(self):
        """(state, list) of this rank at the end of its last block: its
        rows and the list built at the block's start (D1 checks)."""
        return self._last[0], self._last[1]

    def last_masks(self):
        """(valid, i_owned) of the last block's rows: in the list, and
        tallying."""
        return self._last[2], self._last[3]

    # ---- the run loops ----------------------------------------------------

    def _check(self, flags, where: str):
        if flags["overflow"]:
            raise RuntimeError(
                f"spatial capacity exceeded {where} (migration, halo or "
                f"local-list overflow, a hop past a neighbour, or a bonded "
                f"term with a member out of reach; max "
                f"occupancy {flags['max_occ']})")

    def setup(self, run_window=(0, 0)):
        """Halos and the initial forces: one block of no steps (the
        Verlet::setup analogue)."""
        flags = self._block(0, tuple(run_window))
        self._setup_done = True
        self.migrations += flags["migrated"]
        self._check(flags, "at setup")

    def _run_block(self, nsteps: int, run_window, cswitch: bool = False):
        step = self._step
        flags = self._block(nsteps, run_window, cswitch)
        self.migrations += flags["migrated"]
        if self.cfg.check_safety:
            self._check(flags, f"at step {self._step}")
            self.dangerous_builds += flags["danger"]
        if cswitch:
            # the stats and labels are the same on every rank, so is the
            # convergence error
            self.cswitch_stats, info = flags["cswitch"]
            self.cswitch_sweeps.append(int(info["sweeps"]))
            self._finish_event(info, step)
        return flags


    def event_due(self) -> bool:
        """Whether the cluster_switch event opens the next block: its start
        step is a positive multiple of the switch frequency."""
        if self.cswitch is None:
            return False
        freq = self.cswitch[1]
        return self._step > 0 and self._step % freq == 0

    def run(self, nsteps: int, thermo_every: int = 0,
            thermo_callback=None):
        """Advance ``nsteps`` in blocks of ``reneigh_every`` (the last may
        be short), the cluster_switch event opening each block it is due
        at, with thermo rows as ``Simulation.run`` takes them; then
        ``state`` is the gathered system."""
        begin = self._step
        window = (begin, begin + nsteps)
        if not self._setup_done:
            self.setup(window)
        done = 0
        while done < nsteps:
            todo = min(self.cfg.reneigh_every, nsteps - done)
            self._run_block(todo, window, self.event_due())
            done += todo
            if thermo_every and (done % thermo_every == 0 or done == nsteps):
                row = self.thermo()
                self.thermo_rows.append(row)
                if thermo_callback is not None:
                    thermo_callback(row)
        self.state, self._fcarry = self.gather()
        return self.state

    def run_fused(self, nblocks: int, run_window=None,
                  do_cswitch: bool = False):
        """Advance ``nblocks`` × ``reneigh_every`` steps: no thermo, no
        gather; the flags are read once per block.  ``do_cswitch``: the
        cluster_switch event rides the first block (one device's
        ``run_fused`` fires none, as in the JAX package)."""
        step = self._step
        if run_window is None:
            run_window = (step, step + nblocks * self.cfg.reneigh_every)
        run_window = tuple(int(v) for v in run_window)
        if not self._setup_done:
            self.setup(run_window)
        for k in range(nblocks):
            self._run_block(self.cfg.reneigh_every, run_window,
                            do_cswitch and k == 0)

    def carry(self) -> dict:
        """What a continuation on the same ranks needs to resume this run
        exactly: this rank's packed rows and live count, the summed pe,
        virial and out-of-table counts, the step and the decomposition
        (every block rebuilds, so no list is kept)."""
        if not self._setup_done:
            raise RuntimeError("no run to carry: call setup or run first")
        rec = {"F": self._F, "nloc": self._nloc, "pe": self._pe,
               "virial": self._virial, "step": self._step,
               "slab": self.slab}
        if self._oob is not None:
            rec["oob"] = self._oob
        return rec

    def resume(self, record: dict):
        """Continue from :meth:`carry` of this rank's run that reached this
        state: its rows replace the distribution, and the next block goes
        on as if the run had never stopped.  Nothing is drawn."""
        if record["slab"] != self.slab or record["F"].shape != self._F.shape:
            raise ValueError("the carry record is of another decomposition")
        self._F = record["F"].to(self._dev)
        self._nloc = record["nloc"].to(self._dev)
        self._pe, self._virial = record["pe"], record["virial"]
        self._oob = record.get("oob")
        self._step = int(record["step"])
        self._setup_done = True

    def set_state(self, state: SimState):
        """Distribute ``state`` anew (the next force pass is a setup)."""
        self.state = state
        self._dist(state)

    def thermo(self) -> dict:
        """The thermo row of ``Simulation.thermo`` from one device-side sum
        over the ranks (no gather)."""
        cfg = self.cfg
        u = cfg.u
        F, dt_ = self._F, self._dtype
        owned = torch.arange(F.shape[0], device=self._dev) < self._nloc
        typ = torch.round(F[:, 10]).long()
        zero = torch.zeros((), dtype=dt_, device=self._dev)
        mass = self._masses_by_type[typ]
        ke = 0.5 * torch.sum(torch.where(
            owned, mass * torch.sum(F[:, 3:6] ** 2, 1), zero)) * u.mvv2e
        ke_lam = 0.5 * torch.sum(torch.where(
            owned, F[:, 16] * F[:, 15] ** 2, zero)) * u.mvv2e
        if cfg.integrator.wall and cfg.integrator.bias_potential:
            be = fi.bias_energy(F[:, 14], cfg.integrator.barrier)
            tp = getattr(self.pair_params, "tp", None)
            if tp is not None:
                be = torch.where(tp.n_states[typ] > 1, be, zero)
            group = getattr(cfg.integrator, "group", None)
            if group is not None:
                g = torch.as_tensor(group, dtype=torch.bool,
                                    device=self._dev)
                be = torch.where(g[torch.round(F[:, 9]).long() - 1], be,
                                 zero)
            pe_bias = torch.sum(torch.where(owned, be, zero))
        else:
            pe_bias = zero
        tot = self.ring.all_reduce(torch.stack([ke, ke_lam, pe_bias])
                                   .double())
        vals = torch.cat([tot, self._pe.double().reshape(1),
                          self._virial[:3].double().sum().reshape(1)])
        ke, ke_lambda, pe_bias, pe, virial_tr = vals.cpu().tolist()
        n = self.n_global
        vol = float(np.prod(self._L))
        dof = max(3 * n - 3, 1)
        row = {
            "step": self._step,
            "temp": 2.0 * ke / (dof * u.boltz),
            "pe": pe + pe_bias,
            "ke": ke,
            "ke_lambda": ke_lambda,
            "lambda_temp": ke_lambda / (0.5 * u.boltz * n),
            "etotal": ke + pe + pe_bias + ke_lambda,
            "press": (2.0 * ke + virial_tr) / (3.0 * vol) * u.nktv2p,
        }
        if self._oob is not None:
            row["oob_low"], row["oob_high"] = (int(v) for v in
                                               self._oob.cpu().tolist())
        return row


def from_simulation(sim: Simulation, ring: Ring, **caps) -> SpatialSimulation:
    """``sim``'s system, pair path, configuration and seed on the
    decomposition of ``ring``'s grid (:func:`spec_for`)."""
    slab = spec_for(sim, ring.dims, **caps)
    return SpatialSimulation(sim.system, sim.state, sim.pair_compute,
                             sim.pair_params, slab, sim.cfg, ring,
                             seed=sim.seed, cluster_switch=sim.cswitch,
                             log_dir=sim.log_dir, bonded=sim.bonded,
                             excl_tags=(None if sim.excl_tags is None
                                        else sim.excl_tags.cpu().numpy()))
