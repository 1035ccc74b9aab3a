"""Core simulation state: dataclasses of tensors (port of
``lammps_ucg_dev_tpu/core/state.py``).

All per-atom state lives in one structure-of-arrays :class:`SimState` whose
rows are tag-stable (``tag`` carries atom identity).  The UCG fields mirror
the reference's ``atom_style ucg`` (``UCG/atom_vec_ucg.cpp:48-90``):
``ucgstate`` (discrete state), ``ucgl`` (λ), ``ucgvl`` (λ velocity),
``ucgml`` (λ pseudo-mass) and ``ucgp`` (posterior, -1 = unassigned).
``ucgforce`` and the softmax scores are force-like outputs of the force pass
(:class:`ForceOut`).

Differences from the JAX counterpart:
  * the step counter is a host ``int`` (the block loop runs on the host);
  * there is no PRNG key: the ``Simulation`` owns a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises (the
    port's builders and converters default to the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on "
                           "the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Box:
    """Simulation box: orthogonal, or restricted triclinic with the LAMMPS
    tilt factors ``tilt = (xy, xz, yz)`` (cell vectors a = (lx, 0, 0),
    b = (xy, ly, 0), c = (xz, yz, lz)).  Tilted boxes run on the ``nsq``
    neighbor path; the cell list, the column list and the kernels take
    orthogonal boxes only, as in the JAX package."""

    lo: torch.Tensor   # (3,)
    hi: torch.Tensor   # (3,)
    tilt: torch.Tensor | None = None   # (3,) = (xy, xz, yz); None: orthogonal
    periodic: tuple = (True, True, True)

    @property
    def lengths(self) -> torch.Tensor:
        return self.hi - self.lo

    @property
    def is_triclinic(self) -> bool:
        return self.tilt is not None

    def min_image(self, dr: torch.Tensor) -> torch.Tensor:
        """Minimum-image displacement.  A fully periodic orthogonal box
        skips the per-axis mask (multiplying by 1.0 changes no bit).  A
        tilted box takes the sequential z→y→x rounds of LAMMPS
        ``Domain::minimum_image``, in the JAX package's order: exact for
        tilts within the LAMMPS bounds and a cutoff below half the least
        perpendicular width."""
        L = self.lengths
        if self.tilt is None:
            if all(self.periodic):
                return dr - L * torch.round(dr / L)
            per = torch.tensor(self.periodic, dtype=dr.dtype,
                               device=dr.device)
            return dr - per * L * torch.round(dr / L)
        px, py, pz = (float(p) for p in self.periodic)
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        nz = pz * torch.round(dr[..., 2] / L[2])
        dx = dr[..., 0] - nz * xz
        dy = dr[..., 1] - nz * yz
        dz = dr[..., 2] - nz * L[2]
        ny = py * torch.round(dy / L[1])
        dx = dx - ny * xy
        dy = dy - ny * L[1]
        nx = px * torch.round(dx / L[0])
        dx = dx - nx * L[0]
        return torch.stack([dx, dy, dz], dim=-1)

    def wrap(self, x: torch.Tensor, image: torch.Tensor | None = None):
        """Wrap positions into the primary cell; update image flags.  A
        tilted box wraps in fractional coordinates (the analytic inverse
        of the upper-triangular H) and shifts by whole cell vectors."""
        L = self.lengths
        if self.tilt is None:
            shift = torch.floor((x - self.lo) / L)
        else:
            xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
            d = x - self.lo
            sz = d[..., 2] / L[2]
            sy = (d[..., 1] - yz * sz) / L[1]
            sx = (d[..., 0] - xy * sy - xz * sz) / L[0]
            shift = torch.floor(torch.stack([sx, sy, sz], dim=-1))
        if not all(self.periodic):
            per = torch.tensor(self.periodic, device=x.device)
            shift = torch.where(per[None, :], shift, torch.zeros_like(shift))
        if self.tilt is None:
            x_w = x - shift * L
        else:
            # shift @ H.T for the cell matrix H with columns (a, b, c),
            # written out (no GEMM, so no TF32 rounding on the card)
            x_w = x - torch.stack([
                shift[:, 0] * L[0] + shift[:, 1] * xy + shift[:, 2] * xz,
                shift[:, 1] * L[1] + shift[:, 2] * yz,
                shift[:, 2] * L[2]], dim=-1)
        if image is None:
            return x_w
        return x_w, image + shift.to(image.dtype)

    @staticmethod
    def create(lo, hi, periodic=(True, True, True), dtype=torch.float32,
               device="cpu", tilt=None) -> "Box":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        return Box(lo=t(lo), hi=t(hi),
                   tilt=None if tilt is None else t(tilt),
                   periodic=tuple(bool(p) for p in periodic))


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic per-atom state + the step counter."""

    step: int
    x: torch.Tensor          # (N, 3)
    v: torch.Tensor          # (N, 3)
    tag: torch.Tensor        # (N,) int32 atom ids (stable under reordering)
    typ: torch.Tensor        # (N,) int32, 1-based LAMMPS "actual" types
    mol: torch.Tensor        # (N,) int32
    q: torch.Tensor          # (N,)
    image: torch.Tensor      # (N, 3) int32
    ucgstate: torch.Tensor   # (N,) int32
    ucgl: torch.Tensor       # (N,)
    ucgvl: torch.Tensor      # (N,)
    ucgml: torch.Tensor      # (N,)
    ucgp: torch.Tensor       # (N,)
    box: Box
    n_total: int = 0         # the atom count when the arrays hold another
                             # number of rows (the slot-major interior's
                             # n_slots); 0 = the rows are the atoms.  Tag-
                             # keyed draws size their stream by it.

    @property
    def n_atoms(self) -> int:
        return self.x.shape[0]

    @property
    def rng_n(self) -> int:
        """Length of tag-keyed per-atom random streams (the atom count)."""
        return self.n_total or self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def permute(self, order: torch.Tensor) -> "SimState":
        """The atoms reordered by ``order`` (e.g. by cell, for locality);
        ``tag`` keeps each atom's identity, like LAMMPS's atom tags under
        sorting."""
        per_atom = ("x", "v", "tag", "typ", "mol", "q", "image", "ucgstate",
                    "ucgl", "ucgvl", "ucgml", "ucgp")
        return dataclasses.replace(self, **{
            f: getattr(self, f)[order] for f in per_atom})

    @staticmethod
    def create(x, v=None, typ=None, tag=None, mol=None, q=None,
               ucgstate=None, ucgl=None, ucgvl=None, ucgml=None, ucgp=None,
               box: Box | None = None, dtype=torch.float32,
               device="cpu") -> "SimState":
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        n = x.shape[0]

        def arr(a, default, dt=dtype):
            if a is None:
                return torch.full((n,), default, dtype=dt, device=device)
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        i32 = torch.int32
        v = (torch.zeros_like(x) if v is None
             else torch.as_tensor(np.asarray(v), dtype=dtype, device=device))
        if box is None:
            box = Box(lo=x.min(0).values, hi=x.max(0).values)
        tag = (torch.arange(1, n + 1, dtype=i32, device=device) if tag is None
               else arr(tag, 0, i32))
        return SimState(
            step=0, x=x, v=v, tag=tag,
            typ=arr(typ, 1, i32), mol=arr(mol, 0, i32), q=arr(q, 0.0),
            image=torch.zeros((n, 3), dtype=i32, device=device),
            # data_atom_post defaults: state clamped to {0,1}, λ to [0,1],
            # ucgp = -1 sentinel (atom_vec_ucg.cpp:145-170)
            ucgstate=torch.clamp(arr(ucgstate, 0, i32), 0, 1),
            ucgl=torch.clamp(arr(ucgl, 0.0), 0.0, 1.0),
            ucgvl=arr(ucgvl, 0.0), ucgml=arr(ucgml, 1.0), ucgp=arr(ucgp, -1.0),
            box=box)


@dataclasses.dataclass(frozen=True)
class ForceOut:
    """Per-step force-pass outputs (force-like quantities, cleared each step)."""

    f: torch.Tensor          # (N, 3)
    ucgforce: torch.Tensor   # (N,) λ-forces (-dU/dλ)
    scores: torch.Tensor     # (N, 2) softmax scores
    pe: torch.Tensor         # () potential energy
    virial: torch.Tensor     # (6,) xx yy zz xy xz yz
    oob_low: torch.Tensor | None = None    # pairs below the table inner cutoff
    oob_high: torch.Tensor | None = None   # pairs beyond the table outer end
    ucgp: torch.Tensor | None = None       # (N,) posterior of a style that
                                           # computes it in the pass (P3)

    def __add__(self, other: "ForceOut") -> "ForceOut":
        """Sum of two force passes; ``other``'s posterior wins."""
        def add_opt(a, b):
            if a is None:
                return b
            return a if b is None else a + b

        return ForceOut(
            f=self.f + other.f, ucgforce=self.ucgforce + other.ucgforce,
            scores=self.scores + other.scores, pe=self.pe + other.pe,
            virial=self.virial + other.virial,
            oob_low=add_opt(self.oob_low, other.oob_low),
            oob_high=add_opt(self.oob_high, other.oob_high),
            ucgp=other.ucgp if other.ucgp is not None else self.ucgp)

    @staticmethod
    def zeros(n: int, n_states: int = 2, dtype=torch.float32,
              device="cpu") -> "ForceOut":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return ForceOut(f=z(n, 3), ucgforce=z(n), scores=z(n, n_states),
                        pe=z(), virial=z(6))


@dataclasses.dataclass(frozen=True)
class System:
    """Static system description."""

    n_atoms: int
    ntypes: int
    masses: Any            # np.ndarray (ntypes+1,), index 0 unused
    units: str = "lj"
    dim: int = 3
