"""K5 and K6 — the geometry-only density-CV pair kernels over column spans,
and their plain twins (port of ``_kernel_cv_colspan``/``_kernel_cv`` and
``_phys_cv_tile`` of ``lammps_ucg_dev_tpu/ops/pallas_pair.py``).

* :func:`cv_rho` (K5) is pass 1 of both density styles: ρ_i = Σ_j w(r)
  with w = ½(1 − tanh((r − R_i)/(0.1 R_i))) and the real in-cutoff count.
* :func:`cv_force` (K6) is pass 3: the CV back-force
  F_i = Σ_j (c_i g_i + c_j g_j)/r · dr (+ the virial when observing), with
  g = −dw/dr ("mder"), +dw/dr ("pder") or w ("w").

On CUDA tensors each wrapper launches the hand-written Hopper kernel
``csrc/density_cv.cu`` (built at its first launch, ops/cuda_lib.py) or
raises; on CPU tensors it runs its plain PyTorch twin
(:func:`cv_rho_reference`, :func:`cv_force_reference`).  ``.launches``
counts kernel launches.  Both kernels run on the tile walk of
``csrc/colspan.cuh``: one warp per 8-slot cluster of i-slots tests each
candidate of the cluster's nine spans once against all 8, and runs the
in-cutoff pairs 32 at a time; each sum runs in an order the inputs alone
fix, so two launches on the same inputs give the same bits, and K5's count
is exact.

Kernel contract (both the CUDA kernels and the twins) — K1's inputs
(ops/hopper_pair.py) without coefficient rows, plus
  rad    (nrad,) f32 proximity radius per type (``pertype``; index = attr 7;
         K6 at most 16 entries, K5 any number) or one radius for every
         atom (nrad 1)
  ipack  (n_slots, 8) f32 [x y z c state valid c typ], c = the CV weight
         cvf (pass 3; unused by K5)
  K5 out (n_slots, 2) [ρ n_real]
  K6 out (n_slots, 4) [Fx Fy Fz 0]; part (n_slots, 8)
         [0 vxx vyy vzz vxy vxz vyz 0] per i-slot (``observe``)
Rows of invalid i-slots are zero.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

GFORMS = ("mder", "pder", "w")
R_FLOOR = 1e-12      # a plain type's radius (w = g = 0 for every pair)


def radius_table(radius_by_type: torch.Tensor, device):
    """(rad, pertype) of K5/K6 from the per-type radii (index 0 unused),
    floored at 1e-12: one f32 entry when every type shares a radius, else
    the table with a harmless 1.0 at index 0.  ``select_pair_kernel``
    builds it once, as the params' ``cv_rad``."""
    r = np.maximum(radius_by_type.cpu().numpy().astype(np.float64)[1:],
                   R_FLOOR)
    pertype = not np.all(r == r[0])
    vals = np.concatenate([[1.0], r]) if pertype else r[:1]
    return (torch.as_tensor(vals, dtype=torch.float32, device=device),
            pertype)


def cv_scalars(box, cutsq, innersq, dtype=torch.float32) -> torch.Tensor:
    """[Lx Ly cutsq innersq 0 0 0 0]."""
    L = box.lengths.to(dtype)
    z = torch.zeros((), dtype=dtype, device=L.device)
    return torch.stack([L[0], L[1], cutsq.to(dtype), innersq.to(dtype),
                        z, z, z, z])


def cv_inputs(state: SimState, cl: colpack.ColumnList, cv_rad, cutsq,
              innersq, weight: torch.Tensor | None, slot: bool = False):
    """(args, kwargs) of :func:`cv_rho` (``weight`` None) or
    :func:`cv_force` (the per-atom CV weight in attrs 3 and 6, ``gform``
    and ``observe`` still to give) — passes 1 and 3 of both density
    styles; ``cv_rad`` is the style's :func:`radius_table`.  ``slot``:
    ``state`` and ``weight`` are slot-resident (``colpack.pack``'s
    ``slot``)."""
    f32 = torch.float32
    rad, pertype = cv_rad
    zeros = torch.zeros(state.n_atoms, dtype=f32, device=state.device)
    c = zeros if weight is None else weight
    ipack, cols = colpack.pack(cl, state.box, state.x, c, zeros, dtype=f32,
                               aux=c, typ=state.typ if pertype else None,
                               slot=slot)
    return ((cv_scalars(state.box, cutsq, innersq), cl.z0, cl.L, ipack, cols,
             rad), dict(mx=cl.mx, my=cl.my, periodic=cl.periodic,
                        pertype=pertype))


# ---- the plain PyTorch twins -------------------------------------------------

def _radius(rad, tv, pertype: bool):
    if not pertype:
        return rad[0]
    return rad[torch.clamp(tv.long(), 0, rad.shape[0] - 1)]


def _g(t, R, gform: str):
    if gform == "w":
        return 0.5 * (1.0 - t)
    sgn = -0.5 if gform == "mder" else 0.5
    return sgn * (1.0 - t * t) / (0.1 * R)


def cv_rho_reference(scal, z0, span_len, ipack, cols, rad, *, mx: int,
                     my: int, pertype: bool, periodic: tuple = (True, True)):
    """Plain PyTorch version of K5 (same arguments, same output)."""
    out = torch.zeros((ipack.shape[0], 2), dtype=ipack.dtype,
                      device=ipack.device)
    zero = torch.zeros((), dtype=ipack.dtype, device=ipack.device)
    for sl, irows, _, _, _, _, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=False,
            periodic=periodic):
        r = torch.sqrt(torch.where(mask, rsq, torch.ones_like(rsq)))
        ri = _radius(rad, irows[:, :, 7:8], pertype)
        t = torch.tanh((r - ri) / (0.1 * ri))
        rho = torch.sum(torch.where(mask, 0.5 * (1.0 - t), zero), -1)
        out[sl] = torch.stack([rho, torch.sum(mask, -1).to(rho.dtype)],
                              -1).reshape(-1, 2)
    return out


def cv_force_reference(scal, z0, span_len, ipack, cols, rad, *, mx: int,
                       my: int, gform: str, observe: bool, pertype: bool,
                       periodic: tuple = (True, True)):
    """Plain PyTorch version of K6 (same arguments, same outputs)."""
    dev, dt = ipack.device, ipack.dtype
    n_slots = ipack.shape[0]
    out = torch.zeros((n_slots, 4), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev) if observe else None
    zero = torch.zeros((), dtype=dt, device=dev)
    for sl, irows, jattr, dx, dy, dz, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe,
            periodic=periodic):
        r = torch.sqrt(torch.where(mask, rsq, torch.ones_like(rsq)))
        ri = _radius(rad, irows[:, :, 7:8], pertype)
        gi = _g(torch.tanh((r - ri) / (0.1 * ri)), ri, gform)
        if pertype:
            rj = _radius(rad, jattr(7), True)
            gj = _g(torch.tanh((r - rj) / (0.1 * rj)), rj, gform)
        else:
            gj = gi
        fcv = torch.where(mask, (irows[:, :, 6:7] * gi + jattr(3) * gj) / r,
                          zero)
        out[sl] = torch.stack([torch.sum(fcv * dx, -1),
                               torch.sum(fcv * dy, -1),
                               torch.sum(fcv * dz, -1),
                               torch.zeros_like(fcv[..., 0])],
                              -1).reshape(-1, 4)
        if observe:
            # pe 0, and no inner-cutoff count (rsq > 0 in the mask)
            part[sl] = hp.observed(torch.zeros_like(fcv), fcv, dx, dy, dz,
                                   mask, rsq, zero)
    return out, part


# ---- special exclusions: compute and subtract --------------------------------

def excl_rho(state: SimState, jrows: torch.Tensor, cv_rad, cutsq):
    """K5's two sums over the (N, S) special-partner lists ``jrows`` (row
    indices, == N where empty): (ρ, n_real) of the listed partners within
    the cutoff, in K5's float32 functional (the i-atom's radius from the
    style's :func:`radius_table`).  The density styles subtract them after
    K5, so ρ and the count leave the specials out as the reference path's
    list does."""
    rad, pertype = cv_rad
    _, _, rsq, mask = hp.excl_geometry(state, jrows, cutsq)
    zero = torch.zeros((), dtype=rsq.dtype, device=rsq.device)
    r = torch.sqrt(torch.where(mask, rsq, torch.ones_like(rsq)))
    ri = _radius(rad, state.typ[:, None], pertype)
    t = torch.tanh((r - ri) / (0.1 * ri))
    return (torch.sum(torch.where(mask, 0.5 * (1.0 - t), zero), 1),
            torch.sum(mask, 1).to(rsq.dtype))


def excl_force(state: SimState, jrows: torch.Tensor, cv_rad, cutsq,
               cvf: torch.Tensor, gform: str, observe: bool):
    """K6's back-force of the listed special pairs at the CV weights
    ``cvf``: ((N, 3) forces, (8,) [0 virial 0] summed, or None unless
    ``observe``), in K6's float32 functional, for the density styles to
    subtract after K6."""
    rad, pertype = cv_rad
    jc, dr, rsq, mask = hp.excl_geometry(state, jrows, cutsq)
    zero = torch.zeros((), dtype=rsq.dtype, device=rsq.device)
    r = torch.sqrt(torch.where(mask, rsq, torch.ones_like(rsq)))
    ti = state.typ[:, None]
    ri = _radius(rad, ti, pertype)
    gi = _g(torch.tanh((r - ri) / (0.1 * ri)), ri, gform)
    if pertype:
        rj = _radius(rad, state.typ[jc], True)
        gj = _g(torch.tanh((r - rj) / (0.1 * rj)), rj, gform)
    else:
        gj = gi
    c = cvf.to(rsq.dtype)
    fcv = torch.where(mask, (c[:, None] * gi + c[jc] * gj) / r, zero)
    dx, dy, dz = dr[..., 0], dr[..., 1], dr[..., 2]
    f = torch.stack([torch.sum(fcv * dx, 1), torch.sum(fcv * dy, 1),
                     torch.sum(fcv * dz, 1)], 1)
    part = (hp.observed(torch.zeros_like(fcv), fcv, dx, dy, dz, mask, rsq,
                        zero).sum(0) if observe else None)
    return f, part


# ---- the CUDA launch -----------------------------------------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    fn = cuda_lib.load("density_cv").lib.density_cv_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _launch_cuda(mode: int, scal, z0, span_len, ipack, cols, rad, *, mx, my,
                 gform, observe, pertype, periodic=(True, True)):
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    if gform not in GFORMS:
        raise ValueError(f"unknown g form {gform!r}")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    hp._check(scal, "scal", f32, (8,), dev)
    hp._check(z0, "z0", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(span_len, "L", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(ipack, "ipack", f32, (n_slots, 8), dev)
    hp._check(cols, "cols", f32, (ncol, 8, czp), dev)
    if rad.dim() != 1 or rad.shape[0] < 1 or (pertype and rad.shape[0] < 2):
        raise ValueError(f"rad has shape {tuple(rad.shape)}")
    hp._check(rad, "rad", f32, tuple(rad.shape), dev)
    out = torch.empty((n_slots, 2 if mode == 0 else 4), dtype=f32, device=dev)
    part = (torch.empty((n_slots, 8), dtype=f32, device=dev) if observe
            else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
                    ipack.data_ptr(), cols.data_ptr(), rad.data_ptr(),
                    out.data_ptr(), part.data_ptr() if observe else None,
                    n_slots, mx, my, cz, czp, rad.shape[0], mode,
                    GFORMS.index(gform), int(observe), int(pertype),
                    stream, hp.periodic_bits(periodic))
    if rc != 0:
        raise RuntimeError(f"density_cv kernel launch failed: CUDA error {rc}")
    return out, part


def cv_rho(scal, z0, span_len, ipack, cols, rad, *, mx: int, my: int,
           pertype: bool, periodic: tuple = (True, True)):
    """K5: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns out (n_slots, 2) [ρ n_real]."""
    if ipack.is_cuda:
        out, _ = _launch_cuda(0, scal, z0, span_len, ipack, cols, rad, mx=mx,
                              my=my, gform="mder", observe=False,
                              pertype=pertype, periodic=periodic)
        cv_rho.launches["rho"] += 1
        return out
    if ipack.device.type == "cpu":
        return cv_rho_reference(scal, z0, span_len, ipack, cols, rad, mx=mx,
                                my=my, pertype=pertype, periodic=periodic)
    raise ValueError(f"no K5 implementation for device {ipack.device}")


cv_rho.launches = {"rho": 0}


def cv_force(scal, z0, span_len, ipack, cols, rad, *, mx: int, my: int,
             gform: str, observe: bool, pertype: bool,
             periodic: tuple = (True, True)):
    """K6: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, gform=gform, observe=observe, pertype=pertype,
              periodic=periodic)
    if ipack.is_cuda:
        res = _launch_cuda(1, scal, z0, span_len, ipack, cols, rad, **kw)
        cv_force.launches["full" if observe else "fast"] += 1
        return res
    if ipack.device.type == "cpu":
        return cv_force_reference(scal, z0, span_len, ipack, cols, rad, **kw)
    raise ValueError(f"no K6 implementation for device {ipack.device}")


cv_force.launches = {"full": 0, "fast": 0}
