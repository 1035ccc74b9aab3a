"""K7 — the K1 ablation microbench kernel and its twins (port of
``_abl_kernel`` in the JAX package's ``tools/kbench.py``).

K7 runs K1's tile walk (``csrc/colspan.cuh``, one warp per 8-slot cluster)
on K1's no-scores inputs and stops at one of five physics levels, so the
time between K1's bound and its measured time can be split by level (the
tool that times it is ``lammps_ucg_dev_tpu_torch/tools/kbench.py``):

  L0  the port's walk floor: x of every candidate of the cluster's spans
      plus its column's image shift (column 0).  The TPU's L0 timed its
      window DMAs; the port has no windows, so this L0 measures something
      else: the span table and one coalesced load per candidate and
      cluster.
  L1  + geometry, the test against the cluster's 8 i-slots, the queue of
      hits and the sums of full-warp batches: Σ rsq over 0 < rsq < cutsq
      (column 0)
  L2  + the u map and the Chebyshev recurrence: Σ T_{degree-1}(u)
  L3  + the six D-form accumulators: Σ (row 0 + row 5)
  L4  + the D-form mix: fx fy fz lamf (K1 without scores, from the same
      definition in ``csrc/ucgld_phys.cuh``: bit-identical to it)

Self is excluded by rsq > 0, so L1–L4 are sums over pairs whatever the slot
geometry.  The six rows are kbench's ``[eB eD fA fB fC fD]`` from the
single-type state block, K1's no-scores rows (``hopper_pair.kernel_rows``);
K7, like the JAX tool, is single-type only.

* :func:`ucgld_ablation` is the kernel's wrapper: on CUDA tensors it
  launches ``csrc/ucgld_ablation.cu`` or raises, on CPU tensors it runs
  :func:`ablation_reference`.  ``ucgld_ablation.launches`` counts launches
  per level.
"""

from __future__ import annotations

import ctypes

import torch

from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

LEVELS = (0, 1, 2, 3, 4)
NROW = 6


def kernel_inputs(state, cl: colpack.ColumnList, params, cheb):
    """(args, kwargs) of :func:`ucgld_ablation` (without ``level``): K1's
    no-scores inputs, whose rows are kbench's six."""
    if params.tp.ntypes != 1:
        raise ValueError("K7 is single-type only")
    args, kw = hp.kernel_inputs(state, cl, params, cheb, False, False)
    return args, dict(mx=kw["mx"], my=kw["my"], degree=kw["degree"])


# ---- the plain PyTorch twins -------------------------------------------------

def ablation_reference(scal, z0, span_len, ipack, cols, coef, *, mx: int,
                       my: int, degree: int, level: int):
    """Plain PyTorch version of the kernel at ``level`` (same arguments,
    same outputs), in the tensors' dtype."""
    if level not in LEVELS:
        raise ValueError(f"level {level} outside {LEVELS}")
    if level == 4:
        return hp.ucgld_pair_reference(
            scal, z0, span_len, ipack, cols, coef, mx=mx, my=my,
            degree=degree, observe=False, want_scores=False)[0]
    dev, dt = ipack.device, ipack.dtype
    out = torch.zeros((ipack.shape[0], 8), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    uscale, uoff = scal[4], scal[5]
    for sl, irows, _, dx, _, _, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=False,
            every=level == 0):
        if level == 0:
            v = irows[:, :, 0:1] - dx               # the shifted x_j
        elif level == 1:
            v = rsq
        else:
            u = torch.clamp(rsq * uscale + uoff, min=-1.0)
            if level == 2:
                u2, tm2, v = u + u, torch.ones_like(u), u
                for _ in range(2, degree):
                    tm2, v = v, u2 * v - tm2
            else:
                acc = hp.series(coef, u, degree)
                v = acc[0] + acc[-1]
        out[sl, 0] = torch.sum(torch.where(mask, v, zero), -1).reshape(-1)
    return out


# ---- the CUDA launch ---------------------------------------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    nl = cuda_lib.load("ucgld_ablation")
    fn = nl.lib.ucgld_ablation_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_cuda(scal, z0, span_len, ipack, cols, coef, *, mx, my, degree,
                 level):
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    if not 2 <= degree <= hp.MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [2, {hp.MAX_DEGREE}]")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    hp._check(scal, "scal", f32, (8,), dev)
    hp._check(z0, "z0", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(span_len, "L", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(ipack, "ipack", f32, (n_slots, 8), dev)
    hp._check(cols, "cols", f32, (ncol, 8, czp), dev)
    hp._check(coef, "coef", f32, (NROW, degree), dev)
    out = torch.empty((n_slots, 8), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
                    ipack.data_ptr(), cols.data_ptr(), coef.data_ptr(),
                    out.data_ptr(), n_slots, mx, my, cz, czp, degree, level,
                    stream)
    if rc != 0:
        raise RuntimeError(f"ucgld_ablation kernel launch failed: CUDA error "
                           f"{rc}")
    ucgld_ablation.launches[f"L{level}"] += 1
    return out


def ucgld_ablation(scal, z0, span_len, ipack, cols, coef, *, mx: int,
                   my: int, degree: int, level: int):
    """K7 at ``level``: the hand-written kernel on CUDA tensors (launch or
    raise), its plain twin on CPU tensors.  Returns the (n_slots, 8)
    output."""
    if level not in LEVELS:
        raise ValueError(f"level {level} outside {LEVELS}")
    kw = dict(mx=mx, my=my, degree=degree, level=level)
    if ipack.is_cuda:
        return _launch_cuda(scal, z0, span_len, ipack, cols, coef, **kw)
    if ipack.device.type == "cpu":
        return ablation_reference(scal, z0, span_len, ipack, cols, coef, **kw)
    raise ValueError(f"no K7 implementation for device {ipack.device}")


ucgld_ablation.launches = {f"L{lv}": 0 for lv in LEVELS}
