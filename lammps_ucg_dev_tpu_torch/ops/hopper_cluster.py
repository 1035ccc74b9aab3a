"""K8 — the ``table_ucgld`` pair kernel over cluster lists, and its wrappers
(port of the JAX package's round-1 cluster-list kernel,
``attic/pallas_ucgld.py``).

* :func:`ucgld_cluster` is the kernel's wrapper.  On CUDA tensors it
  launches the hand-written Hopper kernel ``csrc/ucgld_cluster.cu`` (built
  at its first launch, ops/cuda_lib.py) or raises; on CPU tensors it runs
  :func:`ucgld_cluster_reference`, the kernel's plain PyTorch twin.
  ``ucgld_cluster.launches`` counts kernel launches.  The kernel covers
  only the i-clusters that hold atoms (``occupied``, which the cluster
  list carries).
* :func:`compute` is the ForceOut-compatible pair evaluation on a cluster
  list (ops/clusters.py): slot pack → kernel → slot→atom take →
  chemical-potential and 1/kT terms, pe and virial halved (full list,
  newton off).  :func:`compute_style_cluster` is its ``Simulation`` pair
  entry.  The kernel has one (full) variant, so every step is full.

Kernel contract (both the CUDA kernel and the twin):
  scal   (8,) f32   [Lx Ly Lz cutsq innersq lo hi 0]
  apack  (n_slots, 8) f32 slot rows [x y z λ state valid gid 0]
  jcl    (n_icl, KC) int32 candidate j-clusters of each i-cluster, each
         row's real entries first, then pads (n_icl), as clusters.build
         lays them out; n_slots = 8·n_icl
  coef   (8, degree) the Chebyshev rows of the 4 tables in table order
         [e00 e01 e10 e11 f00 f01 f10 f11], evaluated with u clipped to
         [-1, 1] over the fit domain [lo, hi] in r² (the twin by
         Clenshaw; the kernel on their D-form rows, as K1)
  out    (n_slots, 8) [fx fy fz lamf s0 s1 0 0]
  part   (n_slots, 8) [pe vxx vyy vzz vxy vxz vyz oob] per i-slot
A pair counts when rsq < cutsq, both slots hold real atoms, its j-cluster
entry is not padding and the slot ids differ.  Rows of invalid i-slots are
zero.
"""

from __future__ import annotations

import ctypes

import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
from lammps_ucg_dev_tpu_torch.ops import clusters as clmod
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable
from lammps_ucg_dev_tpu_torch.ops.hopper_pair import TWIN_CHUNK_ELEMS, _check

CL = clmod.CL
MAX_DEGREE = 24


def supports(params: UCGLDParams) -> bool:
    """Static eligibility: a uniform, Chebyshev-fittable bank of exactly 4
    tables, one actual type with 2 states."""
    tp = params.tp
    return (bool(params.bank.uniform) and fittable(params.bank)
            and params.bank.n_tables == 4 and tp.ntypes == 1
            and int(tp.n_states[1]) == 2)


def kernel_scalars(box, params: UCGLDParams, cheb: ChebBank,
                   dtype=torch.float32) -> torch.Tensor:
    """scal = [Lx Ly Lz cutsq innersq lo hi 0]."""
    L = box.lengths.to(dtype)
    return torch.stack([L[0], L[1], L[2], params.tp.cutsq[1, 1].to(dtype),
                        params.bank.innersq[0].to(dtype), cheb.lo.to(dtype),
                        cheb.hi.to(dtype), torch.zeros_like(L[0])])


def slot_pack(state: SimState, cl: clmod.ClusterList,
              dtype=torch.float32) -> torch.Tensor:
    """(n_slots, 8) slot rows [x y z λ state valid gid 0]; pad slots are 0
    with valid 0."""
    n = state.n_atoms
    sa = cl.slot_atom
    real = sa < n
    sac = torch.clamp(sa, max=n - 1)
    zero = torch.zeros((), dtype=dtype, device=state.device)
    return torch.cat([
        torch.where(real[:, None], state.x.to(dtype)[sac], zero),
        torch.where(real, state.ucgl.to(dtype)[sac], zero)[:, None],
        torch.where(real, state.ucgstate.to(dtype)[sac], zero)[:, None],
        real.to(dtype)[:, None],
        torch.arange(cl.n_slots, dtype=dtype, device=state.device)[:, None],
        torch.zeros((cl.n_slots, 1), dtype=dtype, device=state.device),
    ], dim=1)


def kernel_inputs(state: SimState, cl: clmod.ClusterList,
                  params: UCGLDParams, cheb: ChebBank):
    """(args, kwargs) of :func:`ucgld_cluster` for one pair evaluation."""
    f32 = torch.float32
    coef = cheb.coeffs[:8].to(device=state.device, dtype=f32).contiguous()
    return ((kernel_scalars(state.box, params, cheb, f32),
             slot_pack(state, cl, f32), cl.jcl, coef),
            dict(degree=cheb.degree))


# ---- the plain PyTorch twin ------------------------------------------------

def cluster_pairs(scal, apack, jcl):
    """The twin's walk over the cluster list.  i-clusters go in chunks of
    at most ``TWIN_CHUNK_ELEMS`` (i-slot, candidate) pairs, so 2^20-atom
    systems fit.  Yields, per chunk, ``(rows_slice, irows, ja, dx, dy, dz,
    rsq, mask)``: ``irows`` the (C, 8, 1, 8) i-slot rows, ``ja`` the
    (C, 1, K, 8) candidate rows, the min-image displacements and ``mask``
    the pairs that count (module docstring)."""
    dev = apack.device
    n_icl, kc = jcl.shape
    Lx, Ly, Lz, cutsq = scal[0], scal[1], scal[2], scal[3]
    lane = torch.arange(CL, device=dev)
    chunk = max(1, TWIN_CHUNK_ELEMS // (CL * CL * kc))
    for c0 in range(0, n_icl, chunk):
        c1 = min(n_icl, c0 + chunk)
        C = c1 - c0
        jc = jcl[c0:c1].long()
        live = jc < n_icl
        gj = torch.where(live, jc, 0)[:, :, None] * CL + lane   # (C, KC, 8)
        gj = gj.reshape(C, 1, kc * CL)
        jreal = live[:, :, None].expand(C, kc, CL).reshape(C, 1, kc * CL)
        ja = apack[gj]                                          # (C, 1, K, 8)
        irows = apack[c0 * CL:c1 * CL].reshape(C, CL, 1, 8)
        gi = torch.arange(c0 * CL, c1 * CL, device=dev).reshape(C, CL, 1)

        def disp(a, L):
            d = irows[..., a] - ja[..., a]
            return d - L * torch.round(d / L)

        dx, dy, dz = disp(0, Lx), disp(1, Ly), disp(2, Lz)
        rsq = dx * dx + dy * dy + dz * dz
        mask = ((rsq < cutsq) & jreal & (gi != gj) & (ja[..., 5] > 0.5)
                & (irows[..., 5] > 0.5))
        yield slice(c0 * CL, c1 * CL), irows, ja, dx, dy, dz, rsq, mask


def clenshaw(c, u, degree: int):
    """Σ_k c[k] T_k(u) by Clenshaw's recurrence (the TPU kernel's form)."""
    u2 = u + u
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for k in range(degree - 1, 0, -1):
        b1, b2 = u2 * b1 - b2 + c[k], b1
    return u * b1 - b2 + c[0]


def ucgld_cluster_reference(scal, apack, jcl, coef, *, degree: int):
    """Plain PyTorch version of the kernel (same arguments, same outputs),
    computed in the tensors' dtype."""
    dev, dt = apack.device, apack.dtype
    n_slots = apack.shape[0]
    out = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    innersq, lo, hi = scal[4], scal[5], scal[6]
    zero = torch.zeros((), dtype=dt, device=dev)
    for sl, irows, ja, dx, dy, dz, rsq, mask in cluster_pairs(scal, apack,
                                                              jcl):
        rsqm = torch.where(mask, rsq, hi)
        u = torch.clamp(2.0 * (rsqm - lo) / (hi - lo) - 1.0, -1.0, 1.0)
        e00, e01, e10, e11, f00, f01, f10, f11 = (
            clenshaw(coef[r], u, degree) for r in range(8))
        li, lj = irows[..., 3], ja[..., 3]
        mi, mj = 1.0 - li, 1.0 - lj
        w00, w01, w10, w11 = mi * mj, mi * lj, li * mj, li * lj
        emix = torch.where(mask, w00 * e00 + w01 * e01 + w10 * e10
                           + w11 * e11, zero)
        fmix = torch.where(mask, w00 * f00 + w01 * f01 + w10 * f10
                           + w11 * f11, zero)
        sj1 = ja[..., 4] > 0.5
        cols = [torch.sum(fmix * dx, -1), torch.sum(fmix * dy, -1),
                torch.sum(fmix * dz, -1),
                -torch.sum(torch.where(mask, lj * (e11 - e01)
                                       + mj * (e10 - e00), zero), -1),
                -torch.sum(torch.where(mask, torch.where(sj1, e01, e00),
                                       zero), -1),
                -torch.sum(torch.where(mask, torch.where(sj1, e11, e10),
                                       zero), -1)]
        cols += [torch.zeros_like(cols[0])] * 2
        out[sl] = torch.stack(cols, -1).reshape(-1, 8)
        p = [torch.sum(emix, -1)]
        for a, b in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz),
                     (dy, dz)):
            p.append(torch.sum(fmix * a * b, -1))
        p.append(torch.sum((mask & (rsq < innersq)).to(dt), -1))
        part[sl] = torch.stack(p, -1).reshape(-1, 8)
    return out, part


# ---- the CUDA launch ---------------------------------------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    nl = cuda_lib.load("ucgld_cluster")
    fn = nl.lib.ucgld_cluster_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _launch_cuda(scal, apack, jcl, coef, occupied, *, degree):
    dev = apack.device
    f32 = torch.float32
    n_icl, kc = jcl.shape
    n_slots = n_icl * CL
    if not 2 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [2, {MAX_DEGREE}]")
    _check(scal, "scal", f32, (8,), dev)
    _check(apack, "apack", f32, (n_slots, 8), dev)
    _check(jcl, "jcl", torch.int32, (n_icl, kc), dev)
    _check(coef, "coef", f32, (8, degree), dev)
    if occupied is None:
        raise ValueError("K8 launches over the occupied i-clusters: pass "
                         "occupied (ClusterList.occupied)")
    n_occ = occupied.shape[0]
    _check(occupied, "occupied", torch.int32, (n_occ,), dev)
    out = torch.empty((n_slots, 8), dtype=f32, device=dev)
    part = torch.empty((n_slots, 8), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), apack.data_ptr(), jcl.data_ptr(),
                    coef.data_ptr(), out.data_ptr(), part.data_ptr(), n_icl,
                    kc, degree, stream, occupied.data_ptr(), n_occ)
    if rc != 0:
        raise RuntimeError(f"ucgld_cluster kernel launch failed: CUDA error "
                           f"{rc}")
    ucgld_cluster.launches["full"] += 1
    return out, part


def ucgld_cluster(scal, apack, jcl, coef, *, degree: int,
                  occupied: torch.Tensor | None = None):
    """K8: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part).  ``occupied``: the
    i-clusters that hold atoms, ascending (``ClusterList.occupied``), which
    the kernel's grid covers (required on CUDA); the twin walks every
    i-cluster and does not read it."""
    if apack.is_cuda:
        return _launch_cuda(scal, apack, jcl, coef, occupied, degree=degree)
    if apack.device.type == "cpu":
        return ucgld_cluster_reference(scal, apack, jcl, coef, degree=degree)
    raise ValueError(f"no K8 implementation for device {apack.device}")


ucgld_cluster.launches = {"full": 0}


# ---- ForceOut-compatible wrappers --------------------------------------------

def compute(state: SimState, cl: clmod.ClusterList, params: UCGLDParams,
            cheb: ChebBank) -> ForceOut:
    """Pair evaluation through K8 (always the full variant)."""
    args, kw = kernel_inputs(state, cl, params, cheb)
    out, part = ucgld_cluster(*args, **kw, occupied=cl.occupied)
    tp = params.tp
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=state.device)
    out_at = out[cl.atom_slot]                                   # (N, 8)
    is_ucg = tp.n_states[state.typ] > 1
    mu = tp.mu_diff[state.typ].to(f32)
    ucgforce = torch.where(is_ucg, out_at[:, 3] - mu, zero)
    kT = params.kT.to(f32)
    s = out_at[:, 4:6] / kT
    scores = torch.where(is_ucg[:, None],
                         torch.stack([s[:, 0], s[:, 1] - mu / kT], dim=1),
                         zero)
    totals = part.sum(0)
    return ForceOut(f=out_at[:, 0:3], ucgforce=ucgforce, scores=scores,
                    pe=0.5 * totals[0], virial=0.5 * totals[1:7],
                    oob_low=totals[7].to(torch.int32),
                    oob_high=torch.zeros((), dtype=torch.int32,
                                         device=state.device))


def compute_style_cluster(state: SimState, cl: clmod.ClusterList,
                          params: UCGLDParams) -> ForceOut:
    """Simulation pair entry on a ClusterList: reads the ChebBank from
    ``params.cheb`` (the attic's ``make_compute`` closure)."""
    return compute(state, cl, params, params.cheb)


def candidates(apack, jcl) -> int:
    """Candidate (i-slot, j-slot) pairs the kernel tests: every real i-slot
    against every real slot of each real entry of its cluster's list."""
    n_icl = jcl.shape[0]
    real = (apack[:, 5] > 0.5).reshape(n_icl, CL).sum(1)
    per_entry = torch.cat([real, real.new_zeros(1)])     # pad entry: none
    return int((real * per_entry[jcl.long()].sum(1)).sum())
