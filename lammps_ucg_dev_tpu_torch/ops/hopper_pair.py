"""K1 — the ``table_ucgld`` pair kernel over column spans, and its wrappers
(port of the ``style="ucgld"`` path of ``lammps_ucg_dev_tpu/ops/pallas_pair.py``).

* :func:`ucgld_pair` is the kernel's wrapper.  On CUDA tensors it launches
  the hand-written Hopper kernel ``csrc/ucgld_pair.cu`` (built at its first
  launch, ops/cuda_lib.py) or raises; on CPU tensors it runs
  :func:`ucgld_pair_reference`, the kernel's plain PyTorch twin.
  ``ucgld_pair.launches`` counts kernel launches per variant.
* :func:`compute` is the ForceOut-compatible pair evaluation on a column
  list: pack → kernel → slot→atom take → chemical-potential and 1/kT
  post-processing, with pe and virial halved (full list, newton off).
* :func:`compute_style` (+ ``.fast_variant`` / ``.fast_variant_noscores``)
  is the ``Simulation`` pair entry.

Kernel contract (both the CUDA kernel and the twin):
  scal   (8,) f32   [Lx Ly cutsq innersq uscale uoff 0 0]
  z0, L  (ncol, cz/8, 9) int32 candidate spans per (column, cluster, stencil)
  ipack  (n_slots, 8) f32 [x y z λ state valid 0 typ]
  cols   (ncol, 8, czp) f32 the same attributes over the extended slots
  coef   (rows, degree) Chebyshev rows: D-form [eA eB eC eD fA fB fC fD]
         ([eB eD fA fB fC fD] without observe and scores), or for
         multi-type systems the raw rows [e_0..e_{T-1} f_0..f_{T-1}] padded
         to 16, with ``cls`` (T+1, T+1, 4) int32 raw table ids of the
         (00, 01, 10, 11) state combinations per ordered type pair
  out    (n_slots, 8) [fx fy fz lamf s0 s1 0 0]
  part   (n_slots, 8) [pe vxx vyy vzz vxy vxz vyz oob] per i-slot (observe)
Rows of invalid i-slots are zero.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable

NSTEN = colpack.NSTEN
MAX_ROWS = 16
MAX_DEGREE = 24
TWIN_CHUNK_ELEMS = 1 << 22   # (i-row, candidate) pairs per twin chunk


def supports(params: UCGLDParams) -> bool:
    """Static eligibility: a Chebyshev-fittable bank, every type plain
    (1-state) or 2-state UCG with at least one UCG type, one shared cutoff,
    at most 8 tables and 3 actual types."""
    tp = params.tp
    if not fittable(params.bank) or tp.ntypes < 1:
        return False
    ns = tp.n_states.cpu().numpy()[1:]
    if not np.all((ns == 1) | (ns == 2)) or not np.any(ns == 2):
        return False
    cuts = tp.cutsq.cpu().numpy()[1:, 1:]
    if not np.allclose(cuts, cuts[0, 0]):
        return False
    return params.bank.n_tables <= 8 and tp.ntypes <= 3


def variant(observe: bool, want_scores: bool) -> str:
    if observe:
        if not want_scores:
            raise ValueError("the observing variant always tallies scores")
        return "full"
    return "fast" if want_scores else "noscores"


def kernel_rows(cheb: ChebBank, tp, observe: bool, want_scores: bool,
                dtype=torch.float32, device=None):
    """(coef, cls) for the kernel, cached on the ChebBank.  One actual type:
    the 2x2 state basis change to D-form happens on the coefficients in
    float64 (costs nothing per candidate), ``cls`` is None.  Several types:
    raw rows padded to 16 and the (T+1, T+1, 4) row-id table."""
    device = cheb.coeffs.device if device is None else torch.device(device)
    key = (observe, want_scores, dtype, str(device))
    if key in cheb.kernel_rows:
        return cheb.kernel_rows[key]
    ce = cheb.coeffs.cpu().numpy().astype(np.float64)
    T = ce.shape[0] // 2
    tab4 = tp.tab4.cpu().numpy()
    nt = tp.ntypes
    if nt == 1:
        i00, i01, i10, i11 = (int(v) for v in tab4[1, 1].reshape(-1))

        def abcd(base):
            A = ce[base + i00]
            return (A, ce[base + i10] - A, ce[base + i01] - A,
                    (ce[base + i11] - ce[base + i01])
                    - (ce[base + i10] - ce[base + i00]))

        eA, eB, eC, eD = abcd(0)
        fA, fB, fC, fD = abcd(T)
        rows = ([eA, eB, eC, eD, fA, fB, fC, fD] if (want_scores or observe)
                else [eB, eD, fA, fB, fC, fD])
        coef = np.stack(rows)
        cls = None
    else:
        coef = np.zeros((MAX_ROWS, ce.shape[1]))
        coef[:2 * T] = ce
        ids = np.full((nt + 1, nt + 1, 4), -1, np.int64)
        ids[1:, 1:] = tab4[1:, 1:].reshape(nt, nt, 4)
        cls = torch.as_tensor(ids, dtype=torch.int32, device=device)
    out = (torch.as_tensor(coef, dtype=dtype, device=device), cls)
    cheb.kernel_rows[key] = out
    return out


def u_map(cheb: ChebBank, dtype=torch.float32):
    """(uscale, uoff) with u = rsq·uscale + uoff ∈ [-1, 1] over the fit
    domain."""
    span = (cheb.hi - cheb.lo).to(dtype)
    return (2.0 / span).to(dtype), (-(cheb.hi + cheb.lo) / span).to(dtype)


def kernel_scalars(box, params: UCGLDParams, cheb: ChebBank,
                   dtype=torch.float32) -> torch.Tensor:
    """scal = [Lx Ly cutsq innersq uscale uoff 0 0] (the u map of
    :func:`u_map`)."""
    L = box.lengths.to(dtype)
    uscale, uoff = u_map(cheb, dtype)
    zero = torch.zeros((), dtype=dtype, device=L.device)
    return torch.stack([L[0], L[1], params.tp.cutsq[1, 1].to(dtype),
                        params.bank.innersq[0].to(dtype), uscale, uoff,
                        zero, zero])


# ---- the plain PyTorch twin ------------------------------------------------

def span_pairs(scal, z0, span_len, ipack, cols, *, mx: int, my: int,
               observe: bool, every: bool = False):
    """The twins' walk over the column spans (shared by the twins of K1–K7).
    Each cluster's nine spans expand into a padded candidate index;
    clusters go in chunks of at most ``TWIN_CHUNK_ELEMS`` (i-row,
    candidate) pairs so 2^20-atom systems fit.  Yields, per chunk,
    ``(rows_slice, irows, jattr, dx, dy, dz, rsq, mask)``: ``irows`` the
    (C, 8, 8) i-slot rows, ``jattr(a)`` the (C, 1, K) candidate attribute
    a, and ``mask`` the pairs with 0 < rsq < cutsq from a real i-slot (and,
    with ``observe``, to a valid j-slot); with ``every``, every candidate
    of a real i-slot, with no distance test."""
    dev, dt = ipack.device, ipack.dtype
    ncol, cpc, _ = z0.shape
    czp = cols.shape[2]
    nclus = ncol * cpc
    sten_np, sx_np, sy_np = colpack.stencil(mx, my)
    sten = torch.as_tensor(sten_np, device=dev)
    sx = torch.as_tensor(sx_np, dtype=dt, device=dev)
    sy = torch.as_tensor(sy_np, dtype=dt, device=dev)
    Lx, Ly, cutsq = scal[0], scal[1], scal[2]
    flat = cols.reshape(-1)
    starts_all = z0.reshape(nclus, NSTEN).long()
    lens_all = span_len.reshape(nclus, NSTEN).long()
    kmax = int(lens_all.sum(1).max()) if nclus else 0
    if kmax == 0:
        return
    chunk = max(1, TWIN_CHUNK_ELEMS // (8 * kmax))
    for c0 in range(0, nclus, chunk):
        c1 = min(nclus, c0 + chunk)
        C = c1 - c0
        lens, starts = lens_all[c0:c1], starts_all[c0:c1]
        cum = lens.cumsum(1)
        K = int(cum[:, -1].max())
        if K == 0:
            continue
        kk = torch.arange(K, device=dev)
        s_of = torch.searchsorted(cum, kk.expand(C, K).contiguous(),
                                  right=True)                  # (C, K)
        live = s_of < NSTEN
        s_c = s_of.clamp(max=NSTEN - 1)
        jslot = (starts.gather(1, s_c) + kk[None, :]
                 - (cum - lens).gather(1, s_c))
        colc = (torch.arange(c0, c1, device=dev) // cpc)[:, None]
        base = torch.where(live, sten[colc, s_c] * (8 * czp) + jslot, 0)

        def jattr(a, _base=base):
            return flat[_base + a * czp][:, None, :]           # (C, 1, K)

        xj = jattr(0) + (sx[colc, s_c] * Lx)[:, None, :]
        yj = jattr(1) + (sy[colc, s_c] * Ly)[:, None, :]
        irows = ipack[c0 * 8:c1 * 8].reshape(C, 8, 8)
        dx = irows[:, :, 0:1] - xj
        dy = irows[:, :, 1:2] - yj
        dz = irows[:, :, 2:3] - jattr(2)
        rsq = dx * dx + dy * dy + dz * dz
        mask = live[:, None, :] & (irows[:, :, 5:6] > 0.5)
        if not every:
            mask = mask & (rsq < cutsq) & (rsq > 0.0)
        if observe:
            mask = mask & (jattr(5) > 0.5)
        yield slice(c0 * 8, c1 * 8), irows, jattr, dx, dy, dz, rsq, mask


def series(coef, u, degree: int):
    """Chebyshev rows at u by the explicit recurrence (the kernels' form).
    Past-cutoff lanes may run to inf/NaN; callers select them out with
    ``torch.where`` (never multiply by the mask)."""
    u2 = u + u
    nrow = coef.shape[0]
    acc = [coef[r, 0] + coef[r, 1] * u for r in range(nrow)]
    tm2, tm1 = torch.ones_like(u), u
    for k in range(2, degree):
        tk = u2 * tm1 - tm2
        for r in range(nrow):
            acc[r] = acc[r] + coef[r, k] * tk
        tm2, tm1 = tm1, tk
    return acc


def channels(acc, cls, irows, jattr, ntab: int):
    """(eA, eB, eC, eD, fA, fB, fC, fD) in D-form: from the D-form rows
    (8 rows; eA = eC = None with the 6-row set) or, with ``cls``, from the
    raw rows through the (T+1, T+1, 4) row-id table."""
    if cls is None:
        if len(acc) == 8:
            return tuple(acc)
        eB, eD, fA, fB, fC, fD = acc
        return None, eB, None, eD, fA, fB, fC, fD
    stack = torch.stack(acc)                                   # (R, C, 8, K)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    ti = irows[:, :, 7:8].long()
    tj = torch.clamp(jattr(7).long(), 0, cls.shape[0] - 1)

    def channel(q, f_off):
        ids = cls[ti, tj, q].long()                            # (C, 8, K)
        v = torch.gather(stack, 0, (ids.clamp(min=0) + f_off)[None])[0]
        return torch.where(ids >= 0, v, zero)

    e00, e01, e10, e11 = (channel(q, 0) for q in range(4))
    f00, f01, f10, f11 = (channel(q, ntab) for q in range(4))
    return (e00, e10 - e00, e01 - e00, (e11 - e01) - (e10 - e00),
            f00, f10 - f00, f01 - f00, (f11 - f01) - (f10 - f00))


def observed(emix, fmix, dx, dy, dz, mask, rsq, innersq):
    """(C*8, 8) partial rows [pe vxx vyy vzz vxy vxz vyz oob] of a chunk;
    ``emix`` and ``fmix`` are already zero outside ``mask``."""
    p = [torch.sum(emix, -1)]
    for a, b in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz), (dy, dz)):
        p.append(torch.sum(fmix * a * b, -1))
    p.append(torch.sum((mask & (rsq < innersq)).to(emix.dtype), -1))
    return torch.stack(p, -1).reshape(-1, 8)


def ucgld_pair_reference(scal, z0, span_len, ipack, cols, coef, cls, *,
                         mx: int, my: int, degree: int, ntab: int,
                         observe: bool, want_scores: bool):
    """Plain PyTorch version of the kernel (same arguments, same outputs),
    computed in the tensors' dtype."""
    variant(observe, want_scores)
    dev, dt = ipack.device, ipack.dtype
    n_slots = ipack.shape[0]
    out = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev) if observe else None
    innersq, uscale, uoff = scal[3], scal[4], scal[5]
    zero = torch.zeros((), dtype=dt, device=dev)
    for sl, irows, jattr, dx, dy, dz, rsq, mask in span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe):
        # lower clamp only; past-cutoff lanes may run to inf/NaN and are
        # selected out below
        u = torch.clamp(rsq * uscale + uoff, min=-1.0)
        eA, eB, eC, eD, fA, fB, fC, fD = channels(
            series(coef, u, degree), cls, irows, jattr, ntab)
        li, lj = irows[:, :, 3:4], jattr(3)
        wD = li * lj
        fmix = torch.where(mask, fA + li * fB + lj * fC + wD * fD, zero)
        cols_out = [torch.sum(fmix * dx, -1), torch.sum(fmix * dy, -1),
                    torch.sum(fmix * dz, -1),
                    -torch.sum(torch.where(mask, eB + lj * eD, zero), -1)]
        if want_scores:
            sj = jattr(4)
            cols_out += [
                -torch.sum(torch.where(mask, eA + sj * eC, zero), -1),
                -torch.sum(torch.where(mask, (eA + eB) + sj * (eC + eD),
                                       zero), -1)]
        else:
            cols_out += [torch.zeros_like(cols_out[0])] * 2
        cols_out += [torch.zeros_like(cols_out[0])] * 2
        out[sl] = torch.stack(cols_out, -1).reshape(-1, 8)
        if observe:
            emix = torch.where(mask, eA + li * eB + lj * eC + wD * eD, zero)
            part[sl] = observed(emix, fmix, dx, dy, dz, mask, rsq, innersq)
    return out, part


# ---- the CUDA launch ---------------------------------------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    nl = cuda_lib.load("ucgld_pair")
    fn = nl.lib.ucgld_pair_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_cuda(scal, z0, span_len, ipack, cols, coef, cls, *, mx, my,
                 degree, ntab, observe, want_scores):
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    multi = cls is not None
    nrow = MAX_ROWS if multi else (8 if (observe or want_scores) else 6)
    if not 2 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [2, {MAX_DEGREE}]")
    _check(scal, "scal", f32, (8,), dev)
    _check(z0, "z0", i32, (ncol, cpc, NSTEN), dev)
    _check(span_len, "L", i32, (ncol, cpc, NSTEN), dev)
    _check(ipack, "ipack", f32, (n_slots, 8), dev)
    _check(cols, "cols", f32, (ncol, 8, czp), dev)
    _check(coef, "coef", f32, (nrow, degree), dev)
    ntypes1 = 0
    if multi:
        ntypes1 = cls.shape[0]
        _check(cls, "cls", i32, (ntypes1, ntypes1, 4), dev)
    out = torch.empty((n_slots, 8), dtype=f32, device=dev)
    part = (torch.empty((n_slots, 8), dtype=f32, device=dev) if observe
            else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
                    ipack.data_ptr(), cols.data_ptr(), coef.data_ptr(),
                    cls.data_ptr() if multi else None, out.data_ptr(),
                    part.data_ptr() if observe else None,
                    n_slots, mx, my, cz, czp, degree, ntab, ntypes1,
                    int(observe), int(want_scores), int(multi), stream)
    if rc != 0:
        raise RuntimeError(f"ucgld_pair kernel launch failed: CUDA error {rc}")
    ucgld_pair.launches[variant(observe, want_scores)] += 1
    return out, part


def ucgld_pair(scal, z0, span_len, ipack, cols, coef, cls, *, mx: int,
               my: int, degree: int, ntab: int, observe: bool,
               want_scores: bool):
    """K1: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, degree=degree, ntab=ntab, observe=observe,
              want_scores=want_scores)
    if ipack.is_cuda:
        return _launch_cuda(scal, z0, span_len, ipack, cols, coef, cls, **kw)
    if ipack.device.type == "cpu":
        return ucgld_pair_reference(scal, z0, span_len, ipack, cols, coef,
                                    cls, **kw)
    raise ValueError(f"no K1 implementation for device {ipack.device}")


ucgld_pair.launches = {"full": 0, "fast": 0, "noscores": 0}


# ---- ForceOut-compatible wrappers --------------------------------------------

def kernel_inputs(state: SimState, cl: colpack.ColumnList,
                  params: UCGLDParams, cheb: ChebBank, observe: bool,
                  want_scores: bool):
    """(args, kwargs) of :func:`ucgld_pair` for one pair evaluation."""
    tp = params.tp
    f32 = torch.float32
    is_ucg = tp.n_states[state.typ] > 1
    # non-UCG atoms carry λ-weight [1, 0]: zero their packed λ
    lam_eff = torch.where(is_ucg, state.ucgl, torch.zeros_like(state.ucgl))
    multi = tp.ntypes > 1
    ipack, cols = colpack.pack(cl, state.box, state.x, lam_eff,
                               state.ucgstate, dtype=f32,
                               typ=state.typ if multi else None)
    coef, cls = kernel_rows(cheb, tp, observe, want_scores, f32, state.device)
    scal = kernel_scalars(state.box, params, cheb, f32)
    return ((scal, cl.z0, cl.L, ipack, cols, coef, cls),
            dict(mx=cl.mx, my=cl.my, degree=cheb.degree,
                 ntab=params.bank.n_tables, observe=observe,
                 want_scores=want_scores))


def compute(state: SimState, cl: colpack.ColumnList, params: UCGLDParams,
            cheb: ChebBank, observe: bool = True,
            want_scores: bool = True) -> ForceOut:
    """Pair evaluation through K1.  ``observe=False`` is the fast variant
    (pe/virial/oob come back 0) for interior MD steps; ``want_scores=False``
    also drops the score tallies (scores come back 0) — valid only when
    scores have no dynamical feedback (``Simulation`` gates this)."""
    args, kw = kernel_inputs(state, cl, params, cheb, observe, want_scores)
    out, part = ucgld_pair(*args, **kw)
    return force_out(out, part, state, cl, params, observe, want_scores)


def force_out(out, part, state: SimState, cl: colpack.ColumnList,
              params: UCGLDParams, observe: bool,
              want_scores: bool) -> ForceOut:
    """Kernel outputs → ForceOut in atom order: the slot→atom take, the
    chemical-potential and 1/kT terms, and pe/virial halved (full list,
    newton off)."""
    n = state.n_atoms
    tp = params.tp
    f32 = torch.float32
    dev = state.device
    is_ucg = tp.n_states[state.typ] > 1
    out_at = out[cl.atom_slot]                                   # (N, 8)
    mu = tp.mu_diff[state.typ].to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)
    ucgforce = torch.where(is_ucg, out_at[:, 3] - mu, zero)
    if want_scores:
        kT = params.kT.to(f32)
        s = out_at[:, 4:6] / kT
        scores = torch.stack([s[:, 0], s[:, 1] + (-mu / kT)], dim=1)
        scores = torch.where(is_ucg[:, None], scores, zero)
    else:
        scores = torch.zeros((n, 2), dtype=f32, device=dev)
    if observe:
        totals = part.sum(0)
        pe = 0.5 * totals[0]
        virial = 0.5 * totals[1:7]
        oob_low = totals[7].to(torch.int32)
    else:
        pe = torch.zeros((), dtype=f32, device=dev)
        virial = torch.zeros(6, dtype=f32, device=dev)
        oob_low = torch.zeros((), dtype=torch.int32, device=dev)
    return ForceOut(f=out_at[:, 0:3], ucgforce=ucgforce, scores=scores,
                    pe=pe, virial=virial, oob_low=oob_low,
                    oob_high=torch.zeros((), dtype=torch.int32, device=dev))


def compute_style(state: SimState, cl: colpack.ColumnList,
                  params: UCGLDParams) -> ForceOut:
    """Simulation pair entry: reads the ChebBank from ``params.cheb``."""
    return compute(state, cl, params, params.cheb)


def compute_style_fast(state: SimState, cl: colpack.ColumnList,
                       params: UCGLDParams) -> ForceOut:
    """Interior-step variant: no energy/virial/oob (observe=False)."""
    return compute(state, cl, params, params.cheb, observe=False)


def compute_style_fast_noscores(state: SimState, cl: colpack.ColumnList,
                                params: UCGLDParams) -> ForceOut:
    """Interior-step variant without score tallies either — selected by the
    ``Simulation`` only when scores cannot feed back into the dynamics."""
    return compute(state, cl, params, params.cheb, observe=False,
                   want_scores=False)


compute_style.fast_variant = compute_style_fast
compute_style.fast_variant_noscores = compute_style_fast_noscores
