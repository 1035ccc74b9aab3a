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
  With ``slot=True`` the state is slot-resident
  (``Simulation``'s slot-major interior): ``colpack.pack_slots`` fills the
  kernel's inputs, and the ForceOut rows come back in slot order, with no
  take.
* :func:`compute_style` (+ ``.fast_variant`` / ``.fast_variant_noscores``,
  ``.slot_fast`` / ``.slot_fast_noscores``, ``.excl_delta``) is the
  ``Simulation`` pair entry.
* :func:`excl_delta` is the pair contribution of the special-exclusion
  lists in K1's own functional, which the driver subtracts from the
  kernel's output (the kernel computes every in-cutoff pair).

Kernel contract (both the CUDA kernel and the twin):
  scal   (8,) f32   [Lx Ly cutsq innersq uscale uoff 0 0]
  z0, L  (ncol, cz/8, 9) int32 candidate spans per (column, cluster, stencil)
  ipack  (n_slots, 8) f32 [x y z λ state valid 0 typ]
  cols   (ncol, 8, czp) f32 the same attributes over the extended slots
  coef   Chebyshev rows in D-form: (8, degree) [eA eB eC eD fA fB fC fD]
         ((6, degree) [eB eD fA fB fC fD] without observe and scores), or
         for multi-type systems (T+1, T+1, 8, degree), the 8 rows of each
         ordered type pair (ti, tj), zero where a state pair has no table
  out    (n_slots, 8) [fx fy fz lamf s0 s1 0 0]
  part   (n_slots, 8) [pe vxx vyy vzz vxy vxz vyz oob] per i-slot (observe)
  periodic  (x, y) bools, the column list's (``ColumnList.periodic``): on
         an axis that is not periodic (a spatial driver's virtual box) a
         stencil column outside the grid holds no candidate; K2–K6 take
         it alike
Rows of invalid i-slots are zero.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable

NSTEN = colpack.NSTEN
MAX_TYPES1 = 4       # T+1 of the per-type-pair rows the kernels stage
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


def dform_rows(ce: np.ndarray, ids) -> np.ndarray:
    """(8, degree) D-form rows [eA eB eC eD fA fB fC fD] in float64 from the
    raw rows ``ce`` (2T, degree), energies then forces, of the state pairs
    (00, 01, 10, 11) with table ids ``ids``: A = c00, B = c10 - c00,
    C = c01 - c00, D = (c11 - c01) - (c10 - c00), where a state pair
    without a table (id -1) has zero rows."""
    T = ce.shape[0] // 2
    zero = np.zeros(ce.shape[1])
    rows = []
    for base in (0, T):
        c00, c01, c10, c11 = (ce[base + int(i)] if i >= 0 else zero
                              for i in ids)
        rows += [c00, c10 - c00, c01 - c00, (c11 - c01) - (c10 - c00)]
    return np.stack(rows)


def dform_block(ce: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(T+1, T+1, 8, degree) D-form rows of every ordered type pair, from
    the (T+1, T+1, 4) table ids of their (00, 01, 10, 11) state pairs (the
    rows of a pair with type 0 are zero)."""
    t1 = ids.shape[0]
    if t1 > MAX_TYPES1:
        raise ValueError(f"{t1 - 1} types: the kernels stage the rows of at "
                         f"most {MAX_TYPES1 - 1}")
    block = np.zeros((t1, t1, 8, ce.shape[1]))
    for a in range(1, t1):
        for b in range(1, t1):
            block[a, b] = dform_rows(ce, ids[a, b])
    return block


def kernel_rows(cheb: ChebBank, tp, observe: bool, want_scores: bool,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """The kernel's coefficient rows, cached on the ChebBank: the 2x2 state
    basis change to D-form is taken on the coefficients in float64 (it
    costs nothing per candidate).  One actual type: the 8 rows (6 without
    observe and scores).  Several: the (T+1, T+1, 8, degree) rows of every
    ordered type pair."""
    device = cheb.coeffs.device if device is None else torch.device(device)
    key = (observe, want_scores, dtype, str(device))
    if key in cheb.kernel_rows:
        return cheb.kernel_rows[key]
    ce = cheb.coeffs.cpu().numpy().astype(np.float64)
    tab4 = tp.tab4.cpu().numpy()
    nt = tp.ntypes
    if nt == 1:
        coef = dform_rows(ce, tab4[1, 1].reshape(-1))
        if not (want_scores or observe):
            coef = coef[[1, 3, 4, 5, 6, 7]]
    else:
        coef = dform_block(ce, tab4.reshape(nt + 1, nt + 1, 4))
    out = torch.as_tensor(coef, dtype=dtype, device=device)
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
               observe: bool, every: bool = False,
               periodic: tuple = (True, True)):
    """The twins' walk over the column spans (shared by the twins of K1–K7).
    Each cluster's nine spans expand into a padded candidate index;
    clusters go in chunks of at most ``TWIN_CHUNK_ELEMS`` (i-row,
    candidate) pairs so 2^20-atom systems fit.  Yields, per chunk,
    ``(rows_slice, irows, jattr, dx, dy, dz, rsq, mask)``: ``irows`` the
    (C, 8, 8) i-slot rows, ``jattr(a)`` the (C, 1, K) candidate attribute
    a, and ``mask`` the pairs with 0 < rsq < cutsq from a real i-slot (and,
    with ``observe``, to a valid j-slot); with ``every``, every candidate
    of a real i-slot, with no distance test.  ``periodic`` (x, y): on an
    axis that is not, a stencil column outside the grid holds no
    candidate, whatever its span says (the kernels' rule)."""
    dev, dt = ipack.device, ipack.dtype
    ncol, cpc, _ = z0.shape
    czp = cols.shape[2]
    nclus = ncol * cpc
    sten_np, sx_np, sy_np = colpack.stencil(mx, my, *periodic)
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
        s_c = s_of.clamp(max=NSTEN - 1)
        colc = (torch.arange(c0, c1, device=dev) // cpc)[:, None]
        live = (s_of < NSTEN) & (sten[colc, s_c] >= 0)
        jslot = (starts.gather(1, s_c) + kk[None, :]
                 - (cum - lens).gather(1, s_c))
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


def pair_channels(coef, u, irows, jattr, degree: int):
    """(eA, eB, eC, eD, fA, fB, fC, fD) in D-form at u, by the kernels'
    recurrence: from the one set of rows (eA = eC = None with the 6-row
    set) or, with the (T+1, T+1, 8, degree) block, from the rows of each
    candidate's ordered type pair (ti, tj), gathered per coefficient."""
    if coef.dim() == 2:
        return typed_channels(coef, u, None, None, degree)
    return typed_channels(coef, u, irows[:, :, 7:8], jattr(7), degree)


def typed_channels(coef, u, ti, tj, degree: int):
    """:func:`pair_channels` with the partners' types given directly (``ti``
    and ``tj`` broadcast to u's shape; unused with one set of rows)."""
    if coef.dim() == 2:
        acc = series(coef, u, degree)
        if len(acc) == 8:
            return tuple(acc)
        eB, eD, fA, fB, fC, fD = acc
        return None, eB, None, eD, fA, fB, fC, fD
    t1 = coef.shape[0]
    flat = coef.reshape(t1 * t1, 8, degree)
    pair = (ti.long().clamp(0, t1 - 1) * t1
            + tj.long().clamp(0, t1 - 1))                      # u's shape

    def c(r, k):
        return flat[:, r, k][pair]

    acc = [c(r, 0) + c(r, 1) * u for r in range(8)]
    u2, tm2, tm1 = u + u, torch.ones_like(u), u
    for k in range(2, degree):
        tk = u2 * tm1 - tm2
        for r in range(8):
            acc[r] = acc[r] + c(r, k) * tk
        tm2, tm1 = tm1, tk
    return tuple(acc)


def observed(emix, fmix, dx, dy, dz, mask, rsq, innersq):
    """(C*8, 8) partial rows [pe vxx vyy vzz vxy vxz vyz oob] of a chunk;
    ``emix`` and ``fmix`` are already zero outside ``mask``."""
    p = [torch.sum(emix, -1)]
    for a, b in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz), (dy, dz)):
        p.append(torch.sum(fmix * a * b, -1))
    p.append(torch.sum((mask & (rsq < innersq)).to(emix.dtype), -1))
    return torch.stack(p, -1).reshape(-1, 8)


def ucgld_pair_reference(scal, z0, span_len, ipack, cols, coef, *,
                         mx: int, my: int, degree: int, observe: bool,
                         want_scores: bool, periodic: tuple = (True, True)):
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
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe,
            periodic=periodic):
        # lower clamp only; past-cutoff lanes may run to inf/NaN and are
        # selected out below
        u = torch.clamp(rsq * uscale + uoff, min=-1.0)
        eA, eB, eC, eD, fA, fB, fC, fD = pair_channels(
            coef, u, irows, jattr, degree)
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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p, ctypes.c_int])
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


def coef_shape(coef, degree: int, nrow: int):
    """(shape, T+1) the kernels take for ``coef``: the per-type-pair block
    of T+1 <= MAX_TYPES1, or one set of ``nrow`` rows (T+1 given as 0)."""
    if coef.dim() == 4:
        t1 = coef.shape[0]
        if not 2 <= t1 <= MAX_TYPES1:
            raise ValueError(f"{t1 - 1} types: the kernels stage the rows of "
                             f"at most {MAX_TYPES1 - 1}")
        return (t1, t1, 8, degree), t1
    return (nrow, degree), 0


def periodic_bits(periodic) -> int:
    """The kernels' ``periodic`` argument: bit 0 x, bit 1 y."""
    return int(bool(periodic[0])) | (int(bool(periodic[1])) << 1)


def _launch_cuda(scal, z0, span_len, ipack, cols, coef, *, mx, my, degree,
                 observe, want_scores, periodic=(True, True)):
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    if not 2 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [2, {MAX_DEGREE}]")
    shape, ntypes1 = coef_shape(coef, degree,
                                8 if (observe or want_scores) else 6)
    _check(scal, "scal", f32, (8,), dev)
    _check(z0, "z0", i32, (ncol, cpc, NSTEN), dev)
    _check(span_len, "L", i32, (ncol, cpc, NSTEN), dev)
    _check(ipack, "ipack", f32, (n_slots, 8), dev)
    _check(cols, "cols", f32, (ncol, 8, czp), dev)
    _check(coef, "coef", f32, shape, dev)
    out = torch.empty((n_slots, 8), dtype=f32, device=dev)
    part = (torch.empty((n_slots, 8), dtype=f32, device=dev) if observe
            else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
                    ipack.data_ptr(), cols.data_ptr(), coef.data_ptr(),
                    out.data_ptr(), part.data_ptr() if observe else None,
                    n_slots, mx, my, cz, czp, degree, ntypes1,
                    int(observe), int(want_scores), int(ntypes1 > 0),
                    stream, periodic_bits(periodic))
    if rc != 0:
        raise RuntimeError(f"ucgld_pair kernel launch failed: CUDA error {rc}")
    ucgld_pair.launches[variant(observe, want_scores)] += 1
    return out, part


def ucgld_pair(scal, z0, span_len, ipack, cols, coef, *, mx: int, my: int,
               degree: int, observe: bool, want_scores: bool,
               periodic: tuple = (True, True)):
    """K1: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, degree=degree, observe=observe,
              want_scores=want_scores, periodic=periodic)
    if ipack.is_cuda:
        return _launch_cuda(scal, z0, span_len, ipack, cols, coef, **kw)
    if ipack.device.type == "cpu":
        return ucgld_pair_reference(scal, z0, span_len, ipack, cols, coef,
                                    **kw)
    raise ValueError(f"no K1 implementation for device {ipack.device}")


ucgld_pair.launches = {"full": 0, "fast": 0, "noscores": 0}


# ---- ForceOut-compatible wrappers --------------------------------------------

def kernel_inputs(state: SimState, cl: colpack.ColumnList,
                  params: UCGLDParams, cheb: ChebBank, observe: bool,
                  want_scores: bool, slot: bool = False):
    """(args, kwargs) of :func:`ucgld_pair` for one pair evaluation;
    ``slot``: ``state`` is slot-resident (``colpack.pack``'s ``slot``)."""
    tp = params.tp
    f32 = torch.float32
    is_ucg = tp.n_states[state.typ] > 1
    # non-UCG atoms carry λ-weight [1, 0]: zero their packed λ
    lam_eff = torch.where(is_ucg, state.ucgl, torch.zeros_like(state.ucgl))
    multi = tp.ntypes > 1
    ipack, cols = colpack.pack(cl, state.box, state.x, lam_eff,
                               state.ucgstate, dtype=f32,
                               typ=state.typ if multi else None, slot=slot)
    coef = kernel_rows(cheb, tp, observe, want_scores, f32, state.device)
    scal = kernel_scalars(state.box, params, cheb, f32)
    return ((scal, cl.z0, cl.L, ipack, cols, coef),
            dict(mx=cl.mx, my=cl.my, periodic=cl.periodic,
                 degree=cheb.degree, observe=observe,
                 want_scores=want_scores))


def compute(state: SimState, cl: colpack.ColumnList, params: UCGLDParams,
            cheb: ChebBank, observe: bool = True, want_scores: bool = True,
            slot: bool = False) -> ForceOut:
    """Pair evaluation through K1.  ``observe=False`` is the fast variant
    (pe/virial/oob come back 0) for interior MD steps; ``want_scores=False``
    also drops the score tallies (scores come back 0) — valid only when
    scores have no dynamical feedback (``Simulation`` gates this).
    ``slot``: ``state`` is slot-resident and so is the result."""
    args, kw = kernel_inputs(state, cl, params, cheb, observe, want_scores,
                             slot)
    out, part = ucgld_pair(*args, **kw)
    return force_out(out, part, state, cl, params, observe, want_scores,
                     slot)


def force_out(out, part, state: SimState, cl: colpack.ColumnList,
              params: UCGLDParams, observe: bool, want_scores: bool,
              slot: bool = False) -> ForceOut:
    """Kernel outputs → ForceOut: the slot→atom take (none when ``slot``:
    the rows stay in slot order), the chemical-potential and 1/kT terms,
    and pe/virial halved (full list, newton off)."""
    n = state.n_atoms
    tp = params.tp
    f32 = torch.float32
    dev = state.device
    is_ucg = tp.n_states[state.typ] > 1
    out_at = out if slot else out[cl.atom_slot]                  # (N, 8)
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


def compute_style_slot_fast(state: SimState, cl: colpack.ColumnList,
                            params: UCGLDParams) -> ForceOut:
    """Slot-resident interior-step variant (observe=False)."""
    return compute(state, cl, params, params.cheb, observe=False, slot=True)


def compute_style_slot_fast_noscores(state: SimState, cl: colpack.ColumnList,
                                     params: UCGLDParams) -> ForceOut:
    """Slot-resident interior-step variant without score tallies."""
    return compute(state, cl, params, params.cheb, observe=False,
                   want_scores=False, slot=True)


compute_style.fast_variant = compute_style_fast
compute_style.fast_variant_noscores = compute_style_fast_noscores
compute_style.slot_fast = compute_style_slot_fast
compute_style.slot_fast_noscores = compute_style_slot_fast_noscores


# ---- special exclusions: compute and subtract ------------------------------

def excl_geometry(state: SimState, jrows: torch.Tensor, cutsq):
    """(jc, dr, rsq, mask) of the (N, S) partner lists ``jrows`` (row
    indices, == N where empty) in the kernels' float32: the minimum-image
    displacements, their squares and 0 < rsq < cutsq of a listed
    partner; ``jc`` the partner rows with empty entries at 0."""
    f32 = torch.float32
    n = state.n_atoms
    ok = jrows < n
    jc = torch.where(ok, jrows, 0)
    x = state.x.to(f32)
    box = dataclasses.replace(state.box, lo=state.box.lo.to(f32),
                              hi=state.box.hi.to(f32))
    dr = box.min_image(x[:, None, :] - x[jc])                   # (N, S, 3)
    rsq = torch.sum(dr * dr, dim=-1)
    mask = ok & (rsq < cutsq.to(f32)) & (rsq > 0.0)
    return jc, dr, rsq, mask


def excl_channels(state: SimState, jrows: torch.Tensor, params, coef):
    """Geometry and D-form channels of the (N, S) partner lists ``jrows``
    (row indices, == N where empty) in K1's arithmetic: float32, the u map
    of :func:`u_map` clamped below at -1 only, the kernels' recurrence
    (:func:`series`, or the rows of each ordered type pair of the
    (T+1, T+1, 8, degree) block).  ``coef``: K1's 8 rows or that block
    (:func:`kernel_rows` with observe and scores).  Returns (jc, dr, rsq,
    mask, (eA, eB, eC, eD, fA, fB, fC, fD)); mask is 0 < rsq < cutsq of a
    listed partner."""
    f32 = torch.float32
    cheb = params.cheb
    jc, dr, rsq, mask = excl_geometry(state, jrows, params.tp.cutsq[1, 1])
    uscale, uoff = u_map(cheb, f32)
    u = torch.clamp(rsq * uscale + uoff, min=-1.0)
    typ = state.typ.long()
    ch = typed_channels(coef, u, typ[:, None], typ[jc], cheb.degree)
    return jc, dr, rsq, mask, ch


def excl_out(state: SimState, params, dr, rsq, mask, fmix, emix, s0, s1,
             ucgforce) -> ForceOut:
    """ForceOut of a pair sum over listed partners (``fmix``/``emix`` zero
    outside ``mask``; ``s0``/``s1`` the score sums before 1/kT): f, scores
    (UCG atoms), pe and virial halved as the kernel path halves them, and
    the inner-cutoff count."""
    f32 = torch.float32
    is_ucg = params.tp.n_states[state.typ.long()] > 1
    scores = torch.stack([s0, s1], dim=1) / params.kT.to(f32)
    dx, dy, dz = dr[..., 0], dr[..., 1], dr[..., 2]
    innersq = params.bank.innersq[0].to(f32)
    return ForceOut(
        f=torch.sum(fmix[..., None] * dr, dim=1), ucgforce=ucgforce,
        scores=torch.where(is_ucg[:, None], scores, 0.0),
        pe=0.5 * torch.sum(emix),
        virial=0.5 * torch.stack([
            torch.sum(fmix * a * b)
            for a, b in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz),
                         (dy, dz))]),
        oob_low=torch.sum(mask & (rsq < innersq)).to(torch.int32),
        oob_high=torch.zeros((), dtype=torch.int32, device=state.device))


def excl_delta(state: SimState, jrows: torch.Tensor,
               params: UCGLDParams) -> ForceOut:
    """The pair contributions of the special-exclusion lists ``jrows``
    ((N, S) row indices, == N where empty), in K1's own functional: the
    same f32 D-form rows (:func:`kernel_rows`), recurrence, ``max(u, -1)``
    clamp, cutoff test and λ/state mixing as the kernel (ucgld_phys.cuh)
    and its twin.  So ``K1(all pairs) - excl_delta`` cancels each excluded
    pair to f32 rounding, also where bonded partners sit below the tables'
    inner bound and the fit is extrapolated (an evaluation from the tables
    would leave the fit-table difference on every bond).  Without the μ
    and -μ/kT terms, which the kernel path adds once per atom.  Plain
    PyTorch, O(N·S)."""
    f32 = torch.float32
    tp = params.tp
    coef = kernel_rows(params.cheb, tp, True, True, f32, state.device)
    jc, dr, rsq, mask, (eA, eB, eC, eD, fA, fB, fC, fD) = excl_channels(
        state, jrows, params, coef)
    is_ucg = tp.n_states[state.typ.long()] > 1
    lam = torch.where(is_ucg, state.ucgl, 0.0).to(f32)
    li, lj = lam[:, None], lam[jc]
    sj = state.ucgstate[jc].to(f32)
    zero = torch.zeros((), dtype=f32, device=state.device)
    wD = li * lj
    fmix = torch.where(mask, fA + li * fB + lj * fC + wD * fD, zero)
    emix = torch.where(mask, eA + li * eB + lj * eC + wD * eD, zero)
    lamf = -torch.sum(torch.where(mask, eB + lj * eD, zero), dim=1)
    s0 = -torch.sum(torch.where(mask, eA + sj * eC, zero), dim=1)
    s1 = -torch.sum(torch.where(mask, (eA + eB) + sj * (eC + eD), zero),
                    dim=1)
    return excl_out(state, params, dr, rsq, mask, fmix, emix, s0, s1,
                    torch.where(is_ucg, lamf, zero))


compute_style.excl_delta = excl_delta
