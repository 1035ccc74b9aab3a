"""K2 — the ``table_ucg_bethe`` pair kernel over column spans, and its
wrappers (port of ``compute_bethe`` and the ``style="bethe"`` path of
``lammps_ucg_dev_tpu/ops/pallas_pair.py``).

* :func:`bethe_pair` is the kernel's wrapper.  On CUDA tensors it launches
  the hand-written Hopper kernel ``csrc/bethe_pair.cu`` (built at its first
  launch, ops/cuda_lib.py) or raises; on CPU tensors it runs
  :func:`bethe_pair_reference`, the kernel's plain PyTorch twin.
  ``bethe_pair.launches`` counts kernel launches per variant.
* :func:`compute_bethe` is the ForceOut-compatible pair evaluation on a
  column list: priors → pack → kernel → slot→atom take → the
  chemical-potential score term and 1/kT, with pe and virial halved (full
  list, newton off).  With ``slot=True`` the state is slot-resident
  (``Simulation``'s slot-major interior): ``colpack.pack_slots`` fills the
  kernel's inputs and the rows come back in slot order, with no take.
* :func:`compute_style_bethe` (+ ``.fast_variant``, ``.slot_fast``,
  ``.excl_delta``) is the ``Simulation`` pair entry.  There is no
  score-free variant: under ``fix ucgstate`` the scores feed the next
  step's priors.
* :func:`excl_delta_bethe` is the pair contribution of the
  special-exclusion lists in K2's own functional, which the driver
  subtracts from the kernel's output.

Kernel contract (both the CUDA kernel and the twin) — K1's
(ops/hopper_pair.py), except:
  scal   (8,) f32   [Lx Ly cutsq innersq uscale uoff kT 0]
  ipack  (n_slots, 8) f32 [x y z pj1 state valid pi1 typ]
  cols   (ncol, 8, czp) f32 the same attributes over the extended slots
  coef   the 8 D-form rows [eA eB eC eD fA fB fC fD], or for several actual
         types the (T+1, T+1, 8, degree) rows of each ordered type pair
  ucg_mask  int, bit t set when actual type t is a 2-state UCG type (the
         full-SCE scores treat partners of plain types apart)
  out    (n_slots, 8) [fx fy fz 0 s0 s1 0 0]
  part   (n_slots, 8) [pe vxx vyy vzz vxy vxz vyz oob] per i-slot (observe)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import pair_bethe
from lammps_ucg_dev_tpu_torch.models.pair_bethe import BetheParams
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable

XK_MAX = 40.0        # f32 clamp of -J/kT (the TPU kernel's, not the -700)
SMALL_A = 1e-5       # |aa| below this: p11 = pi1·pj1
P_FLOOR = 1e-6       # full-SCE conditional denominators


def supports_bethe(params) -> bool:
    """Static eligibility (``pallas_pair.supports_bethe``): a
    Chebyshev-fittable bank, every type plain or 2-state with at least one
    UCG type, one shared cutoff, at most 8 tables and 3 actual types; both
    methods and both score modes."""
    if not isinstance(params, BetheParams):
        return False
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


def variant(observe: bool) -> str:
    return "full" if observe else "fast"


def ucg_mask(tp) -> int:
    """Bit t set when actual type t has two states."""
    ns = tp.n_states.cpu().numpy()
    return int(sum(1 << t for t in range(1, len(ns)) if ns[t] > 1))


def kernel_scalars(box, params: BetheParams, cheb: ChebBank,
                   dtype=torch.float32) -> torch.Tensor:
    """K1's scalars with kT in slot 6."""
    scal = hp.kernel_scalars(box, params, cheb, dtype).clone()
    scal[6] = params.kT.to(dtype)
    return scal


# ---- the plain PyTorch twin ------------------------------------------------

def closed_form(eD, pi1, pj1, kT, mf: bool):
    """(p11, xk, bb) of the kernels' f32 closed form: xk = min(-eD/kT, 40),
    bb = exp(xk), the root picked by the sign of Q, pi1·pj1 when
    |bb - 1| < 1e-5 or with ``mf`` (then xk and bb are None)."""
    pipj = pi1 * pj1
    if mf:
        return pipj, None, None
    xk = torch.clamp(-eD / kT, max=XK_MAX)
    bb = torch.exp(xk)
    aa = bb - 1.0
    Q = (pi1 + pj1) * aa + 1.0
    D = torch.clamp(Q * Q - 4.0 * aa * bb * pipj, min=0.0)
    sqD = torch.sqrt(D)
    small = torch.abs(aa) < SMALL_A
    root_pos = 2.0 * bb * pipj / (Q + sqD)
    root_neg = (Q - sqD) / (2.0 * torch.where(small, torch.ones_like(aa), aa))
    p11 = torch.where(small, pipj, torch.where(Q < 0.0, root_neg, root_pos))
    return p11, xk, bb


def partner_is_ucg(coef, jattr, ucg_mask: int):
    """(C, 1, K) bool: the candidate's type has two states (its bit in
    ``ucg_mask``); every partner with one actual type (``coef`` the one
    set of rows, not the per-type-pair block)."""
    if coef.dim() == 2:
        return True
    t1 = coef.shape[0]
    ucg_t = torch.tensor([(ucg_mask >> t) & 1 > 0 for t in range(t1)],
                         device=coef.device)
    return ucg_t[jattr(7).long().clamp(0, t1 - 1)]


def bethe_pair_reference(scal, z0, span_len, ipack, cols, coef, *, mx: int,
                         my: int, degree: int, ucg_mask: int, observe: bool,
                         mf: bool, sce: bool, periodic: tuple = (True, True)):
    """Plain PyTorch version of the kernel (same arguments, same outputs),
    computed in the tensors' dtype; the span walk, series and channels are
    K1's twin's (ops/hopper_pair.py)."""
    dev, dt = ipack.device, ipack.dtype
    n_slots = ipack.shape[0]
    out = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev) if observe else None
    innersq, uscale, uoff, kT = scal[3], scal[4], scal[5], scal[6]
    zero = torch.zeros((), dtype=dt, device=dev)
    for sl, irows, jattr, dx, dy, dz, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe,
            periodic=periodic):
        u = torch.clamp(rsq * uscale + uoff, min=-1.0)
        eA, eB, eC, eD, fA, fB, fC, fD = hp.pair_channels(
            coef, u, irows, jattr, degree)
        pi1, pj1 = irows[:, :, 6:7], jattr(3)
        p11 = closed_form(eD, pi1, pj1, kT, mf)[0]
        fmix = torch.where(mask, fA + pi1 * fB + pj1 * fC + p11 * fD, zero)
        if sce:
            p0e = torch.clamp(1.0 - pi1, min=P_FLOOR)
            p1e = torch.clamp(pi1, min=P_FLOOR)
            p00 = 1.0 + p11 - pi1 - pj1
            c00, c01 = p00 / p0e, (pj1 - p11) / p0e
            c10, c11 = (pi1 - p11) / p1e, p11 / p1e
            sc0 = c00 * eA + c01 * (eA + eC)
            sc1 = c10 * (eA + eB) + c11 * ((eA + eB) + (eC + eD))
            if coef.dim() == 4:
                jug = partner_is_ucg(coef, jattr, ucg_mask)
                sc0 = torch.where(jug, sc0, eA)
                sc1 = torch.where(jug, sc1, eA + eB)
        else:
            sj = jattr(4)
            sc0, sc1 = eA + sj * eC, (eA + eB) + sj * (eC + eD)
        s0 = -torch.sum(torch.where(mask, sc0, zero), -1)
        s1 = -torch.sum(torch.where(mask, sc1, zero), -1)
        zc = torch.zeros_like(s0)
        out[sl] = torch.stack([torch.sum(fmix * dx, -1),
                               torch.sum(fmix * dy, -1),
                               torch.sum(fmix * dz, -1), zc, s0, s1, zc, zc],
                              -1).reshape(-1, 8)
        if observe:
            emix = torch.where(mask, eA + pi1 * eB + pj1 * eC + p11 * eD, zero)
            part[sl] = hp.observed(emix, fmix, dx, dy, dz, mask, rsq, innersq)
    return out, part


# ---- the CUDA launch ---------------------------------------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    fn = cuda_lib.load("bethe_pair").lib.bethe_pair_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _launch_cuda(scal, z0, span_len, ipack, cols, coef, *, mx, my, degree,
                 ucg_mask, observe, mf, sce, periodic=(True, True)):
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    if not 2 <= degree <= hp.MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [2, {hp.MAX_DEGREE}]")
    shape, ntypes1 = hp.coef_shape(coef, degree, 8)
    hp._check(scal, "scal", f32, (8,), dev)
    hp._check(z0, "z0", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(span_len, "L", i32, (ncol, cpc, hp.NSTEN), dev)
    hp._check(ipack, "ipack", f32, (n_slots, 8), dev)
    hp._check(cols, "cols", f32, (ncol, 8, czp), dev)
    hp._check(coef, "coef", f32, shape, dev)
    out = torch.empty((n_slots, 8), dtype=f32, device=dev)
    part = (torch.empty((n_slots, 8), dtype=f32, device=dev) if observe
            else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
                    ipack.data_ptr(), cols.data_ptr(), coef.data_ptr(),
                    out.data_ptr(), part.data_ptr() if observe else None,
                    n_slots, mx, my, cz, czp, degree, ntypes1,
                    int(ucg_mask), int(observe), int(mf), int(sce),
                    int(ntypes1 > 0), stream,
                    hp.periodic_bits(periodic))
    if rc != 0:
        raise RuntimeError(f"bethe_pair kernel launch failed: CUDA error {rc}")
    bethe_pair.launches[variant(observe)] += 1
    return out, part


def bethe_pair(scal, z0, span_len, ipack, cols, coef, *, mx: int, my: int,
               degree: int, ucg_mask: int, observe: bool, mf: bool,
               sce: bool, periodic: tuple = (True, True)):
    """K2: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, degree=degree, ucg_mask=ucg_mask,
              observe=observe, mf=mf, sce=sce, periodic=periodic)
    if ipack.is_cuda:
        return _launch_cuda(scal, z0, span_len, ipack, cols, coef, **kw)
    if ipack.device.type == "cpu":
        return bethe_pair_reference(scal, z0, span_len, ipack, cols, coef,
                                    **kw)
    raise ValueError(f"no K2 implementation for device {ipack.device}")


bethe_pair.launches = {"full": 0, "fast": 0}


# ---- ForceOut-compatible wrappers --------------------------------------------

def kernel_inputs(state: SimState, cl: colpack.ColumnList,
                  params: BetheParams, cheb: ChebBank, observe: bool,
                  prior_u: torch.Tensor | None = None, slot: bool = False):
    """(args, kwargs) of :func:`bethe_pair` for one pair evaluation; the
    priors come from ``pair_bethe._priors`` as on the reference path.
    ``slot``: ``state`` is slot-resident (``colpack.pack``'s ``slot``)."""
    tp = params.tp
    f32 = torch.float32
    pi1, pj1 = pair_bethe._priors(state, params, prior_u)
    multi = tp.ntypes > 1
    ipack, cols = colpack.pack(cl, state.box, state.x, pj1, state.ucgstate,
                               dtype=f32, aux=pi1,
                               typ=state.typ if multi else None, slot=slot)
    coef = hp.kernel_rows(cheb, tp, True, True, f32, state.device)
    scal = kernel_scalars(state.box, params, cheb, f32)
    return ((scal, cl.z0, cl.L, ipack, cols, coef),
            dict(mx=cl.mx, my=cl.my, periodic=cl.periodic,
                 degree=cheb.degree, ucg_mask=ucg_mask(tp), observe=observe,
                 mf=params.method == "mf", sce=not params.pseudo))


def force_out(out, part, state: SimState, cl: colpack.ColumnList,
              params: BetheParams, observe: bool,
              slot: bool = False) -> ForceOut:
    """Kernel outputs → ForceOut: the slot→atom take (none when ``slot``),
    the chemical-potential score term −μ/kT (:155-162) and 1/kT, no
    λ-force, pe and virial halved (full list, newton off)."""
    tp = params.tp
    f32 = torch.float32
    dev = state.device
    typ = state.typ.long()
    is_ucg = tp.n_states[typ] > 1
    out_at = out if slot else out[cl.atom_slot]                  # (N, 8)
    kT = params.kT.to(f32)
    mu_i = tp.mu[tp.formal[typ].long()].to(f32)                 # (N, 2)
    scores = out_at[:, 4:6] / kT - mu_i / kT
    zero = torch.zeros((), dtype=f32, device=dev)
    scores = torch.where(is_ucg[:, None], scores, zero)
    if observe:
        totals = part.sum(0)
        pe = 0.5 * totals[0]
        virial = 0.5 * totals[1:7]
        oob_low = totals[7].to(torch.int32)
    else:
        pe = torch.zeros((), dtype=f32, device=dev)
        virial = torch.zeros(6, dtype=f32, device=dev)
        oob_low = torch.zeros((), dtype=torch.int32, device=dev)
    return ForceOut(f=out_at[:, 0:3],
                    ucgforce=torch.zeros(state.n_atoms, dtype=f32, device=dev),
                    scores=scores, pe=pe, virial=virial, oob_low=oob_low,
                    oob_high=torch.zeros((), dtype=torch.int32, device=dev))


def compute_bethe(state: SimState, cl: colpack.ColumnList,
                  params: BetheParams, cheb: ChebBank, observe: bool = True,
                  prior_u: torch.Tensor | None = None,
                  slot: bool = False) -> ForceOut:
    """Pair evaluation through K2.  ``observe=False`` is the fast variant
    (pe/virial/oob come back 0) for interior MD steps.  ``slot``: ``state``
    is slot-resident and so is the result."""
    args, kw = kernel_inputs(state, cl, params, cheb, observe, prior_u, slot)
    out, part = bethe_pair(*args, **kw)
    return force_out(out, part, state, cl, params, observe, slot)


def compute_style_bethe(state: SimState, cl: colpack.ColumnList,
                        params: BetheParams,
                        prior_u: torch.Tensor | None = None) -> ForceOut:
    """Simulation pair entry: reads the ChebBank from ``params.cheb``."""
    return compute_bethe(state, cl, params, params.cheb, prior_u=prior_u)


def compute_style_bethe_fast(state: SimState, cl: colpack.ColumnList,
                             params: BetheParams,
                             prior_u: torch.Tensor | None = None) -> ForceOut:
    """Interior-step variant: no energy/virial/oob (observe=False)."""
    return compute_bethe(state, cl, params, params.cheb, observe=False,
                         prior_u=prior_u)


def compute_style_bethe_slot_fast(state: SimState, cl: colpack.ColumnList,
                                  params: BetheParams,
                                  prior_u: torch.Tensor | None = None
                                  ) -> ForceOut:
    """Slot-resident interior-step variant (observe=False)."""
    return compute_bethe(state, cl, params, params.cheb, observe=False,
                         prior_u=prior_u, slot=True)


compute_style_bethe.fast_variant = compute_style_bethe_fast
compute_style_bethe.slot_fast = compute_style_bethe_slot_fast


def excl_delta_bethe(state: SimState, jrows: torch.Tensor,
                     params: BetheParams,
                     prior_u: torch.Tensor | None = None) -> ForceOut:
    """K2's counterpart of ``hopper_pair.excl_delta``: the closed-form
    two-point mixing over the special lists ``jrows`` with the priors the
    kernel path packs (``pair_bethe._priors``, the same ``prior_u``), the
    same f32 clamp of -J/kT at 40, the |aa| < 1e-5 branch
    (:func:`closed_form`), and both score modes, on K1's f32 D-form
    channels (``hopper_pair.excl_channels``).  Without the -μ/kT term,
    which the kernel path adds once per atom; no λ-force."""
    f32 = torch.float32
    tp = params.tp
    coef = hp.kernel_rows(params.cheb, tp, True, True, f32, state.device)
    jc, dr, rsq, mask, (eA, eB, eC, eD, fA, fB, fC, fD) = hp.excl_channels(
        state, jrows, params, coef)
    pi1_all, pj1_all = pair_bethe._priors(state, params, prior_u)
    zero = torch.zeros((), dtype=f32, device=state.device)
    pi1 = pi1_all.to(f32)[:, None]
    pj1 = torch.where(mask, pj1_all.to(f32)[jc], zero)
    p11 = closed_form(eD, pi1, pj1, params.kT.to(f32),
                      params.method == "mf")[0]
    fmix = torch.where(mask, fA + pi1 * fB + pj1 * fC + p11 * fD, zero)
    emix = torch.where(mask, eA + pi1 * eB + pj1 * eC + p11 * eD, zero)
    if params.pseudo:
        sj = state.ucgstate[jc].to(f32)
        sc0, sc1 = eA + sj * eC, (eA + eB) + sj * (eC + eD)
    else:
        # full-SCE conditional expectations (the kernel's sce branch)
        p0e = torch.clamp(1.0 - pi1, min=P_FLOOR)
        p1e = torch.clamp(pi1, min=P_FLOOR)
        p00 = 1.0 + p11 - pi1 - pj1
        sc0 = (p00 / p0e) * eA + ((pj1 - p11) / p0e) * (eA + eC)
        sc1 = (((pi1 - p11) / p1e) * (eA + eB)
               + (p11 / p1e) * ((eA + eB) + (eC + eD)))
        # a partner of a plain type keeps its one state
        jug = tp.n_states[state.typ.long()][jc] > 1
        sc0 = torch.where(jug, sc0, eA)
        sc1 = torch.where(jug, sc1, eA + eB)
    s0 = -torch.sum(torch.where(mask, sc0, zero), dim=1)
    s1 = -torch.sum(torch.where(mask, sc1, zero), dim=1)
    return hp.excl_out(state, params, dr, rsq, mask, fmix, emix, s0, s1,
                       torch.zeros(state.n_atoms, dtype=f32,
                                   device=state.device))


compute_style_bethe.excl_delta = excl_delta_bethe
