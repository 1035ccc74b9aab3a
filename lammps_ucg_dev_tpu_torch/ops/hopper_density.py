"""K3 — the ``table_ucg_bethe_density`` pair pass over column spans, its
wrappers, and the three-pass kernel path of the style (port of
``compute_density`` and the ``style="dbethe"`` path of
``lammps_ucg_dev_tpu/ops/pallas_pair.py``).

* :func:`dbethe_pair` is K3's wrapper.  On CUDA tensors it launches the
  hand-written Hopper kernel (the ``kDBethe`` style of ``csrc/bethe_pair.cu``,
  built at its first launch, ops/cuda_lib.py) or raises; on CPU tensors it
  runs :func:`dbethe_pair_reference`, the kernel's plain PyTorch twin.
  ``dbethe_pair.launches`` counts kernel launches per variant.
* :func:`compute_density` is the ForceOut-compatible evaluation on a column
  list, the reference's three loops (pair_table_ucg_bethe_density.cpp
  :219-255, 528-658, 698-733): K5 (ρ, n_real) → priors and one-body terms →
  K3 (Bethe mixing, prior-force tallies, scores) → the posterior and the CV
  weights → K6 (the CV back-force).
* :func:`compute_style_density` (+ ``.fast_variant`` /
  ``.fast_variant_noscores``, ``.slot_fast`` / ``.slot_fast_noscores``)
  is the ``Simulation`` pair entry.  The atom-ordered entries take the
  special-exclusion lists (``excl_rows=``, subtracted pass by pass, since
  ρ feeds the priors; ``takes_excl_rows``) and a spatial driver's halo exchange (``xchg=``,
  ``supports_halo_xchg``).  The score-free variants return
  ``ucgp=None``, so the driver keeps the carried posterior.  With
  ``slot=True`` the state is slot-resident (``Simulation``'s slot-major
  interior): ρ, the priors and the CV weights stay in slot order between
  the passes, each pass packs through ``colpack.pack_slots``, and the
  ForceOut rows, the in-pass posterior included, come back in slot
  order.

K3's contract (the CUDA kernel and the twin) — K2's (ops/hopper_bethe.py)
with ipack attr 6 and the candidates' attr 3 both the density prior
P(state 1) (0 for plain types), and
  out    (n_slots, 8) [fx fy fz pf0 s0 s1 pf1 0] (scores 0 without them)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import common
from lammps_ucg_dev_tpu_torch.models import pair_bethe_density as pbd
from lammps_ucg_dev_tpu_torch.models.pair_bethe_density import (
    BetheDensityParams)
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable

P_LOG_FLOOR = 1e-12
STYLE_DBETHE, STYLE_RLEUCG = 1, 2      # csrc/bethe_pair.cu Style


def supports_density(params) -> bool:
    """Static eligibility (``pallas_pair.supports_density``): K2's scope
    (a fittable bank, plain or 2-state types with at least one UCG type,
    one shared cutoff, at most 8 tables and 3 actual types) and the
    conservative pair-CV mode ("reference" runs on the reference path)."""
    if not isinstance(params, BetheDensityParams):
        return False
    if params.pair_cv != "conservative":
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


def variant(observe: bool, want_scores: bool) -> str:
    if observe:
        if not want_scores:
            raise ValueError("the observing variant always tallies scores")
        return "full"
    return "fast" if want_scores else "fast_noscores"


# ---- the plain PyTorch twin ------------------------------------------------

def dbethe_pairs(ch, pi1, pj1, sj, jug, mask, kT, mf: bool,
                 want_scores: bool, observe: bool):
    """K3's terms on a batch of candidate pairs (any shape, pairs along the
    last axis): ``ch`` the D-form channels at u, ``pi1``/``pj1`` the
    partners' priors, ``sj`` the partner's state, ``jug`` whether its type
    has two states, ``mask`` the pairs that count.  Returns (fmix, emix,
    cols): emix None unless ``observe``; cols the five last-axis sums of
    out's columns 3–7, [-Σpf0, s0, s1, -Σpf1, 0].  The twin and the
    exclusion lists share it, so both are K3's arithmetic."""
    eA, eB, eC, eD, fA, fB, fC, fD = ch
    zero = torch.zeros((), dtype=fA.dtype, device=fA.device)

    def log_floor(v):
        return torch.log(torch.clamp(v, min=P_LOG_FLOOR))

    p11, xk, bb = hb.closed_form(eD, pi1, pj1, kT, mf)
    fmix = torch.where(mask, fA + pi1 * fB + pj1 * fC + p11 * fD, zero)
    lp0, lp1 = log_floor(1.0 - pi1), log_floor(pi1)
    if mf:
        lr = lp1 - lp0
    else:
        # stable ln(p11/p01) (pallas_pair.py:293-300)
        est = bb * (pj1 - pi1) + (1.0 - pi1 - pj1)
        dst = torch.sqrt(est * est + (4.0 * bb) * (pi1 * (1.0 - pi1)))
        lr = torch.where(est >= 0.0,
                         xk + log_floor(2.0 * pi1) - log_floor(est + dst),
                         log_floor(dst - est)
                         - log_floor(2.0 * (1.0 - pi1)))
    pf0 = torch.where(jug, zero, eA + kT * lp0)
    pf1 = torch.where(jug, (eB + eD) + kT * lr, (eA + eB) + kT * lp1)
    cols = [-torch.sum(torch.where(mask, pf0, zero), -1)]
    if want_scores:
        cols += [
            -torch.sum(torch.where(mask, eA + sj * eC, zero), -1),
            -torch.sum(torch.where(mask, (eA + eB) + sj * (eC + eD),
                                   zero), -1)]
    else:
        cols += [torch.zeros_like(cols[0])] * 2
    cols += [-torch.sum(torch.where(mask, pf1, zero), -1),
             torch.zeros_like(cols[0])]
    emix = (torch.where(mask, eA + pi1 * eB + pj1 * eC + p11 * eD, zero)
            if observe else None)
    return fmix, emix, cols


def dbethe_pair_reference(scal, z0, span_len, ipack, cols, coef, *,
                          mx: int, my: int, degree: int, ucg_mask: int,
                          observe: bool, mf: bool, want_scores: bool,
                          periodic: tuple = (True, True)):
    """Plain PyTorch version of K3 (same arguments, same outputs), computed
    in the tensors' dtype; the span walk, series and channels are K1's twin's
    (ops/hopper_pair.py), the closed form K2's (ops/hopper_bethe.py)."""
    variant(observe, want_scores)
    dev, dt = ipack.device, ipack.dtype
    n_slots = ipack.shape[0]
    out = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev) if observe else None
    innersq, uscale, uoff, kT = scal[3], scal[4], scal[5], scal[6]
    for sl, irows, jattr, dx, dy, dz, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe,
            periodic=periodic):
        u = torch.clamp(rsq * uscale + uoff, min=-1.0)
        ch = hp.pair_channels(coef, u, irows, jattr, degree)
        fmix, emix, tail = dbethe_pairs(
            ch, irows[:, :, 6:7], jattr(3), jattr(4),
            hb.partner_is_ucg(coef, jattr, ucg_mask), mask, kT, mf,
            want_scores, observe)
        out[sl] = torch.stack([torch.sum(fmix * dx, -1),
                               torch.sum(fmix * dy, -1),
                               torch.sum(fmix * dz, -1), *tail],
                              -1).reshape(-1, 8)
        if observe:
            part[sl] = hp.observed(emix, fmix, dx, dy, dz, mask, rsq, innersq)
    return out, part


# ---- the CUDA launch (K3 and K4 share the entry point) -------------------------

def _lib():
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib

    fn = cuda_lib.load("bethe_pair").lib.density_pair_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def launch_density_pair(style: int, scal, z0, span_len, ipack, cols, coef,
                        *, mx, my, degree, ucg_mask, observe, mf, scores,
                        feedback, periodic=(True, True)):
    """One launch of K3 (``style`` 1) or K4 (2) on CUDA tensors, after the
    same checks as K2's; returns (out, part)."""
    dev = ipack.device
    f32, i32 = torch.float32, torch.int32
    ncol, cpc, _ = z0.shape
    if ncol != mx * my:
        raise ValueError(f"span table has {ncol} columns, grid {mx}x{my}")
    cz = cpc * colpack.CL
    czp = cols.shape[2]
    n_slots = ncol * cz
    if style == STYLE_RLEUCG and coef.dim() != 4:
        raise ValueError("K4 takes the rows of each substate-type pair")
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
                    int(ucg_mask), style, int(observe), int(mf), int(scores),
                    int(feedback), int(ntypes1 > 0),
                    stream, hp.periodic_bits(periodic))
    if rc != 0:
        raise RuntimeError(f"density pair kernel launch failed: CUDA error "
                           f"{rc}")
    return out, part


def dbethe_pair(scal, z0, span_len, ipack, cols, coef, *, mx: int, my: int,
                degree: int, ucg_mask: int, observe: bool, mf: bool,
                want_scores: bool, periodic: tuple = (True, True)):
    """K3: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, degree=degree, ucg_mask=ucg_mask,
              observe=observe, mf=mf, periodic=periodic)
    name = variant(observe, want_scores)
    if ipack.is_cuda:
        res = launch_density_pair(STYLE_DBETHE, scal, z0, span_len, ipack,
                                  cols, coef, scores=want_scores,
                                  feedback=False, **kw)
        dbethe_pair.launches[name] += 1
        return res
    if ipack.device.type == "cpu":
        return dbethe_pair_reference(scal, z0, span_len, ipack, cols, coef,
                                     want_scores=want_scores, **kw)
    raise ValueError(f"no K3 implementation for device {ipack.device}")


dbethe_pair.launches = {"full": 0, "fast": 0, "fast_noscores": 0}


# ---- the three passes ----------------------------------------------------------

def radius_by_type(params: BetheDensityParams) -> torch.Tensor:
    """(T+1,) proximity radius per type."""
    return params.tp.threshold_radius


def density_inputs(state: SimState, cl: colpack.ColumnList,
                   params: BetheDensityParams, cheb: ChebBank,
                   pi1: torch.Tensor, observe: bool, want_scores: bool,
                   slot: bool = False):
    """(args, kwargs) of :func:`dbethe_pair` for pass 2 on the density
    priors ``pi1`` (P(state 1) per atom); ``slot`` as in
    ``colpack.pack``."""
    tp = params.tp
    f32 = torch.float32
    multi = tp.ntypes > 1
    ipack, cols = colpack.pack(cl, state.box, state.x, pi1, state.ucgstate,
                               dtype=f32, aux=pi1,
                               typ=state.typ if multi else None, slot=slot)
    coef = hp.kernel_rows(cheb, tp, True, True, f32, state.device)
    scal = hb.kernel_scalars(state.box, params, cheb, f32)
    return ((scal, cl.z0, cl.L, ipack, cols, coef),
            dict(mx=cl.mx, my=cl.my, periodic=cl.periodic,
                 degree=cheb.degree, ucg_mask=hb.ucg_mask(tp),
                 observe=observe,
                 mf=params.method == "mf", want_scores=want_scores))


def totals(part2, part3, observe: bool, device, less2=None, less3=None):
    """(pe, virial, oob_low) from the pair pass's and the CV pass's
    per-slot rows, halved (full list, newton off); ``less2``/``less3``
    (8,) sums of the same rows to take off (the special pairs)."""
    f32 = torch.float32
    if not observe:
        return (torch.zeros((), dtype=f32, device=device),
                torch.zeros(6, dtype=f32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    tot2, tot3 = part2.sum(0), part3.sum(0)
    if less2 is not None:
        tot2, tot3 = tot2 - less2, tot3 - less3
    return (0.5 * tot2[0], 0.5 * (tot2[1:7] + tot3[1:7]),
            tot2[7].to(torch.int32))


def excl_dbethe(state: SimState, jrows: torch.Tensor,
                params: BetheDensityParams, cheb: ChebBank, pi1: torch.Tensor,
                observe: bool, want_scores: bool):
    """K3's output rows over the (N, S) special-partner lists ``jrows``
    (row indices, == N where empty) at the priors ``pi1`` the pass packed:
    ((N, 8) out columns, (8,) per-slot sums or None unless ``observe``),
    through :func:`dbethe_pairs` on K3's float32 D-form rows and u map
    (``hopper_pair.excl_geometry``), for :func:`compute_density` to
    subtract."""
    f32 = torch.float32
    tp = params.tp
    jc, dr, rsq, mask = hp.excl_geometry(state, jrows, tp.cutsq[1, 1])
    uscale, uoff = hp.u_map(cheb, f32)
    u = torch.clamp(rsq * uscale + uoff, min=-1.0)
    coef = hp.kernel_rows(cheb, tp, True, True, f32, state.device)
    typ = state.typ.long()
    ch = hp.typed_channels(coef, u, typ[:, None], typ[jc], cheb.degree)
    p1 = pi1.to(f32)
    fmix, emix, tail = dbethe_pairs(
        ch, p1[:, None], p1[jc], state.ucgstate[jc].to(f32),
        tp.n_states[typ[jc]] > 1, mask, params.kT.to(f32),
        params.method == "mf", want_scores, observe)
    dx, dy, dz = dr[..., 0], dr[..., 1], dr[..., 2]
    out = torch.stack([torch.sum(fmix * dx, -1), torch.sum(fmix * dy, -1),
                       torch.sum(fmix * dz, -1), *tail], -1)
    part = (hp.observed(emix, fmix, dx, dy, dz, mask, rsq,
                        params.bank.innersq[0].to(f32)).sum(0)
            if observe else None)
    return out, part


def compute_density(state: SimState, cl: colpack.ColumnList,
                    params: BetheDensityParams, cheb: ChebBank,
                    observe: bool = True, want_scores: bool = True,
                    slot: bool = False, excl_rows: torch.Tensor | None = None,
                    xchg=None) -> ForceOut:
    """Pair evaluation through K5 → K3 → K6, with ``params`` as
    ``select_pair_kernel`` returns them (``cv_rad`` set).
    ``observe=False`` drops pe/virial/oob (they come back 0);
    ``want_scores=False`` also drops the scores, and ``ucgp`` is then None
    — valid only when nothing feeds the scores back (``Simulation`` gates
    this).  ``slot``: ``state`` is slot-resident and so is the result.

    ``excl_rows`` ((N, S) special partners as rows, N where empty): the
    kernels take every in-cutoff pair, so each pass's sums over the
    specials are subtracted after it (compute and subtract; the reference
    path leaves them out of its list): ρ and the count after K5, before
    the priors read them (:func:`hopper_cv.excl_rho`); K3's columns at
    those priors (:func:`excl_dbethe`); K6's back-force at the CV weights
    that follow (:func:`hopper_cv.excl_force`).  ``xchg``: a spatial
    driver's halo exchange of per-atom rows (ghost rows get their owners'
    values), applied to ρ after K5 and to the CV weights before K6."""
    tp = params.tp
    f32 = torch.float32
    dev = state.device
    typ = state.typ.long()
    n = state.n_atoms
    kT = params.kT.to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)
    is_ucg = tp.n_states[typ] > 1
    use_den = (tp.use_density[typ] == 1) & is_ucg
    cv_args = (params.cv_rad, tp.cutsq[1, 1], params.bank.innersq[0])

    # ---- pass 1: ρ and the real in-cutoff count (K5) ----------------------
    def rows(out):
        return out if slot else out[cl.atom_slot]

    args, kw = hcv.cv_inputs(state, cl, *cv_args, None, slot)
    at1 = rows(hcv.cv_rho(*args, **kw))
    rho, n_real = at1[:, 0], at1[:, 1]
    if excl_rows is not None:
        ex_rho, ex_n = hcv.excl_rho(state, excl_rows, *cv_args[:2])
        rho, n_real = rho - ex_rho, n_real - ex_n
    if xchg is not None:
        rho = xchg(rho)            # ghosts need their owners' densities
    prior, partial0 = pbd._priors(params, typ, rho)
    pi1 = prior[:, 1]
    one_body = pbd.one_body(params, typ,
                            torch.log(torch.clamp(prior, min=P_LOG_FLOOR)),
                            n_real)

    # ---- pass 2: Bethe mixing, prior forces, scores (K3) -----------------
    args, kw = density_inputs(state, cl, params, cheb, pi1, observe,
                              want_scores, slot)
    out2, part2 = dbethe_pair(*args, **kw)
    at2 = rows(out2)
    less2 = less3 = None
    if excl_rows is not None:
        ex2, less2 = excl_dbethe(state, excl_rows, params, cheb, pi1, observe,
                                 want_scores)
        at2 = at2 - ex2
    pforce = torch.stack([at2[:, 3], at2[:, 6]], dim=-1)
    pforce = torch.where(use_den[:, None], pforce + one_body, zero)
    if want_scores:
        mu_i = tp.mu[tp.formal[typ].long()].to(f32)
        scores = at2[:, 4:6] / kT - torch.where(use_den[:, None], mu_i / kT,
                                                zero)
        scores = torch.where(is_ucg[:, None], scores, zero)
        ucgp = common.softmax_posterior(scores, is_ucg)
    else:
        scores = torch.zeros((n, 2), dtype=f32, device=dev)
        ucgp = None

    # ---- pass 3: the CV back-force (K6) -----------------------------------
    cvf = pforce[:, 0] * partial0 - pforce[:, 1] * partial0
    cvf = torch.where(use_den, cvf, zero)
    if xchg is not None:
        cvf = xchg(cvf)            # ghost CV weights from their owners
    gform = "mder" if params.backforce_derivative else "w"
    args, kw = hcv.cv_inputs(state, cl, *cv_args, cvf, slot)
    out3, part3 = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    f3 = rows(out3)[:, 0:3]
    if excl_rows is not None:
        ex3, less3 = hcv.excl_force(state, excl_rows, *cv_args[:2], cvf,
                                    gform, observe)
        f3 = f3 - ex3
    pe, virial, oob_low = totals(part2, part3, observe, dev, less2, less3)
    return ForceOut(f=at2[:, 0:3] + f3,
                    ucgforce=torch.zeros(n, dtype=f32, device=dev),
                    scores=scores, pe=pe, virial=virial, oob_low=oob_low,
                    oob_high=torch.zeros((), dtype=torch.int32, device=dev),
                    ucgp=ucgp)


def compute_style_density(state: SimState, cl: colpack.ColumnList,
                          params: BetheDensityParams,
                          excl_rows: torch.Tensor | None = None,
                          xchg=None) -> ForceOut:
    """Simulation pair entry: reads the ChebBank from ``params.cheb``."""
    return compute_density(state, cl, params, params.cheb,
                           excl_rows=excl_rows, xchg=xchg)


def compute_style_density_fast(state: SimState, cl: colpack.ColumnList,
                               params: BetheDensityParams,
                               excl_rows: torch.Tensor | None = None,
                               xchg=None) -> ForceOut:
    """Interior-step variant: no energy/virial/oob (observe=False)."""
    return compute_density(state, cl, params, params.cheb, observe=False,
                           excl_rows=excl_rows, xchg=xchg)


def compute_style_density_fast_noscores(state: SimState,
                                        cl: colpack.ColumnList,
                                        params: BetheDensityParams,
                                        excl_rows: torch.Tensor | None = None,
                                        xchg=None) -> ForceOut:
    """Interior-step variant without scores (ucgp None) — selected by the
    ``Simulation`` only when no ``fix ucgstate`` reads them."""
    return compute_density(state, cl, params, params.cheb, observe=False,
                           want_scores=False, excl_rows=excl_rows, xchg=xchg)


def compute_style_density_slot_fast(state: SimState, cl: colpack.ColumnList,
                                    params: BetheDensityParams) -> ForceOut:
    """Slot-resident interior-step variant (observe=False)."""
    return compute_density(state, cl, params, params.cheb, observe=False,
                           slot=True)


def compute_style_density_slot_fast_noscores(state: SimState,
                                             cl: colpack.ColumnList,
                                             params: BetheDensityParams
                                             ) -> ForceOut:
    """Slot-resident interior-step variant without scores (ucgp None)."""
    return compute_density(state, cl, params, params.cheb, observe=False,
                           want_scores=False, slot=True)


compute_style_density.fast_variant = compute_style_density_fast
compute_style_density.fast_variant_noscores = (
    compute_style_density_fast_noscores)
compute_style_density.slot_fast = compute_style_density_slot_fast
compute_style_density.slot_fast_noscores = (
    compute_style_density_slot_fast_noscores)
compute_style_density.takes_excl_rows = True
for _fn in (compute_style_density, compute_style_density_fast,
            compute_style_density_fast_noscores):
    _fn.supports_halo_xchg = True
