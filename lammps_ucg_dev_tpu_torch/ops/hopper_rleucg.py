"""K4 — the ``table_rleucg_interface`` pair pass over column spans, its
wrappers, and the three-pass kernel path of the style (port of
``compute_rleucg`` and the ``style="rleucg"`` path of
``lammps_ucg_dev_tpu/ops/pallas_pair.py``).

* :func:`rleucg_pair` is K4's wrapper.  On CUDA tensors it launches the
  hand-written Hopper kernel (the ``kRleucg`` style of
  ``csrc/bethe_pair.cu``) or raises; on CPU tensors it runs
  :func:`rleucg_pair_reference`, its plain PyTorch twin.
  ``rleucg_pair.launches`` counts kernel launches per variant.
* :func:`compute_rleucg` is the ForceOut-compatible evaluation on a column
  list, the reference's three loops (pair_table_rleucg_interface.cpp
  :231-276, 321-441, 444-502): K5 (ρ) → substate probabilities and
  one-body forces → K4 (mean-field mixing, feedback tally) → the CV
  weights → K6 (the CV back-force).
* :func:`compute_style_rleucg` (+ ``.fast_variant``, ``.slot_fast``) is
  the ``Simulation`` pair entry; its atom-ordered entries take
  ``excl_rows=`` (``takes_excl_rows``) and ``xchg=`` as P3's do
  (``hopper_density``).  With ``slot=True`` the state is
  slot-resident (``Simulation``'s slot-major interior): ρ, the
  probabilities and the CV weights stay in slot order between the passes,
  each pass packs through ``colpack.pack_slots``, and the ForceOut rows
  come back in slot order.

K4's contract — K2's (ops/hopper_bethe.py) over SUBSTATE types: attr 7 the
substate type, ipack attr 6 and the candidates' attr 3 the probability of
substate 1 (0 for single-state types), always the D-form rows of each
ordered substate-type pair, built from ``tabSS``, and
  out    (n_slots, 8) [fx fy fz pf0 0 0 0 0], pf0 = Σ eB + pj1·eD with
         ``feedback`` (else 0)
"""

from __future__ import annotations

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import pair_rleucg as pr4
from lammps_ucg_dev_tpu_torch.models.pair_rleucg import RLEUCGParams
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank, fittable


def supports_rleucg(params) -> bool:
    """Static eligibility (``pallas_pair.supports_rleucg``): two substates
    at most (the 2x2 D-form machinery), 1–3 substate types, a fittable
    bank of at most 8 tables with one shared cutoff, a known feedback
    mode."""
    if not isinstance(params, RLEUCGParams):
        return False
    if params.max_states != 2 or params.feedback not in pr4.FEEDBACK_MODES:
        return False
    S = params.cutsq.shape[0] - 1
    if not fittable(params.bank) or S < 1 or S > 3:
        return False
    cuts = params.cutsq.cpu().numpy()[1:, 1:]
    if not np.allclose(cuts, cuts[0, 0]):
        return False
    return params.bank.n_tables <= 8


def variant(observe: bool) -> str:
    return "full" if observe else "fast"


def kernel_rows(cheb: ChebBank, params: RLEUCGParams, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """(S+1, S+1, 8, degree): the D-form rows of each ordered substate-type
    pair from the table ids of ``tabSS`` (``_rleucg_classes``), taken in
    float64 (``hopper_pair.dform_block``), cached on the ChebBank."""
    device = cheb.coeffs.device if device is None else torch.device(device)
    key = ("rleucg", dtype, str(device))
    if key not in cheb.kernel_rows:
        ce = cheb.coeffs.cpu().numpy().astype(np.float64)
        tabSS = params.tabSS.cpu().numpy()
        S = tabSS.shape[0] - 1
        block = hp.dform_block(ce, tabSS.reshape(S + 1, S + 1, 4))
        cheb.kernel_rows[key] = torch.as_tensor(block, dtype=dtype,
                                                device=device)
    return cheb.kernel_rows[key]


def kernel_scalars(box, params: RLEUCGParams, cheb: ChebBank,
                   dtype=torch.float32) -> torch.Tensor:
    """[Lx Ly cutsq innersq uscale uoff kT 0]."""
    L = box.lengths.to(dtype)
    uscale, uoff = hp.u_map(cheb, dtype)
    return torch.stack([L[0], L[1], params.cutsq[1, 1].to(dtype),
                        params.bank.innersq[0].to(dtype), uscale, uoff,
                        params.kT.to(dtype), torch.zeros_like(uoff)])


# ---- the plain PyTorch twin ------------------------------------------------

def rleucg_pair_reference(scal, z0, span_len, ipack, cols, coef, *,
                          mx: int, my: int, degree: int, observe: bool,
                          feedback: bool, periodic: tuple = (True, True)):
    """Plain PyTorch version of K4 (same arguments, same outputs), computed
    in the tensors' dtype on K1's twin's span walk, series and channels."""
    dev, dt = ipack.device, ipack.dtype
    n_slots = ipack.shape[0]
    out = torch.zeros((n_slots, 8), dtype=dt, device=dev)
    part = torch.zeros((n_slots, 8), dtype=dt, device=dev) if observe else None
    innersq, uscale, uoff = scal[3], scal[4], scal[5]
    for sl, irows, jattr, dx, dy, dz, rsq, mask in hp.span_pairs(
            scal, z0, span_len, ipack, cols, mx=mx, my=my, observe=observe,
            periodic=periodic):
        u = torch.clamp(rsq * uscale + uoff, min=-1.0)
        ch = hp.pair_channels(coef, u, irows, jattr, degree)
        out[sl], emix, fmix = rleucg_rows(ch, irows[:, :, 6:7], jattr(3),
                                          mask, dx, dy, dz, feedback, observe)
        if observe:
            part[sl] = hp.observed(emix, fmix, dx, dy, dz, mask, rsq, innersq)
    return out, part


def rleucg_rows(ch, pi1, pj1, mask, dx, dy, dz, feedback: bool,
                observe: bool):
    """K4's output rows from a batch of candidate pairs (pairs along the
    last axis): (rows [fx fy fz pf0 0 0 0 0] flattened to (-1, 8), emix
    or None unless ``observe``, fmix).  The twin and the exclusion lists
    share it."""
    eA, eB, eC, eD, fA, fB, fC, fD = ch
    zero = torch.zeros((), dtype=fA.dtype, device=fA.device)
    p11 = pi1 * pj1
    fmix = torch.where(mask, fA + pi1 * fB + pj1 * fC + p11 * fD, zero)
    zc = torch.zeros_like(fmix[..., 0])
    pf0 = (torch.sum(torch.where(mask, eB + pj1 * eD, zero), -1)
           if feedback else zc)
    rows = torch.stack([torch.sum(fmix * dx, -1), torch.sum(fmix * dy, -1),
                        torch.sum(fmix * dz, -1), pf0, zc, zc, zc, zc],
                       -1).reshape(-1, 8)
    emix = (torch.where(mask, eA + pi1 * eB + pj1 * eC + p11 * eD, zero)
            if observe else None)
    return rows, emix, fmix


def rleucg_pair(scal, z0, span_len, ipack, cols, coef, *, mx: int, my: int,
                degree: int, observe: bool, feedback: bool,
                periodic: tuple = (True, True)):
    """K4: the hand-written kernel on CUDA tensors (launch or raise), its
    plain twin on CPU tensors.  Returns (out, part); part is None unless
    ``observe``."""
    kw = dict(mx=mx, my=my, degree=degree, observe=observe,
              periodic=periodic)
    if ipack.is_cuda:
        res = hd.launch_density_pair(hd.STYLE_RLEUCG, scal, z0, span_len,
                                     ipack, cols, coef, ucg_mask=0,
                                     mf=True, scores=False, feedback=feedback,
                                     **kw)
        rleucg_pair.launches[variant(observe)] += 1
        return res
    if ipack.device.type == "cpu":
        return rleucg_pair_reference(scal, z0, span_len, ipack, cols, coef,
                                     feedback=feedback, **kw)
    raise ValueError(f"no K4 implementation for device {ipack.device}")


rleucg_pair.launches = {"full": 0, "fast": 0}


# ---- the three passes ----------------------------------------------------------

def radius_by_type(params: RLEUCGParams) -> torch.Tensor:
    """(S+1,) proximity radius per substate type (its actual type's)."""
    return params.threshold_radius[params.actual_from_state.long()]


def rleucg_inputs(state: SimState, cl: colpack.ColumnList,
                  params: RLEUCGParams, cheb: ChebBank, a1: torch.Tensor,
                  observe: bool, slot: bool = False):
    """(args, kwargs) of :func:`rleucg_pair` for pass 2 on ``a1`` (the
    probability of substate 1 per atom); ``slot`` as in
    ``colpack.pack``."""
    f32 = torch.float32
    ipack, cols = colpack.pack(cl, state.box, state.x, a1,
                               torch.zeros_like(a1), dtype=f32, aux=a1,
                               typ=state.typ, slot=slot)
    coef = kernel_rows(cheb, params, f32, state.device)
    return ((kernel_scalars(state.box, params, cheb), cl.z0, cl.L, ipack,
             cols, coef),
            dict(mx=cl.mx, my=cl.my, periodic=cl.periodic,
                 degree=cheb.degree, observe=observe,
                 feedback=params.feedback == "always"))


def excl_rleucg(state: SimState, jrows: torch.Tensor, params: RLEUCGParams,
                cheb: ChebBank, a1: torch.Tensor, observe: bool,
                feedback: bool):
    """K4's output rows over the (N, S) special-partner lists ``jrows`` at
    the substate probabilities ``a1`` the pass packed: ((N, 8) rows, (8,)
    per-slot sums or None unless ``observe``), through
    :func:`rleucg_rows` on K4's float32 rows of each substate-type pair,
    for :func:`compute_rleucg` to subtract."""
    f32 = torch.float32
    jc, dr, rsq, mask = hp.excl_geometry(state, jrows, params.cutsq[1, 1])
    uscale, uoff = hp.u_map(cheb, f32)
    u = torch.clamp(rsq * uscale + uoff, min=-1.0)
    typ = state.typ.long()
    ch = hp.typed_channels(kernel_rows(cheb, params, f32, state.device), u,
                           typ[:, None], typ[jc], cheb.degree)
    a = a1.to(f32)
    dx, dy, dz = dr[..., 0], dr[..., 1], dr[..., 2]
    out, emix, fmix = rleucg_rows(ch, a[:, None], a[jc], mask, dx, dy, dz,
                                  feedback, observe)
    part = (hp.observed(emix, fmix, dx, dy, dz, mask, rsq,
                        params.bank.innersq[0].to(f32)).sum(0)
            if observe else None)
    return out, part


def compute_rleucg(state: SimState, cl: colpack.ColumnList,
                   params: RLEUCGParams, cheb: ChebBank,
                   observe: bool = True, slot: bool = False,
                   excl_rows: torch.Tensor | None = None,
                   xchg=None) -> ForceOut:
    """Pair evaluation through K5 → K4 → K6, with ``params`` as
    ``select_pair_kernel`` returns them (``cv_rad`` set).  ``observe=False``
    is the fast variant (pe/virial/oob come back 0) for interior MD
    steps.  ``slot``: ``state`` is slot-resident and so is the result.
    ``excl_rows`` and ``xchg`` as in ``hopper_density.compute_density``:
    the special pairs' sums leave ρ after K5, K4's rows after K4
    (:func:`excl_rleucg`) and the back-force after K6; the halo exchange
    takes ρ and the CV weights."""
    f32 = torch.float32
    dev = state.device
    typ = state.typ
    n = state.n_atoms
    zero = torch.zeros((), dtype=f32, device=dev)
    cv_args = (params.cv_rad, params.cutsq[1, 1], params.bank.innersq[0])

    # ---- pass 1: ρ → substate probabilities (K5) --------------------------
    def rows(out):
        return out if slot else out[cl.atom_slot]

    args, kw = hcv.cv_inputs(state, cl, *cv_args, None, slot)
    rho = rows(hcv.cv_rho(*args, **kw))[:, 0]
    if excl_rows is not None:
        rho = rho - hcv.excl_rho(state, excl_rows, *cv_args[:2])[0]
    if xchg is not None:
        rho = xchg(rho)            # ghosts need their owners' densities
    probs, partial = pr4.substate_probs(params, typ, rho)
    explicit, pforce = pr4.one_body(params, typ, probs)

    # ---- pass 2: mean-field mixing + probability feedback (K4) -----------
    args, kw = rleucg_inputs(state, cl, params, cheb, probs[:, 1], observe,
                             slot)
    out2, part2 = rleucg_pair(*args, **kw)
    at2 = rows(out2)
    less2 = less3 = None
    if excl_rows is not None:
        ex2, less2 = excl_rleucg(state, excl_rows, params, cheb, probs[:, 1],
                                 observe, kw["feedback"])
        at2 = at2 - ex2
    pf0 = pforce[:, 0] + torch.where(explicit[:, 0], at2[:, 3], zero)
    pforce = torch.cat([pf0[:, None], pforce[:, 1:]], dim=1)

    # ---- pass 3: the CV back-force (K6) -----------------------------------
    cvf = torch.sum(pforce * partial, dim=-1)
    if xchg is not None:
        cvf = xchg(cvf)            # ghost CV weights from their owners
    gform = "mder" if params.conservative_sign else "pder"
    args, kw = hcv.cv_inputs(state, cl, *cv_args, cvf, slot)
    out3, part3 = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    f3 = rows(out3)[:, 0:3]
    if excl_rows is not None:
        ex3, less3 = hcv.excl_force(state, excl_rows, *cv_args[:2], cvf,
                                    gform, observe)
        f3 = f3 - ex3
    pe, virial, oob_low = hd.totals(part2, part3, observe, dev, less2, less3)
    return ForceOut(f=at2[:, 0:3] + f3,
                    ucgforce=torch.zeros(n, dtype=f32, device=dev),
                    scores=torch.zeros((n, 2), dtype=f32, device=dev),
                    pe=pe, virial=virial, oob_low=oob_low,
                    oob_high=torch.zeros((), dtype=torch.int32, device=dev))


def compute_style_rleucg(state: SimState, cl: colpack.ColumnList,
                         params: RLEUCGParams,
                         excl_rows: torch.Tensor | None = None,
                         xchg=None) -> ForceOut:
    """Simulation pair entry: reads the ChebBank from ``params.cheb``."""
    return compute_rleucg(state, cl, params, params.cheb,
                          excl_rows=excl_rows, xchg=xchg)


def compute_style_rleucg_fast(state: SimState, cl: colpack.ColumnList,
                              params: RLEUCGParams,
                              excl_rows: torch.Tensor | None = None,
                              xchg=None) -> ForceOut:
    """Interior-step variant: no energy/virial/oob (observe=False)."""
    return compute_rleucg(state, cl, params, params.cheb, observe=False,
                          excl_rows=excl_rows, xchg=xchg)


def compute_style_rleucg_slot_fast(state: SimState, cl: colpack.ColumnList,
                                   params: RLEUCGParams) -> ForceOut:
    """Slot-resident interior-step variant (observe=False)."""
    return compute_rleucg(state, cl, params, params.cheb, observe=False,
                          slot=True)


compute_style_rleucg.fast_variant = compute_style_rleucg_fast
compute_style_rleucg.slot_fast = compute_style_rleucg_slot_fast
compute_style_rleucg.takes_excl_rows = True
compute_style_rleucg.supports_halo_xchg = True
compute_style_rleucg_fast.supports_halo_xchg = True
