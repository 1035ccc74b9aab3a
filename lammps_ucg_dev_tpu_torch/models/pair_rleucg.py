"""``pair_style table_rleucg_interface`` — mean-field RLE-UCG with a
local-density CV (the Jin & Pak formulation; multi-state capable), the
reference pair path (port of ``lammps_ucg_dev_tpu/models/pair_rleucg.py``).

Physics (PairTable_RLEUCG_INTERFACE::compute,
UCG/pair_table_rleucg_interface.cpp:177-505), three passes:

1. density CV → substate probabilities (:231-276): atom types ARE
   substates; for multi-state actual types p₀ = 0.5+0.5·tanh((ρ-ρ*)/0.1ρ*)
   with ∂p/∂ρ; the LAST substate's probability is implicit (1 - Σ others).
2. mean-field mixed pair forces Σ_αβ p_α p_β f_αβ per atom (:321-441);
   one-body entropic (-kT ln p_s + kT ln p_last) and chemical-potential
   probability forces (:296-317); two-body energy feedback
   pf_s -= Σ_β p_β (u_sβ - u_{last,β}) (:427-435).
3. CV back-force pf·∂p/∂ρ over the density neighbors through w'(r)/r
   (:444-502).

The JAX package's compat flags hold here too: ``feedback="always"`` (every
directed pair; "never" is the reference's single-rank behaviour) and
``conservative_sign=True`` (dw/dr = -|w'|, so F = -∇E; False is the
reference's +|w'|).  This path is the CPU default and the float64 oracle of
the kernel path (ops/hopper_rleucg.py).
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import (ForceOut, SimState,
                                                resolve_device)
from lammps_ucg_dev_tpu_torch.models import common, density
from lammps_ucg_dev_tpu_torch.ops.neighbor import NeighborList
from lammps_ucg_dev_tpu_torch.ops.table import TableBank

_PEPS = 1e-12
FEEDBACK_MODES = ("always", "never")


@dataclasses.dataclass(frozen=True)
class RLEUCGParams:
    bank: TableBank
    tabSS: torch.Tensor            # (S+1, S+1, Smax, Smax) int64 table ids
    cutsq: torch.Tensor            # (S+1, S+1)
    n_states: torch.Tensor         # (A+1,) per actual type
    actual_from_state: torch.Tensor  # (S+1,)
    use_entropy: torch.Tensor      # (A+1,)
    mu: torch.Tensor               # (S+1,) chemical potential per substate
    cv_threshold: torch.Tensor     # (A+1,)
    threshold_radius: torch.Tensor  # (A+1,)
    kT: torch.Tensor
    max_states: int = 2
    feedback: str = "always"       # one of FEEDBACK_MODES
    conservative_sign: bool = True
    chunk: int = 0                 # row-chunk size (0 = unchunked)
    cheb: "object | None" = None   # ChebBank for the kernel path
    cv_rad: "tuple | None" = None  # K5/K6 radius table, kernel path


def make_params(builder, st, kT: float, feedback: str = "always",
                conservative_sign: bool = True, dtype=torch.float32,
                device="cuda") -> RLEUCGParams:
    """``builder`` a models.typemap.RLEUCGBuilder, ``st`` its rleucg-dialect
    StateSettings; the params live on ``device`` (the card unless told
    ``device="cpu"``; raises without CUDA)."""
    device = resolve_device(device)
    if feedback not in FEEDBACK_MODES:
        raise ValueError(f"unknown feedback mode {feedback!r}")
    bank, tabSS, cutsq = builder.build(dtype=dtype, device=device)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    i32 = torch.int32
    return RLEUCGParams(
        bank=bank, tabSS=tabSS, cutsq=cutsq,
        n_states=t(st.n_states_per_type, i32),
        actual_from_state=t(st.actual_from_formal, i32),
        use_entropy=t(st.use_entropy, i32), mu=t(st.chemical_potentials, dtype),
        cv_threshold=t(st.cv_thresholds, dtype),
        threshold_radius=t(st.threshold_radii, dtype), kT=t(kT, dtype),
        max_states=int(st.max_states), feedback=feedback,
        conservative_sign=conservative_sign)


def _type_arrays(params: RLEUCGParams, typ: torch.Tensor):
    """(actual type, n_states, radius) per atom of substate type ``typ``."""
    act = params.actual_from_state[typ.long()].long()
    ns = params.n_states[act].long()
    radius = torch.clamp(params.threshold_radius[act], min=_PEPS)
    return act, ns, radius


def substate_probs(params: RLEUCGParams, typ: torch.Tensor,
                   rho: torch.Tensor):
    """(probs (N, Smax), partial (N, Smax)) with the last state implicit."""
    act, ns, _ = _type_arrays(params, typ)
    p_thr, partial_thr = density.threshold_prob_and_partial(
        rho, torch.clamp(params.cv_threshold[act], min=_PEPS))
    s = torch.arange(params.max_states, device=rho.device)[None, :]
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    multi = (ns > 1)[:, None]
    explicit = (s < (ns - 1)[:, None]) & multi
    last = s == (ns - 1)[:, None]
    # only substate 0 has an explicit (threshold) probability (:270)
    pexp = torch.where((s == 0) & explicit, p_thr[:, None], zero)
    sum_exp = torch.sum(pexp, dim=1, keepdim=True)
    probs = torch.where(explicit, pexp,
                        torch.where(last, 1.0 - sum_exp, zero))
    probs = torch.where(multi, probs, (s == 0).to(rho.dtype))
    partial = torch.where((s == 0) & explicit, partial_thr[:, None], zero)
    return probs, partial


def one_body(params: RLEUCGParams, typ: torch.Tensor, probs: torch.Tensor):
    """(explicit (N, Smax), one-body probability forces (N, Smax), :296-317)."""
    act, ns, _ = _type_arrays(params, typ)
    kT = params.kT
    s = torch.arange(params.max_states, device=probs.device)[None, :]
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    multi = (ns > 1)[:, None]
    explicit = (s < (ns - 1)[:, None]) & multi
    ent = (params.use_entropy[act] == 1)[:, None] & multi
    logp = torch.log(torch.clamp(probs, min=_PEPS))
    p_last = torch.gather(probs, 1, torch.clamp(ns - 1, min=0)[:, None])
    log_plast = torch.log(torch.clamp(p_last, min=_PEPS))
    mu_s = params.mu[torch.clamp(typ.long()[:, None] + s,
                                 max=params.mu.shape[0] - 1)]
    return explicit, torch.where(
        explicit, -mu_s + torch.where(ent, -kT * logp + kT * log_plast, zero),
        zero)


def compute(state: SimState, nbr: NeighborList,
            params: RLEUCGParams, xchg=None) -> ForceOut:
    """The three passes on the reference list; ``xchg`` as in
    ``pair_bethe_density.compute`` (ρ and the CV weights)."""
    bank, kT = params.bank, params.kT
    typ = state.typ.long()
    n = state.n_atoms
    dt = state.x.dtype
    zero = torch.zeros((), dtype=dt, device=state.device)
    _, ns, radius_all = _type_arrays(params, typ)
    rows_all = common.row_slices(n, params.chunk)
    if params.feedback not in FEEDBACK_MODES:
        raise ValueError(f"unknown feedback mode {params.feedback!r}")

    def geom(rows):
        return common.pair_rows(state, nbr, rows, params.cutsq, typ)

    # ---- pass 1: density → substate probabilities (:231-276) -------------
    rho = []
    for rows in rows_all:
        _, _, within, _, rsq = geom(rows)
        r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
        rho.append(torch.sum(torch.where(
            within, density.proximity(r, radius_all[rows][:, None]), zero),
            dim=1))
    rho = torch.cat(rho)
    if xchg is not None:
        rho = xchg(rho)
    probs_all, partial = substate_probs(params, typ, rho)
    explicit_all, pforce = one_body(params, typ, probs_all)

    # ---- pass 2: mean-field forces + probability feedback (:321-441) -----
    f = []
    pe = virial = oob_lo = oob_hi = 0
    nslast = torch.clamp(ns - 1, min=0)
    pf_fb = []
    for rows in rows_all:
        jc, tj, within, dr, rsq = geom(rows)
        tSS = common.take2d(params.tabSS, typ[rows][:, None], tj)
        eS, fpS, lo, hi = bank.interp(tSS, rsq[..., None, None])
        w = within[..., None, None]
        eS = torch.where(w, eS, zero)
        fpS = torch.where(w, fpS, zero)
        oob_lo = oob_lo + torch.sum(w & lo)
        oob_hi = oob_hi + torch.sum(w & hi)
        wA, wB = probs_all[rows], probs_all[jc]
        fmix = torch.einsum("ns,nkt,nkst->nk", wA, wB, fpS)
        emix = torch.einsum("ns,nkt,nkst->nk", wA, wB, eS)
        f.append(torch.sum(fmix[..., None] * dr, dim=1))
        pe = pe + 0.5 * torch.sum(emix)
        virial = virial + common.pair_virial(fmix, dr)
        if params.feedback == "always":
            # Σ_β p_β u_sβ against the last substate's, every directed pair
            ub = torch.einsum("nkt,nkst->nks", wB, eS)
            u_last = torch.gather(ub, 2, nslast[rows][:, None, None].expand(
                ub.shape[0], ub.shape[1], 1))[..., 0]
            fb = -(ub - u_last[..., None])
            pf_fb.append(torch.sum(torch.where(
                explicit_all[rows][:, None, :],
                torch.where(within[..., None], fb, zero), zero), dim=1))
    f = torch.cat(f)
    if pf_fb:
        pforce = pforce + torch.cat(pf_fb)

    # ---- pass 3: CV back-force (:444-502) --------------------------------
    cvf_all = torch.sum(pforce * partial, dim=-1)
    if xchg is not None:
        cvf_all = xchg(cvf_all)
    sign = -1.0 if params.conservative_sign else 1.0
    fcv = []
    for rows in rows_all:
        jc, _, within, dr, rsq = geom(rows)
        r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
        g_i = sign * density.proximity_der(r, radius_all[rows][:, None])
        g_j = sign * density.proximity_der(r, radius_all[jc])
        fcv_pair = torch.where(within, cvf_all[rows][:, None] * g_i
                               + cvf_all[jc] * g_j, zero) / r
        fcv.append(torch.sum(fcv_pair[..., None] * dr, dim=1))
        virial = virial + common.pair_virial(fcv_pair, dr)

    return ForceOut(f=f + torch.cat(fcv), ucgforce=torch.zeros_like(rho),
                    scores=torch.zeros((n, 2), dtype=dt, device=state.device),
                    pe=pe, virial=virial, oob_low=oob_lo, oob_high=oob_hi)


compute.supports_halo_xchg = True


def potential_energy(x: torch.Tensor, state: SimState, nbr: NeighborList,
                     params: RLEUCGParams) -> torch.Tensor:
    """The explicit mean-field free-energy functional E(x) — pair mixing +
    chemical potential + entropy — differentiable through ρ(x) → p(ρ); the
    tests hold F_total = -∇E by ``torch.autograd``."""
    typ = state.typ.long()
    n = x.shape[0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    valid = nbr.idx < n
    jc = torch.where(valid, nbr.idx, torch.zeros_like(nbr.idx))
    dr = state.box.min_image(x[:, None, :] - x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    ti, tj = typ[:, None], typ[jc]
    within = valid & (rsq < common.take2d(params.cutsq, ti, tj))
    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
    act, ns, radius = _type_arrays(params, typ)
    rho = torch.sum(torch.where(within, density.proximity(r, radius[:, None]),
                                zero), dim=1)
    probs, _ = substate_probs(params, typ, rho)

    tSS = common.take2d(params.tabSS, ti, tj)
    eS = params.bank.interp(tSS, rsq[..., None, None])[0]
    eS = torch.where(within[..., None, None], eS, zero)
    emix = torch.einsum("ns,nkt,nkst->nk", probs, probs[jc], eS)

    s = torch.arange(params.max_states, device=x.device)[None, :]
    multi = (ns > 1)[:, None]
    state_mask = (s < ns[:, None]) & multi
    ent = (params.use_entropy[act] == 1)[:, None]
    logp = torch.log(torch.clamp(probs, min=_PEPS))
    mu_s = params.mu[torch.clamp(typ[:, None] + s, max=params.mu.shape[0] - 1)]
    explicit = (s < (ns - 1)[:, None]) & multi
    e_one = (torch.sum(torch.where(explicit, mu_s * probs, zero))
             + params.kT * torch.sum(torch.where(state_mask & ent,
                                                 probs * logp, zero)))
    return 0.5 * torch.sum(emix) + e_one
