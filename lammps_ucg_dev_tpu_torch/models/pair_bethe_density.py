"""``pair_style table_ucg_bethe_density`` — Bethe UCG with local-density CV
priors and entropic back-forces, the reference pair path (port of
``lammps_ucg_dev_tpu/models/pair_bethe_density.py``).

Physics (PairTable_UCG_Bethe_Density::compute,
UCG/pair_table_ucg_bethe_density.cpp:133-758), three passes:

1. Per-atom local density ρ_i = Σ_j w(r_ij) within the pair cutoff
   (:219-255) and the real in-cutoff count n_i; priors for density-CV types
   from the sigmoid threshold p0 = 0.5 + 0.5 tanh((ρ-ρ*)/0.1ρ*) and its
   ∂p0/∂ρ (the reference assigns the threshold value to the FIRST listed
   state, :251); chemical-potential Boltzmann priors for non-density UCG
   types (:257-270).
2. Pair mixing by the Bethe two-point distribution over the density priors
   (:528-658), with per-state prior-probability force tallies:
     one-body (density types, :302-314):
        entropy: pf_s -= kT ln(p_s) · (1 - n_i);  pf_s -= μ_s
     CG partner (:514-518):  pf_0 -= u00 + kT ln p_0 ; pf_1 -= u10 + kT ln p_1
     UCG partner, ``pair_cv="conservative"``: pf_1 -= u11 - u01 + kT ln(p11/p01)
        with the stable log ratio (``pair_bethe.bethe_log_ratio``), pf_0 no
        tally; ``"reference"`` transcribes the literal pair (:650-656)
        pf_0 -= u10 - u00 + kT ln(p10/p00) as well, which cancels at the
        Bethe optimum
   plus pseudolikelihood scores and the in-pass posterior
   ucgp = softmax(scores)[1] (:669-696).
3. CV back-force F_i = Σ_j (cvf_i g_i + cvf_j g_j) (x_i - x_j)/r with
   cvf = Σ_s pf_s ∂p_s/∂ρ (:698-733); g = -dw/dr
   (``backforce_derivative=True``, the conservative chain rule) or the
   reference-literal w(r) (False).

The JAX package's catalogued deviations hold here too: the one-body entropy
factor uses the real in-cutoff count, CG-CG energies count once, the
posterior indexes n_states by type, and the Bethe root keeps the guards of
``table_ucg_bethe``.  Full neighbor list, per-atom-owned tallies, every
pass in row chunks of ``chunk``.  This path is the CPU default and the
float64 oracle of the kernel path (ops/hopper_density.py).
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import common, density
from lammps_ucg_dev_tpu_torch.models.pair_bethe import (bethe_log_ratio,
                                                        bethe_pij)
from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.neighbor import NeighborList
from lammps_ucg_dev_tpu_torch.ops.table import TableBank

_PEPS = 1e-12
PAIR_CV_MODES = ("conservative", "reference")


@dataclasses.dataclass(frozen=True)
class BetheDensityParams:
    bank: TableBank
    tp: UCGTypeParams
    kT: torch.Tensor
    method: str = "bethe"             # "bethe" | "mf"
    backforce_derivative: bool = True
    pair_cv: str = "conservative"     # one of PAIR_CV_MODES
    chunk: int = 0                    # row-chunk size (0 = unchunked)
    cheb: "object | None" = None      # ChebBank for the kernel path
    cv_rad: "tuple | None" = None     # K5/K6 radius table, kernel path


def make_params(bank: TableBank, tp: UCGTypeParams, kT: float,
                method: str = "bethe", backforce_derivative: bool = True,
                pair_cv: str = "conservative",
                dtype=torch.float32) -> BetheDensityParams:
    if method not in ("bethe", "mf"):
        raise ValueError(f"unknown Bethe method {method!r}")
    if pair_cv not in PAIR_CV_MODES:
        raise ValueError(f"unknown pair_cv mode {pair_cv!r}")
    return BetheDensityParams(
        bank=bank, tp=tp,
        kT=torch.as_tensor(kT, dtype=dtype, device=bank.e.device),
        method=method, backforce_derivative=backforce_derivative,
        pair_cv=pair_cv)


def _priors(params: BetheDensityParams, typ: torch.Tensor,
            rho: torch.Tensor):
    """(prior (N, 2) = [p0, p1], partial0 (N,)): threshold priors for
    density types, Boltzmann priors from the chemical potentials for other
    UCG types, [1, 0] for plain types; partial0 = ∂p0/∂ρ."""
    tp = params.tp
    typ = typ.long()
    is_ucg = tp.n_states[typ] > 1
    use_den = (tp.use_density[typ] == 1) & is_ucg
    p_thr, partial_thr = density.threshold_prob_and_partial(
        rho, torch.clamp(tp.cv_threshold[typ], min=_PEPS))
    formal = tp.formal[typ].long()
    b0 = torch.exp(-tp.mu[formal[:, 0]] / params.kT)
    b1 = torch.exp(-tp.mu[formal[:, 1]] / params.kT)
    p_cp0 = b0 / (b0 + b1)
    one = torch.ones((), dtype=rho.dtype, device=rho.device)
    p0 = torch.where(use_den, p_thr, torch.where(is_ucg, p_cp0.to(rho.dtype),
                                                 one))
    partial0 = torch.where(use_den, partial_thr, torch.zeros_like(one))
    return torch.stack([p0, 1.0 - p0], dim=-1), partial0


def one_body(params: BetheDensityParams, typ: torch.Tensor,
             logp: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """(N, 2) one-body prior forces of density types (:302-314): -μ_s, and
    with entropy -kT ln(p_s)(1 - n_i)."""
    tp = params.tp
    typ = typ.long()
    use_den = (tp.use_density[typ] == 1) & (tp.n_states[typ] > 1)
    use_ent = tp.use_entropy[typ] == 1
    mu_i = tp.mu[tp.formal[typ].long()].to(logp.dtype)
    ent = params.kT * logp * (1.0 - n_real.to(logp.dtype))[:, None]
    return -mu_i - torch.where((use_ent & use_den)[:, None], ent,
                               torch.zeros_like(ent))


def compute(state: SimState, nbr: NeighborList,
            params: BetheDensityParams, xchg=None) -> ForceOut:
    """The three passes on the reference list.  ``xchg``: a spatial
    driver's halo exchange of per-atom rows (ghost rows get their owners'
    values), applied to ρ after pass 1 and to the CV weights before pass
    3: a ghost's ρ from its truncated neighbourhood would be wrong."""
    tp, bank, kT = params.tp, params.bank, params.kT
    typ = state.typ.long()
    n = state.n_atoms
    dt = state.x.dtype
    zero = torch.zeros((), dtype=dt, device=state.device)
    is_ucg = tp.n_states[typ] > 1
    use_den = (tp.use_density[typ] == 1) & is_ucg
    radius_all = torch.clamp(tp.threshold_radius[typ], min=_PEPS)
    rows_all = common.row_slices(n, params.chunk)

    def geom(rows):
        return common.pair_rows(state, nbr, rows, tp.cutsq, typ)

    # ---- pass 1: density and the real in-cutoff count (:219-255) --------
    rho, n_real = [], []
    for rows in rows_all:
        _, _, within, _, rsq = geom(rows)
        r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
        w = torch.where(within, density.proximity(r, radius_all[rows][:, None]),
                        zero)
        rho.append(torch.sum(w, dim=1))
        n_real.append(torch.sum(within, dim=1))
    rho, n_real = torch.cat(rho), torch.cat(n_real)
    if xchg is not None:
        rho = xchg(rho)

    prior, partial0 = _priors(params, typ, rho)
    pi1_all = prior[:, 1]
    logp_all = torch.log(torch.clamp(prior, min=_PEPS))

    # ---- pass 2: Bethe mixing, prior-force tallies, scores ---------------
    f, pforce, scores = [], [], []
    pe = virial = oob_lo = oob_hi = 0
    for rows in rows_all:
        jc, tj, within, dr, rsq = geom(rows)
        ti = typ[rows]
        e4, fp4, lo, hi = common.eval_state_block(bank, tp, ti[:, None], tj,
                                                  rsq, within)
        pi1_r = pi1_all[rows][:, None]
        pj1 = pi1_all[jc]
        p4 = bethe_pij(e4, pi1_r, pj1, kT, params.method)
        p4 = torch.where(within[..., None, None], p4, zero)
        fmix = torch.sum(p4 * fp4, dim=(-1, -2))
        f.append(torch.sum(fmix[..., None] * dr, dim=1))
        pe = pe + 0.5 * torch.sum(torch.sum(p4 * e4, dim=(-1, -2)))
        virial = virial + common.pair_virial(fmix, dr)
        oob_lo, oob_hi = oob_lo + lo, oob_hi + hi

        J = e4[..., 1, 1] + e4[..., 0, 0] - e4[..., 0, 1] - e4[..., 1, 0]
        lr = bethe_log_ratio(torch.where(within, J, zero), pi1_r, pj1, kT,
                             params.method)
        ucg1 = -(e4[..., 1, 1] - e4[..., 0, 1] + kT * lr)
        if params.pair_cv == "reference":
            logp4 = torch.log(torch.clamp(p4, min=_PEPS))
            ucg0 = -(e4[..., 1, 0] - e4[..., 0, 0]
                     + kT * (logp4[..., 1, 0] - logp4[..., 0, 0]))
        elif params.pair_cv == "conservative":
            ucg0 = torch.zeros_like(ucg1)
        else:
            raise ValueError(f"unknown pair_cv mode {params.pair_cv!r}")
        logp_r = logp_all[rows]
        cg0 = -(e4[..., 0, 0] + kT * logp_r[:, None, 0])
        cg1 = -(e4[..., 1, 0] + kT * logp_r[:, None, 1])
        ucg_j = (tp.n_states[tj] > 1) & within
        gate = within & use_den[rows][:, None]
        pforce.append(torch.stack([
            torch.sum(torch.where(gate, torch.where(ucg_j, ucg0, cg0), zero),
                      dim=1),
            torch.sum(torch.where(gate, torch.where(ucg_j, ucg1, cg1), zero),
                      dim=1)], dim=-1))

        # pseudolikelihood scores at the partner's state (:488, 597-603)
        jstate = within & (state.ucgstate[jc] > 0)
        u_at_js = torch.where(jstate[..., None], e4[..., :, 1], e4[..., :, 0])
        scores.append(-torch.sum(u_at_js, dim=1) / kT)
    f, pforce, scores = torch.cat(f), torch.cat(pforce), torch.cat(scores)

    mu_i = tp.mu[tp.formal[typ].long()]
    pforce = pforce + torch.where(use_den[:, None],
                                  one_body(params, typ, logp_all, n_real),
                                  zero)
    scores = scores - torch.where(use_den[:, None], mu_i / kT, zero)
    scores = torch.where(is_ucg[:, None], scores, zero)
    ucgp = common.softmax_posterior(scores, is_ucg)

    # ---- pass 3: CV back-force (:698-733) --------------------------------
    # ∂p1/∂ρ = -∂p0/∂ρ under the reference's [0]-is-threshold ordering
    cvf_all = pforce[:, 0] * partial0 - pforce[:, 1] * partial0
    cvf_all = torch.where(use_den, cvf_all, zero)
    if xchg is not None:
        cvf_all = xchg(cvf_all)
    fcv = []
    for rows in rows_all:
        jc, _, within, dr, rsq = geom(rows)
        r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
        rad_i, rad_j = radius_all[rows][:, None], radius_all[jc]
        if params.backforce_derivative:
            g_i = -density.proximity_der(r, rad_i)
            g_j = -density.proximity_der(r, rad_j)
        else:
            g_i = density.proximity(r, rad_i)
            g_j = density.proximity(r, rad_j)
        fcv_pair = torch.where(within, cvf_all[rows][:, None] * g_i
                               + cvf_all[jc] * g_j, zero) / r
        fcv.append(torch.sum(fcv_pair[..., None] * dr, dim=1))
        virial = virial + common.pair_virial(fcv_pair, dr)

    return ForceOut(f=f + torch.cat(fcv), ucgforce=torch.zeros_like(rho),
                    scores=scores, pe=pe, virial=virial, oob_low=oob_lo,
                    oob_high=oob_hi, ucgp=ucgp)


compute.supports_halo_xchg = True
