"""``pair_style table_ucg_bethe`` — self-consistent two-state UCG with the
Bethe (pair) approximation, the reference pair path (port of
``lammps_ucg_dev_tpu/models/pair_bethe.py``).

Physics (PairTable_UCG_Bethe::compute, ``UCG/pair_table_ucg_bethe.cpp:88-630``):

* per-atom priors: from the previous step's self-consistent probabilities
  (pi1 = ucgl_i for the i-role, pj1 = ucgp_j for the j-role, :199-253) or, on
  the first evaluation (``ucgp < -0.999`` sentinel), from chemical potentials
  (± uniform noise) or ucgl, per the ``prior`` flag (:179-253).
* closed-form Bethe two-point distribution (:544-581):
      J   = u11 + u00 - u01 - u10
      b   = exp(-J/kT),  a = expm1(-J/kT)
      Q   = (pi1 + pj1) a + 1
      D   = max(Q² - 4 a b pi1 pj1, 0)
      p11 = 2 b pi1 pj1 / (Q + √D)     (or (Q-√D)/2a if Q<0; pi1·pj1 if |a|<ε
                                        or ``method mf``)
      p00 = 1 + p11 - pi1 - pj1 ;  p10 = pi1 - p11 ;  p01 = pj1 - p11
* mixed energy/force = Σ p_ss' u_ss' (:603-604); no dU/dp force term because
  p11 satisfies the variational principle.
* softmax scores: chemical-potential init (:155-162); pseudolikelihood tallies
  at current discrete states (``pseudo yes``, :526-539) or full-SCE conditional
  expectations (``pseudo no``, :583-601, with the intended u-pairing).
* overflow guard: J/kT < -709 → clamp to -700 kT (:545-548).

Full neighbor list, per-atom-owned tallies, evaluated in row chunks through
the generic table branch (``common.eval_state_block``).  This path is the CPU
default and the float64 oracle of the hand-written kernel path
(ops/hopper_bethe.py).

``prior_mode="chemical_potential_noise"`` needs its uniform draws as an
input: ``prior_u`` (rng_n,) indexed by ``tag - 1`` (the ``Simulation``
draws them from its generator; tests inject the JAX package's draws).
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import common
from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.neighbor import NeighborList
from lammps_ucg_dev_tpu_torch.ops.table import TableBank

_EPSILONE = 1.0e-6
_PEPS = 1.0e-12
PRIOR_MODES = ("ucgl", "chemical_potential", "chemical_potential_noise")


@dataclasses.dataclass(frozen=True)
class BetheParams:
    bank: TableBank
    tp: UCGTypeParams
    kT: torch.Tensor
    prior_ptype: torch.Tensor  # (T+1, 2) Boltzmann priors from the chemical
                               # potentials (init_style, :1056-1077)
    noise_level: torch.Tensor  # scalar
    method: str = "bethe"      # "bethe" | "mf"
    pseudo: bool = True        # pseudolikelihood vs full-SCE scores
    prior_mode: str = "ucgl"   # one of PRIOR_MODES
    chunk: int = 0             # row-chunk size for the pair loop (0 = unchunked)
    cheb: "object | None" = None   # ChebBank for the kernel path


def make_params(bank: TableBank, tp: UCGTypeParams, kT: float,
                method: str = "bethe", pseudo: bool = True,
                prior_mode: str = "ucgl", noise_level: float = 0.0,
                dtype=torch.float32) -> BetheParams:
    """Precompute per-type Boltzmann priors (init_style, :1056-1077)."""
    if method not in ("bethe", "mf"):
        raise ValueError(f"unknown Bethe method {method!r}")
    if prior_mode not in PRIOR_MODES:
        raise ValueError(f"unknown prior mode {prior_mode!r}")
    mu0 = tp.mu[tp.formal[:, 0].long()]
    mu1 = tp.mu[tp.formal[:, 1].long()]
    e0 = torch.exp(-mu0 / kT)
    e1 = torch.exp(-mu1 / kT)
    p0 = torch.where(tp.n_states > 1, e0 / (e0 + e1), torch.ones_like(e0))
    dev = bank.e.device
    return BetheParams(
        bank=bank, tp=tp, kT=torch.as_tensor(kT, dtype=dtype, device=dev),
        prior_ptype=torch.stack([p0, 1.0 - p0], dim=-1).to(dtype),
        noise_level=torch.as_tensor(noise_level, dtype=dtype, device=dev),
        method=method, pseudo=pseudo, prior_mode=prior_mode)


def _priors(state: SimState, params: BetheParams,
            prior_u: torch.Tensor | None = None):
    """(prior_i1, prior_j1): P(state=1) for the i-role (from ucgl) and the
    j-role (from ucgp); sentinel atoms use the prior flag (:179-253)."""
    tp = params.tp
    typ = state.typ.long()
    dt = state.ucgl.dtype
    is_ucg = tp.n_states[typ] > 1
    unassigned = state.ucgp < -0.999

    if params.prior_mode == "chemical_potential":
        p1_flag = params.prior_ptype[typ, 1].to(dt)
    elif params.prior_mode == "chemical_potential_noise":
        if prior_u is None:
            raise ValueError("prior chemical_potential_noise needs its "
                             "uniform draws (prior_u)")
        u = prior_u.to(dt)[state.tag.long() - 1]
        noise = (u - 0.5) * 2.0 * params.noise_level.to(dt)
        p0 = torch.clamp(params.prior_ptype[typ, 0].to(dt) + noise, 0.0,
                         0.999999)
        p1_flag = 1.0 - p0
    elif params.prior_mode == "ucgl":
        p1_flag = state.ucgl
    else:
        raise ValueError(f"unknown prior mode {params.prior_mode!r}")

    zero = torch.zeros((), dtype=dt, device=state.device)
    pi1 = torch.where(unassigned, p1_flag, state.ucgl)
    pj1 = torch.where(unassigned, p1_flag, state.ucgp)
    return torch.where(is_ucg, pi1, zero), torch.where(is_ucg, pj1, zero)


def bethe_pij(u4: torch.Tensor, pi1, pj1, kT, method: str = "bethe"):
    """Closed-form Bethe two-point distribution (:544-581).

    u4: (..., 2, 2) state-pair energies; pi1/pj1 broadcastable to u4[..., 0, 0].
    Returns p4 (..., 2, 2) with axes [si, sj].
    """
    J = u4[..., 1, 1] + u4[..., 0, 0] - u4[..., 0, 1] - u4[..., 1, 0]
    J = torch.maximum(J, torch.as_tensor(-700.0 * kT, dtype=J.dtype,
                                         device=J.device))   # :545-548
    x = -J / kT
    b = torch.exp(x)
    a = torch.expm1(x)

    if method == "mf":
        p11 = pi1 * pj1
    else:
        Q = (pi1 + pj1) * a + 1.0
        D = torch.clamp(Q * Q - 4.0 * a * b * pi1 * pj1, min=0.0)
        sqD = torch.sqrt(D)
        # numerically stable root selection (:564-577)
        small = torch.abs(a) < _EPSILONE
        root_pos = 2.0 * b * pi1 * pj1 / (Q + sqD)
        root_neg = (Q - sqD) / (2.0 * torch.where(small, torch.ones_like(a),
                                                  a))
        p11 = torch.where(Q < 0.0, root_neg, root_pos)
        p11 = torch.where(small, pi1 * pj1, p11)

    p00 = 1.0 + p11 - pi1 - pj1
    p10 = pi1 - p11
    p01 = pj1 - p11
    return torch.stack([torch.stack([p00, p01], dim=-1),
                        torch.stack([p10, p11], dim=-1)], dim=-2)


def bethe_log_ratio(J, pi1, pj1, kT, method: str = "bethe"):
    """Numerically stable log(p11/p01) of the Bethe two-point distribution.

    The naive log(p11/(pj1-p11)) is ill-conditioned as p01 -> 0.  With
    b = e^{-J/kT}, the exact identities

        E := Q - 2 b pi1 = b (pj1 - pi1) + (1 - pi1 - pj1)
        D  = E^2 + 4 b pi1 (1 - pi1)          (sum of positives)
        p11/p01 = 2 b pi1 / (E + sqrt(D))                    [E >= 0]
                = (sqrt(D) - E) / (2 (1 - pi1))              [E <  0]

    carry no cancellation.  The x = -J/kT >= 0 regime evaluates scaled by
    1/b so b^2 never overflows.
    """
    def log_floor(v):
        return torch.log(torch.clamp(v, min=_PEPS))

    if method == "mf":
        return log_floor(pi1) - log_floor(1.0 - pi1)
    x = torch.clamp(-J / kT, max=700.0)
    e1 = pj1 - pi1
    e0 = 1.0 - pi1 - pj1
    c4 = 4.0 * pi1 * (1.0 - pi1)
    t = torch.exp(-torch.abs(x))                  # e^{-|x|} in (0, 1]
    # x >= 0 regime (b >= 1): all quantities scaled by 1/b
    Es = e1 + e0 * t
    Ds = torch.sqrt(torch.clamp(Es * Es + c4 * t, min=0.0))
    lr_pos = torch.where(
        Es >= 0.0,
        log_floor(2.0 * pi1) - log_floor(Es + Ds),
        x + log_floor(Ds - Es) - log_floor(2.0 * (1.0 - pi1)))
    # x < 0 regime (b = t <= 1): unscaled
    Eu = e1 * t + e0
    Du = torch.sqrt(torch.clamp(Eu * Eu + c4 * t, min=0.0))
    lr_neg = torch.where(
        Eu >= 0.0,
        x + log_floor(2.0 * pi1) - log_floor(Eu + Du),
        log_floor(Du - Eu) - log_floor(2.0 * (1.0 - pi1)))
    return torch.where(x >= 0.0, lr_pos, lr_neg)


def _rows(state: SimState, idx, xi, ti, pi1_r, pj1_all, params: BetheParams):
    """Pair tallies of one row block; everything per-atom-owned."""
    bank, tp, kT = params.bank, params.tp, params.kT
    n = state.n_atoms
    valid = idx < n
    jc = torch.where(valid, idx, torch.zeros_like(idx))
    dr = state.box.min_image(xi[:, None, :] - state.x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    tj = state.typ[jc].long()
    ti2 = ti.long()[:, None].expand_as(tj)
    within = valid & (rsq < common.take2d(tp.cutsq, ti2, tj))
    e4, fp4, oob_lo, oob_hi = common.eval_state_block(bank, tp, ti2, tj, rsq,
                                                      within)
    zero = torch.zeros((), dtype=e4.dtype, device=e4.device)
    pj1_j = torch.where(within, pj1_all[jc], zero)
    jstate = within & (state.ucgstate[jc] > 0)
    is_ucg_j = tp.n_states[tj] > 1

    p4 = bethe_pij(e4, pi1_r[:, None], pj1_j, kT, params.method)
    p4 = torch.where(within[..., None, None], p4, zero)
    emix = torch.sum(p4 * e4, dim=(-1, -2))
    fmix = torch.sum(p4 * fp4, dim=(-1, -2))
    f_r = torch.sum(fmix[..., None] * dr, dim=1)
    pe_r = 0.5 * torch.sum(emix)
    vir_r = common.pair_virial(fmix, dr)

    if params.pseudo:
        # pseudolikelihood at current discrete neighbor states (:526-539);
        # UCG-nonUCG pairs use jstate = 0 (:443-447)
        u_at_js = torch.where(jstate[..., None], e4[..., :, 1], e4[..., :, 0])
        pair_scores = -u_at_js / kT
    else:
        # full-SCE: score_i[s] -= Σ_s' p(s'|s) u(s, s') / kT for UCG-UCG
        # pairs (:583-601, intended pairing); pseudolikelihood tallies for
        # UCG-nonUCG pairs (:443-447)
        pi = torch.stack([1.0 - pi1_r, pi1_r], dim=-1)[:, None, :, None]
        cond = p4 / torch.clamp(pi, min=_EPSILONE)           # p(sj | si)
        sce = -torch.sum(cond * e4, dim=3) / kT               # (rows, K, 2)
        plain = -e4[..., 0] / kT                              # single-state j
        pair_scores = torch.where((is_ucg_j & within)[..., None], sce, plain)
    scores_r = torch.sum(torch.where(within[..., None], pair_scores, zero),
                         dim=1)
    return f_r, scores_r, pe_r, vir_r, oob_lo, oob_hi


def compute(state: SimState, nbr: NeighborList, params: BetheParams,
            prior_u: torch.Tensor | None = None) -> ForceOut:
    x, typ = state.x, state.typ
    tp = params.tp
    n = state.n_atoms
    kT = params.kT
    pi1_all, pj1_all = _priors(state, params, prior_u)
    is_ucg = tp.n_states[typ] > 1

    parts = [_rows(state, nbr.idx[rows], x[rows], typ[rows], pi1_all[rows],
                   pj1_all, params)
             for rows in common.row_slices(n, params.chunk)]
    f, scores = (torch.cat([p[k] for p in parts]) for k in range(2))
    pe, virial, oob_lo, oob_hi = (sum(p[k] for p in parts)
                                  for k in range(2, 6))

    # chemical-potential initialization (:155-162)
    mu_i = tp.mu[tp.formal[typ.long()].long()]                # (N, 2)
    scores = scores - mu_i / kT
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    scores = torch.where(is_ucg[:, None], scores, zero)
    return ForceOut(f=f, ucgforce=torch.zeros_like(pi1_all), scores=scores,
                    pe=pe, virial=virial, oob_low=oob_lo, oob_high=oob_hi)
