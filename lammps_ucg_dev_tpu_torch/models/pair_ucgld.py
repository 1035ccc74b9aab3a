"""``pair_style table_ucgld`` — λ-dynamics UCG tabulated pair style, the
reference pair path (port of ``lammps_ucg_dev_tpu/models/pair_ucgld.py``).

Physics (PairTable_UCGLD::compute, ``UCG/pair_table_ucgld.cpp:111-541``):

* mixed pair energy/force over state combinations with λ weights
  ``w_i = [1-λ_i, λ_i]``: E_ij = Σ_{s,s'} w_i[s] w_j[s'] u_ss'(r)
* λ-forces (−dU/dλ): ucgf_i -= λ_j (u11-u01) + (1-λ_j)(u10-u00)
* pseudolikelihood scores at the partner's CURRENT discrete state:
  score_i[s] -= u_{s, state_j}(r) / kT
* chemical-potential term per UCG atom: ucgf_i -= μ1-μ0 ;
  score_i[1] -= (μ1-μ0)/kT

Full neighbor list, per-atom-owned tallies, evaluated in row chunks
(``params.chunk``) so the (rows, K, 2, 2) working set stays bounded.  This
path is the CPU default and the float64 oracle of the hand-written kernel
path (ops/hopper_pair.py).  :func:`potential_energy` is the mixed energy as
a function of (x, λ), so ``torch.autograd`` can check f = −∂E/∂x and
ucgforce = −∂E/∂λ.
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState
from lammps_ucg_dev_tpu_torch.models import common
from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.neighbor import NeighborList
from lammps_ucg_dev_tpu_torch.ops.table import TableBank


@dataclasses.dataclass(frozen=True)
class UCGLDParams:
    bank: TableBank
    tp: UCGTypeParams
    kT: torch.Tensor   # scalar; pulled from the thermostat fix at init time
    chunk: int = 0     # row-chunk size for the pair loop (0 = unchunked)
    cheb: "object | None" = None   # ChebBank for the kernel path


def _rows(state: SimState, idx, xi, ti, wi, wi_all, bank, tp):
    """Pair tallies of one row block; everything per-atom-owned."""
    n = state.n_atoms
    valid = idx < n
    jc = torch.where(valid, idx, torch.zeros_like(idx))
    dr = state.box.min_image(xi[:, None, :] - state.x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    tj = state.typ[jc]
    ti2 = ti[:, None].expand_as(tj)
    within = valid & (rsq < common.take2d(tp.cutsq, ti2, tj))
    e4, fp4, oob_lo, oob_hi = common.eval_state_block(bank, tp, ti2, tj, rsq,
                                                      within)
    wj = wi_all[jc]                                         # (rows, K, 2)
    jstate = within & (state.ucgstate[jc] > 0)

    fmix = common.mix(fp4, wi, wj)
    emix = common.mix(e4, wi, wj)
    f_r = torch.sum(fmix[..., None] * dr, dim=1)
    pe_r = 0.5 * torch.sum(emix)
    vir_r = common.pair_virial(fmix, dr)
    du = e4[..., 1, :] - e4[..., 0, :]                      # (rows, K, 2)
    lamf_r = -torch.einsum("nkt,nkt->n", wj, du)
    u_at_js = torch.where(jstate[..., None], e4[..., :, 1], e4[..., :, 0])
    scores_r = -torch.sum(u_at_js, dim=1)
    return f_r, lamf_r, scores_r, pe_r, vir_r, oob_lo, oob_hi


def compute(state: SimState, nbr: NeighborList,
            params: UCGLDParams) -> ForceOut:
    bank, tp = params.bank, params.tp
    x, typ = state.x, state.typ
    n = state.n_atoms
    kT = params.kT
    wi_all = common.lambda_weights(tp, typ, state.ucgl)     # (N, 2)
    is_ucg = tp.n_states[typ] > 1

    chunk = params.chunk if params.chunk and n > params.chunk else n
    parts = [_rows(state, nbr.idx[r0:r0 + chunk], x[r0:r0 + chunk],
                   typ[r0:r0 + chunk], wi_all[r0:r0 + chunk], wi_all, bank,
                   tp)
             for r0 in range(0, n, chunk)]
    f, lamf, scores = (torch.cat([p[k] for p in parts]) for k in range(3))
    pe, virial, oob_lo, oob_hi = (sum(p[k] for p in parts)
                                  for k in range(3, 7))
    scores = scores / kT

    mu = tp.mu_diff[typ]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ucgforce = torch.where(is_ucg, lamf - mu, zero)
    scores = torch.stack([scores[:, 0], scores[:, 1] - mu / kT], dim=1)
    scores = torch.where(is_ucg[:, None], scores, zero)
    return ForceOut(f=f, ucgforce=ucgforce, scores=scores, pe=pe,
                    virial=virial, oob_low=oob_lo, oob_high=oob_hi)


def potential_energy(x: torch.Tensor, lam: torch.Tensor, state: SimState,
                     nbr: NeighborList, params: UCGLDParams) -> torch.Tensor:
    """Mixed potential energy as a function of (x, λ), with the λ
    chemical-potential term E_μ = Σ_i λ_i (μ1 − μ0) over the UCG atoms;
    differentiable in both."""
    bank, tp = params.bank, params.tp
    typ = state.typ
    n = x.shape[0]
    valid = nbr.idx < n
    jc = torch.where(valid, nbr.idx, torch.zeros_like(nbr.idx))
    dr = state.box.min_image(x[:, None, :] - x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    ti, tj = typ[:, None], typ[jc]
    within = valid & (rsq < common.take2d(tp.cutsq, ti.expand_as(tj), tj))
    e4 = common.eval_state_block(bank, tp, ti, tj, rsq, within)[0]
    wi = common.lambda_weights(tp, typ, lam)
    emix = common.mix(e4, wi, wi[jc])
    is_ucg = tp.n_states[typ] > 1
    e_mu = torch.sum(torch.where(is_ucg, lam * tp.mu_diff[typ],
                                 torch.zeros_like(lam)))
    return 0.5 * torch.sum(emix) + e_mu
