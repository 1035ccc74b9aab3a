"""``fix ucgstate`` — posterior probabilities and discrete-state assignment
(port of ``lammps_ucg_dev_tpu/fixes/ucgstate.py``).

Reference (``UCG/fix_ucgstate.cpp:88-132``):
    ucgp_i = clamp(softmax(scores_i)[1], 1e-6, 1-1e-6)   (exp clamp at 700)
      (default) ucgstate = round(ucgp); ucgl = ucgp
      ld        only ucgp is updated (the λ integrator owns state/λ)
      mc        rate-capped Metropolis-like switching: accept a switch with
                probability min(odds, 1)·mc_rate; ucgl = ucgp

``mc`` takes its uniform draws as an input, ``uniforms`` (rng_n,) indexed
by ``tag - 1``.  The ``Simulation`` draws them from a generator of their
own, keyed by its seed and ``seed`` (``fix ucgstate mc SEED rate``), so the
same seed gives the same stream and another seed another; tests inject the
JAX package's draws.

Deviation (catalogued, as in the JAX package): the reference's MC accept
branch assigns state 0/1 rather than toggling (:118-122), which inverts the
move for state-0 atoms.  The intended toggle is the default;
``compat_reference_mc=True`` reproduces the reference literally.
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState
from lammps_ucg_dev_tpu_torch.models.common import softmax_posterior

MODES = ("default", "ld", "mc")


@dataclasses.dataclass(frozen=True)
class UCGStateCfg:
    mode: str = "default"        # one of MODES
    mc_rate: float = 0.01
    seed: int = 0                # the mc stream (fix ucgstate mc SEED rate)
    compat_reference_mc: bool = False
    group: "object | None" = None  # per-TAG bool mask; None = all

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown ucgstate mode {self.mode!r}")


def post_force(state: SimState, scores: torch.Tensor, is_ucg: torch.Tensor,
               cfg: UCGStateCfg,
               uniforms: torch.Tensor | None = None) -> SimState:
    ucgp = softmax_posterior(scores, is_ucg)
    ucgstate, ucgl = state.ucgstate, state.ucgl
    zero_state = torch.zeros_like(ucgstate)
    if cfg.mode == "default":
        ucgstate = torch.where(is_ucg, torch.round(ucgp).to(ucgstate.dtype),
                               zero_state)
        ucgl = torch.where(is_ucg, ucgp, ucgl)
    elif cfg.mode == "mc":
        if uniforms is None:
            raise ValueError("ucgstate mc needs its uniform draws")
        odds = torch.where(state.ucgstate == 0, ucgp / (1.0 - ucgp),
                           (1.0 - ucgp) / ucgp)
        mc_factor = torch.clamp(odds, max=1.0) * cfg.mc_rate
        rand = uniforms.to(ucgp.dtype)[state.tag.long() - 1]
        accept = rand < mc_factor
        if cfg.compat_reference_mc:
            new_state = torch.where(accept, zero_state,
                                    torch.ones_like(ucgstate))  # :118-122
        else:
            new_state = torch.where(accept, 1 - state.ucgstate,
                                    state.ucgstate)
        ucgstate = torch.where(is_ucg, new_state.to(ucgstate.dtype),
                               zero_state)
        ucgl = torch.where(is_ucg, ucgp, ucgl)
    if cfg.group is not None:
        # the fix updates only its group's atoms (mask[i] & groupbit, :96)
        g = torch.as_tensor(cfg.group, dtype=torch.bool, device=state.device)
        g = g[state.tag.long() - 1]
        ucgp = torch.where(g, ucgp, state.ucgp)
        ucgstate = torch.where(g, ucgstate, state.ucgstate)
        ucgl = torch.where(g, ucgl, state.ucgl)
    return dataclasses.replace(state, ucgp=ucgp, ucgstate=ucgstate,
                               ucgl=ucgl)
