"""``fix ucgstate`` — posterior probabilities and discrete-state assignment
(port of ``lammps_ucg_dev_tpu/fixes/ucgstate.py``, modes ``default`` and
``ld``; ``mc`` is not ported yet).

Reference (``UCG/fix_ucgstate.cpp:88-132``):
    ucgp_i = clamp(softmax(scores_i)[1], 1e-6, 1-1e-6)   (exp clamp at 700)
      (default) ucgstate = round(ucgp); ucgl = ucgp
      ld        only ucgp is updated (the λ integrator owns state/λ)
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState
from lammps_ucg_dev_tpu_torch.models.common import softmax_posterior


@dataclasses.dataclass(frozen=True)
class UCGStateCfg:
    mode: str = "default"        # "default" | "ld"
    group: "object | None" = None  # per-TAG bool mask; None = all


def post_force(state: SimState, scores: torch.Tensor, is_ucg: torch.Tensor,
               cfg: UCGStateCfg) -> SimState:
    ucgp = softmax_posterior(scores, is_ucg)
    ucgstate, ucgl = state.ucgstate, state.ucgl
    if cfg.mode == "default":
        ucgstate = torch.where(is_ucg, torch.round(ucgp).to(ucgstate.dtype),
                               torch.zeros_like(ucgstate))
        ucgl = torch.where(is_ucg, ucgp, ucgl)
    elif cfg.mode != "ld":
        raise NotImplementedError(
            f"ucgstate mode {cfg.mode!r} is not ported yet")
    if cfg.group is not None:
        # the fix updates only its group's atoms (mask[i] & groupbit, :96)
        g = torch.as_tensor(cfg.group, dtype=torch.bool, device=state.device)
        g = g[state.tag.long() - 1]
        ucgp = torch.where(g, ucgp, state.ucgp)
        ucgstate = torch.where(g, ucgstate, state.ucgstate)
        ucgl = torch.where(g, ucgl, state.ucgl)
    return dataclasses.replace(state, ucgp=ucgp, ucgstate=ucgstate,
                               ucgl=ucgl)
