"""``fix ucgld/langevin`` — Langevin thermostat acting on λ — and the stock
velocity ``fix langevin`` (port of ``lammps_ucg_dev_tpu/fixes/langevin.py``).

Reference (``UCG/fix_ucgld_langevin.cpp``):
    post_force:  ucgforce += γ1 v_λ + γ2 √T (uniform - 0.5)        (:273-296)
    γ1 = -m_λ / period / ftm2v                                     (:165)
    γ2 = √m_λ / ftm2v · √(24 k_B / (period · dt · mvv2e))          (:166-167)
    temperature ramp T(t) = Tstart + (t-t0)/(t1-t0) (Tstop-Tstart) (:318-331)
    end_of_step: λ-temperature = Σ m_λ v_λ² mvv2e / (k_B N)        (:303-312)

The velocity thermostat follows the same conventions on each component of
v (stock fix_langevin, which the λ fix copies): γ1 = -m / damp / ftm2v,
γ2 = √(24 k_B T m / (damp dt mvv2e)) / ftm2v.

The noise is a uniform draw per atom TAG over the global tag space, so the
stream does not depend on storage order.  The caller draws it (the
``Simulation`` owns the ``torch.Generator``); a torch generator cannot
reproduce JAX's threefry bits, so parity tests pass in the JAX draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core import units as units_mod
from lammps_ucg_dev_tpu_torch.core.state import SimState


@dataclasses.dataclass(frozen=True)
class LangevinCfg:
    t_start: float
    t_stop: float
    t_period: float
    seed: int = 1234                # the fix's seed: the deck runner seeds
                                    # its generator from it
    group: "object | None" = None   # per-TAG bool mask; None = all


def t_target(cfg: LangevinCfg, step: int, beginstep: int,
             endstep: int) -> float:
    """Linear temperature ramp over the run window (compute_target,
    :318-331), evaluated in float32 as the JAX package does."""
    f32 = np.float32
    delta = (f32(step - beginstep) / f32(max(endstep - beginstep, 1))
             if endstep > beginstep else f32(0.0))
    return float(f32(cfg.t_start) + delta * f32(cfg.t_stop - cfg.t_start))


def post_force(uniform_by_tag: torch.Tensor, state: SimState, tT: float,
               dt: float, u: units_mod.UnitSystem,
               cfg: LangevinCfg) -> torch.Tensor:
    """The λ-force increment (drag + uniform random kick).
    ``uniform_by_tag`` is (rng_n,) U[0, 1) indexed by tag - 1."""
    ml = state.ucgml
    gamma1 = -ml / cfg.t_period / u.ftm2v
    gamma2 = (torch.sqrt(ml) / u.ftm2v
              * math.sqrt(24.0 * u.boltz / cfg.t_period / dt / u.mvv2e)
              * float(np.sqrt(np.float32(tT))))
    un = uniform_by_tag[state.tag.long() - 1]
    out = gamma1 * state.ucgvl + gamma2 * (un - 0.5)
    if cfg.group is not None:
        g = torch.as_tensor(cfg.group, dtype=torch.bool, device=state.device)
        out = torch.where(g[state.tag.long() - 1], out, torch.zeros_like(out))
    return out


@dataclasses.dataclass(frozen=True)
class VLangevinCfg:
    """Stock ``fix langevin`` on the particle velocities (the thermostat the
    reference's production decks run under; pair styles read kT from it
    when no λ-Langevin exists, ``SimConfig.kT``)."""

    t_start: float
    t_stop: float
    damp: float
    seed: int = 1234                # as LangevinCfg.seed
    group: "object | None" = None   # per-TAG bool mask; None = all


def post_force_v(uniform_by_tag: torch.Tensor, state: SimState,
                 mass: torch.Tensor, tT: float, dt: float,
                 u: units_mod.UnitSystem, cfg: VLangevinCfg) -> torch.Tensor:
    """(N, 3) force increment of the velocity thermostat (drag + uniform
    kick per component).  ``uniform_by_tag`` is (rng_n, 3) U[0, 1) indexed
    by tag - 1; ``mass`` the (N,) per-atom mass."""
    gamma1 = -mass / cfg.damp / u.ftm2v
    gamma2 = (torch.sqrt(mass) / u.ftm2v
              * math.sqrt(24.0 * u.boltz / cfg.damp / dt / u.mvv2e)
              * float(np.sqrt(np.float32(tT))))
    un = uniform_by_tag[state.tag.long() - 1]
    out = gamma1[:, None] * state.v + gamma2[:, None] * (un - 0.5)
    if cfg.group is not None:
        g = torch.as_tensor(cfg.group, dtype=torch.bool, device=state.device)
        out = torch.where(g[state.tag.long() - 1][:, None], out,
                          torch.zeros_like(out))
    return out


def lambda_temperature(state: SimState, u: units_mod.UnitSystem):
    """T_λ with 1 dof per atom (end_of_step, :303-312), globally reduced."""
    n = state.ucgvl.shape[0]
    ek = 0.5 * torch.sum(state.ucgml * state.ucgvl**2) * u.mvv2e
    return ek / (0.5 * u.boltz * n)
