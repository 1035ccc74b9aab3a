"""Extended-Lagrangian velocity-Verlet integrators for (x, v, λ, v_λ) (port
of ``lammps_ucg_dev_tpu/fixes/integrate.py``).

``fix nve/ucgld`` (``UCG/fix_nve_ucgld.cpp:44-153``):
    initial:  v += dtf/m f ; x += dt v ; v_λ += dtf/m_λ f_λ ; λ += dt v_λ
    final:    v += dtf/m f ;            v_λ += dtf/m_λ f_λ
with dtf = 0.5 dt ftm2v and per-atom λ pseudo-mass m_λ = ucgml.

``fix nve/ucgld/wall/hard`` (``UCG/fix_nve_ucgld_wall_hard.cpp``):
    + after λ drift: ucgstate = λ < 0.5 ? 0 : 1            (:99-105)
    + in final: reflecting walls at λ=0/1                  (:172-200)
    + optional POST_FORCE double-well bias on λ             (:234-257)

``fix nve`` (kind ``"nve"``): stock velocity-Verlet on (x, v) only, λ
untouched.  Kind ``"none"`` integrates nothing: what ``unfix`` of the
integrator leaves.

r-RESPA with two levels (``run_style respa``: bonded terms inner, pair
outer; ``fix_nve_ucgld.cpp:155-173``): :func:`respa_outer_initial` kicks
(v, v_λ) with the pair forces over half the outer step,
:func:`respa_inner_step` runs one inner velocity-Verlet step of x and λ
under the bonded force, and :func:`respa_outer_final` is the outer final
kick with the λ walls.  All of them honour the fix's group mask.
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState


KINDS = ("nve/ucgld", "nve/ucgld/wall/hard", "nve", "none")


@dataclasses.dataclass(frozen=True)
class IntegratorCfg:
    kind: str = "nve/ucgld"       # one of KINDS
    bias_potential: bool = False  # wall/hard only
    barrier: float = 0.1
    group: "object | None" = None  # per-TAG bool mask; None = all atoms

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown integrator kind {self.kind!r}")

    @property
    def wall(self) -> bool:
        return self.kind == "nve/ucgld/wall/hard"


def group_mask(cfg, state: SimState):
    """Per-row bool from a per-tag group array; None = every atom."""
    g = getattr(cfg, "group", None)
    if g is None:
        return None
    g = torch.as_tensor(g, dtype=torch.bool, device=state.device)
    return g[state.tag.long() - 1]


def _sel(g, new, old):
    if g is None:
        return new
    return torch.where(g[:, None] if new.dim() == 2 else g, new, old)


def initial_integrate(state: SimState, f: torch.Tensor,
                      ucgforce: torch.Tensor, mass: torch.Tensor, dt: float,
                      ftm2v: float, cfg: IntegratorCfg) -> SimState:
    if cfg.kind == "none":
        return state
    g = group_mask(cfg, state)
    dtf = 0.5 * dt * ftm2v
    v = _sel(g, state.v + (dtf / mass)[:, None] * f, state.v)
    x = _sel(g, state.x + dt * v, state.x)
    if cfg.kind == "nve":
        return dataclasses.replace(state, x=x, v=v)
    vl = _sel(g, state.ucgvl + dtf / state.ucgml * ucgforce, state.ucgvl)
    lam = _sel(g, state.ucgl + dt * vl, state.ucgl)
    ucgstate = state.ucgstate
    if cfg.wall:
        ucgstate = _sel(g, (lam >= 0.5).to(ucgstate.dtype), ucgstate)
    return dataclasses.replace(state, x=x, v=v, ucgvl=vl, ucgl=lam,
                               ucgstate=ucgstate)


def final_integrate(state: SimState, f: torch.Tensor, ucgforce: torch.Tensor,
                    mass: torch.Tensor, dt: float, ftm2v: float,
                    cfg: IntegratorCfg) -> SimState:
    if cfg.kind == "none":
        return state
    g = group_mask(cfg, state)
    dtf = 0.5 * dt * ftm2v
    v = _sel(g, state.v + (dtf / mass)[:, None] * f, state.v)
    if cfg.kind == "nve":
        return dataclasses.replace(state, v=v)
    vl = _sel(g, state.ucgvl + dtf / state.ucgml * ucgforce, state.ucgvl)
    lam = state.ucgl
    if cfg.wall:
        # reflecting walls at λ = 0 and λ = 1 (:172-200)
        below = lam < 0.0
        above = lam > 1.0
        lam_r = torch.where(below, -lam, torch.where(above, 2.0 - lam, lam))
        vl_r = torch.where(below | above, -vl, vl)
        lam = _sel(g, lam_r, lam)
        vl = _sel(g, vl_r, vl)
    return dataclasses.replace(state, v=v, ucgvl=vl, ucgl=lam)


def respa_outer_initial(state: SimState, f: torch.Tensor,
                        ucgforce: torch.Tensor, mass: torch.Tensor,
                        dt: float, ftm2v: float,
                        cfg: IntegratorCfg) -> SimState:
    """Outer-level half-kick of (v, v_λ) with the slow (pair) forces —
    ``initial_integrate_respa`` at the outermost level (:155-165); the
    drifts happen at the inner level."""
    if cfg.kind == "none":
        return state
    g = group_mask(cfg, state)
    dtf = 0.5 * dt * ftm2v
    v = _sel(g, state.v + (dtf / mass)[:, None] * f, state.v)
    if cfg.kind == "nve":
        return dataclasses.replace(state, v=v)
    vl = _sel(g, state.ucgvl + dtf / state.ucgml * ucgforce, state.ucgvl)
    return dataclasses.replace(state, v=v, ucgvl=vl)


def respa_inner_step(state: SimState, fbond: torch.Tensor,
                     mass: torch.Tensor, dt_inner: float, ftm2v: float,
                     cfg: IntegratorCfg, bonded_eval):
    """One inner r-RESPA step: half-kick with the fast (bonded) force,
    drift of x and λ, the fast force again (``bonded_eval(state)``), second
    half-kick.  Returns (state, fbond)."""
    if cfg.kind == "none":
        return state, fbond
    g = group_mask(cfg, state)
    dtf = 0.5 * dt_inner * ftm2v
    v = _sel(g, state.v + (dtf / mass)[:, None] * fbond, state.v)
    x = _sel(g, state.x + dt_inner * v, state.x)
    if cfg.kind == "nve":
        lam = state.ucgl
    else:
        lam = _sel(g, state.ucgl + dt_inner * state.ucgvl, state.ucgl)
    ucgstate = state.ucgstate
    if cfg.wall:
        ucgstate = _sel(g, (lam >= 0.5).to(ucgstate.dtype), ucgstate)
    state = dataclasses.replace(state, x=x, v=v, ucgl=lam, ucgstate=ucgstate)
    fbond = bonded_eval(state)
    v = _sel(g, state.v + (dtf / mass)[:, None] * fbond, state.v)
    return dataclasses.replace(state, v=v), fbond


def respa_outer_final(state: SimState, f: torch.Tensor,
                      ucgforce: torch.Tensor, mass: torch.Tensor, dt: float,
                      ftm2v: float, cfg: IntegratorCfg) -> SimState:
    """Outer-level final half-kick and the λ walls (:166-173,
    fix_nve_ucgld_wall_hard.cpp:172-200)."""
    return final_integrate(state, f, ucgforce, mass, dt, ftm2v, cfg)


def bias_force(lam: torch.Tensor, barrier: float) -> torch.Tensor:
    """Double-well λ bias: U = (798 x¹⁰ - x² + 0.1)·10H with x = λ - 0.5;
    F = (-7980 x⁹ + 2x)·10H (fix_nve_ucgld_wall_hard.cpp:234-239)."""
    xx = lam - 0.5
    return (-7980.0 * xx**9 + 2.0 * xx) * 10.0 * barrier


def bias_energy(lam: torch.Tensor, barrier: float) -> torch.Tensor:
    xx = lam - 0.5
    return (798.0 * xx**10 - xx**2 + 0.1) * 10.0 * barrier
