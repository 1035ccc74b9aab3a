"""The MD run loop (port of ``lammps_ucg_dev_tpu/runtime/sim.py``).

One timestep =
    initial_integrate (fix nve/ucgld[/wall/hard])       fix_nve_ucgld.cpp:44
    pair compute                                        pair_table_*.cpp
    post_force fixes in order:
        ucgld/langevin (λ drag + kick)                  fix_ucgld_langevin.cpp:202
        wall/hard bias (optional)                       fix_nve_ucgld_wall_hard.cpp:241
        ucgstate (posteriors / state assignment)        fix_ucgstate.cpp:88
    final_integrate                                     fix_nve_ucgld.cpp:104

A block is ``reneigh_every`` steps.  At its start the PBC wrap and the
neighbor rebuild run together, only when the displacement check asks for
them (``neigh_modify check yes``).  On the kernel path the interior steps run a fast
pair variant (no pe/virial/oob; also no scores when nothing feeds them back)
and the block's last step runs the full kernel, so thermo always reads valid
observables.  The block loop runs on the host; the neighbor overflow flag
is read once per block.

Not ported yet: r-RESPA, bonded terms, special exclusions, cluster_switch,
the velocity Langevin, atom sorting and the slot-major interior.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core import units as units_mod
from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState, System
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.ops import clusters, colpack
from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float
    units: str = "lj"
    integrator: fi.IntegratorCfg = fi.IntegratorCfg()
    langevin: fl.LangevinCfg | None = None
    ucgstate: fs.UCGStateCfg | None = None
    reneigh_every: int = 10

    @property
    def u(self) -> units_mod.UnitSystem:
        return units_mod.get(self.units)

    @property
    def kT(self) -> float:
        """Thermostat target kT seen by pair styles at init."""
        if self.langevin is not None:
            return self.u.boltz * self.langevin.t_start
        return 0.0


class Simulation:
    """Assembles state + pair style + fixes into a stepper.

    ``pair_compute(state, nbr, params) -> ForceOut`` is the pair-style
    entry; ``nbr_spec`` is a NeighborSpec (reference pair path, nsq or
    cell), a colpack.ColumnSpec (the column kernels) or a
    clusters.ClusterSpec (K8's cluster list).  ``seed`` seeds the generator that
    draws the Langevin noise, the ``ucgstate mc`` uniforms and the noisy
    Bethe priors."""

    def __init__(self, system: System, state: SimState,
                 pair_compute: Callable, pair_params: Any, nbr_spec,
                 cfg: SimConfig, seed: int = 0):
        self.system = system
        self.state = state
        self.pair_compute = pair_compute
        self.pair_params = pair_params
        self.nbr_spec = nbr_spec
        self.cfg = cfg
        self.generator = torch.Generator(device=state.device)
        self.generator.manual_seed(seed)
        self._masses_by_type = torch.as_tensor(
            np.asarray(system.masses, np.float64), dtype=state.x.dtype,
            device=state.device)
        # scores are dynamically inert when nothing turns them into state
        # that feeds back into forces: no fix ucgstate, or 'ld' mode (ucgp
        # is observable-only there; fix_ucgstate.cpp:52-54)
        self._scores_inert = cfg.ucgstate is None or cfg.ucgstate.mode == "ld"
        self._fcarry: ForceOut | None = None
        self._nbr = None
        self.thermo_rows: list[dict] = []
        self.dangerous_builds = 0

    # ---- one force evaluation + post-force fixes -------------------------

    def _is_ucg(self, state: SimState) -> torch.Tensor:
        tp = getattr(self.pair_params, "tp", None)
        if tp is None:
            # styles without per-type UCG params (table_rleucg_interface)
            return torch.ones(state.n_atoms, dtype=torch.bool,
                              device=state.device)
        return tp.n_states[state.typ] > 1

    def _uniforms(self, state: SimState) -> torch.Tensor:
        """(rng_n,) uniforms from the generator, indexed by tag - 1."""
        return torch.rand(state.rng_n, generator=self.generator,
                          dtype=state.ucgvl.dtype, device=state.device)

    def _forces(self, state: SimState, nbr, run_window, pair_fn=None,
                scores_valid: bool = True):
        cfg = self.cfg
        u = cfg.u
        kw = {}
        if getattr(self.pair_params, "prior_mode",
                   None) == "chemical_potential_noise":
            # table_ucg_bethe's noisy first-step priors, drawn by tag
            kw["prior_u"] = self._uniforms(state)
        fout = (pair_fn or self.pair_compute)(state, nbr, self.pair_params,
                                              **kw)
        ucgforce = fout.ucgforce
        if cfg.langevin is not None:
            tT = fl.t_target(cfg.langevin, state.step, run_window[0],
                             run_window[1])
            ucgforce = ucgforce + fl.post_force(self._uniforms(state), state,
                                                tT, cfg.dt, u, cfg.langevin)
        if cfg.integrator.wall and cfg.integrator.bias_potential:
            bf = fi.bias_force(state.ucgl, cfg.integrator.barrier)
            g = fi.group_mask(cfg.integrator, state)
            if g is not None:
                bf = torch.where(g, bf, torch.zeros_like(bf))
            ucgforce = ucgforce + bf
        if cfg.ucgstate is not None and scores_valid:
            # score-free interior steps skip the update (ucgp refreshes on
            # the block's full-kernel step)
            mc_u = (self._uniforms(state) if cfg.ucgstate.mode == "mc"
                    else None)
            state = fs.post_force(state, fout.scores, self._is_ucg(state),
                                  cfg.ucgstate, mc_u)
        elif cfg.ucgstate is None and fout.ucgp is not None:
            # a style's own in-pass posterior (table_ucg_bethe_density)
            state = dataclasses.replace(state, ucgp=fout.ucgp)
        return state, dataclasses.replace(fout, ucgforce=ucgforce)

    def _step(self, state: SimState, fout_prev: ForceOut, nbr, run_window,
              pair_fn=None, scores_valid: bool = True):
        """One velocity-Verlet step."""
        cfg = self.cfg
        mass = self._masses_by_type[state.typ]
        state = fi.initial_integrate(state, fout_prev.f, fout_prev.ucgforce,
                                     mass, cfg.dt, cfg.u.ftm2v,
                                     cfg.integrator)
        state, fout = self._forces(state, nbr, run_window, pair_fn,
                                   scores_valid)
        if fout.ucgp is None and fout_prev.ucgp is not None:
            # score-free interior step of an in-pass-posterior style: carry
            # the posterior (the block's full step refreshes it)
            fout = dataclasses.replace(fout, ucgp=fout_prev.ucgp)
        state = fi.final_integrate(state, fout.f, fout.ucgforce, mass, cfg.dt,
                                   cfg.u.ftm2v, cfg.integrator)
        return dataclasses.replace(state, step=state.step + 1), fout

    # ---- one block: conditional reneighbor + nsteps of Verlet -------------

    def _rebuild(self, state: SimState):
        # PBC remap happens ONLY together with a rebuild (LAMMPS remaps at
        # reneighbor): the column list's ghost slots assume coordinates stay
        # continuous over the list's lifetime
        x_w, image = state.box.wrap(state.x, state.image)
        state = dataclasses.replace(state, x=x_w, image=image)
        return state, self._nbr_build(state)

    def _block(self, state: SimState, fcarry: ForceOut, run_window,
               nsteps: int, nbr=None):
        if nbr is None or bool(nbrmod.displacement_check(
                nbr, state.x, state.box, self.nbr_spec.skin)):
            state, nbr = self._rebuild(state)

        fast_fn = getattr(self.pair_compute, "fast_variant", None)
        fast_scores = True
        if fast_fn is not None and self._scores_inert:
            nos = getattr(self.pair_compute, "fast_variant_noscores", None)
            if nos is not None:
                fast_fn, fast_scores = nos, False
        fout = fcarry
        if fast_fn is not None and nsteps > 1:
            # LAMMPS eflag/vflag pattern: fast interior steps, full last step
            for _ in range(nsteps - 1):
                state, fout = self._step(state, fout, nbr, run_window,
                                         fast_fn, fast_scores)
            state, fout = self._step(state, fout, nbr, run_window)
        else:
            for _ in range(nsteps):
                state, fout = self._step(state, fout, nbr, run_window)
        danger = nbrmod.displacement_check(nbr, state.x, state.box,
                                           self.nbr_spec.skin)
        return state, fout, nbr, danger

    def _nbr_build(self, state: SimState):
        if isinstance(self.nbr_spec, colpack.ColumnSpec):
            return colpack.build(state.x, state.box, self.nbr_spec)
        if isinstance(self.nbr_spec, clusters.ClusterSpec):
            return clusters.build(state.x, state.box, self.nbr_spec)
        return nbrmod.build(state.x, state.box, self.nbr_spec)

    def _check_block(self, nbr, danger):
        if bool(nbr.overflow):
            raise RuntimeError(f"neighbor capacity exceeded (max "
                               f"occupancy {int(nbr.max_occupancy)})")
        if bool(danger):
            self.dangerous_builds += 1

    # ---- setup (Verlet::setup analogue) ----------------------------------

    def setup(self, run_window=(0, 0)):
        state, nbr = self._rebuild(self.state)
        if bool(nbr.overflow):
            raise RuntimeError(f"neighbor capacity exceeded at setup (max "
                               f"occupancy {int(nbr.max_occupancy)})")
        state, fout = self._forces(state, nbr, tuple(run_window))
        self.state, self._fcarry, self._nbr = state, fout, nbr
        return fout

    # ---- host-side run loops ---------------------------------------------

    def run(self, nsteps: int, thermo_every: int = 0):
        begin = self.state.step
        run_window = (begin, begin + nsteps)
        if self._fcarry is None:
            self.setup(run_window)
        done = 0
        while done < nsteps:
            todo = min(self.cfg.reneigh_every, nsteps - done)
            self.state, self._fcarry, self._nbr, danger = self._block(
                self.state, self._fcarry, run_window, todo, nbr=self._nbr)
            done += todo
            self._check_block(self._nbr, danger)
            if thermo_every and (done % thermo_every == 0 or done == nsteps):
                self.thermo_rows.append(self.thermo())
        return self.state

    def run_fused(self, nblocks: int, run_window=None):
        """Advance nblocks × reneigh_every steps (the bench / production
        loop): no thermo, one overflow read per block."""
        step = self.state.step
        if run_window is None:
            run_window = (step, step + nblocks * self.cfg.reneigh_every)
        run_window = tuple(int(v) for v in run_window)
        if self._fcarry is None:
            self.setup(run_window)
        for _ in range(nblocks):
            self.state, self._fcarry, self._nbr, danger = self._block(
                self.state, self._fcarry, run_window,
                self.cfg.reneigh_every, nbr=self._nbr)
            self._check_block(self._nbr, danger)
        return self.state

    # ---- observables ------------------------------------------------------

    def property_atom(self, name: str) -> np.ndarray:
        """Per-atom property in TAG order (``compute property/atom``
        analogue).  Names: ucgstate, ucgl, ucgvl, ucgml, ucgp, ucgforce,
        ucgsoftmaxscores, x, v, f, type, mol, q, id."""
        state, fout = self.state, self._fcarry
        arrays = {"x": state.x, "v": state.v, "type": state.typ,
                  "mol": state.mol, "q": state.q, "id": state.tag,
                  "ucgstate": state.ucgstate, "ucgl": state.ucgl,
                  "ucgvl": state.ucgvl, "ucgml": state.ucgml,
                  "ucgp": state.ucgp}
        if fout is not None:
            arrays.update({"f": fout.f, "ucgforce": fout.ucgforce,
                           "ucgsoftmaxscores": fout.scores})
        if name not in arrays:
            raise KeyError(f"unknown per-atom property {name!r}")
        order = np.argsort(state.tag.cpu().numpy())
        return arrays[name].cpu().numpy()[order]

    def thermo(self) -> dict:
        """All thermo scalars with one device→host transfer."""
        state, fout = self.state, self._fcarry
        cfg = self.cfg
        u = cfg.u
        n = state.n_atoms
        mass = self._masses_by_type[state.typ]
        ke = 0.5 * torch.sum(mass * torch.sum(state.v**2, dim=-1)) * u.mvv2e
        if cfg.integrator.wall and cfg.integrator.bias_potential:
            bias_e = torch.where(
                self._is_ucg(state),
                fi.bias_energy(state.ucgl, cfg.integrator.barrier),
                torch.zeros_like(state.ucgl))
            g = fi.group_mask(cfg.integrator, state)
            if g is not None:
                bias_e = torch.where(g, bias_e, torch.zeros_like(bias_e))
            pe_bias = torch.sum(bias_e)
        else:
            pe_bias = torch.zeros_like(fout.pe)
        ke_lambda = 0.5 * torch.sum(state.ucgml * state.ucgvl**2) * u.mvv2e
        vol = torch.prod(state.box.lengths)
        virial_tr = fout.virial[0] + fout.virial[1] + fout.virial[2]
        lam_t = fl.lambda_temperature(state, u)
        dt = torch.promote_types(ke.dtype, fout.pe.dtype)
        vals = [ke, fout.pe, pe_bias, ke_lambda, lam_t, vol, virial_tr]
        if fout.oob_low is not None:
            vals += [fout.oob_low, fout.oob_high]
        host = torch.stack([v.to(dt) for v in vals]).cpu().numpy()
        ke, pe, pe_bias, ke_lambda, lam_t, vol, virial_tr = (
            float(v) for v in host[:7])
        dof = max(3 * n - 3, 1)
        row = {
            "step": state.step,
            "temp": 2.0 * ke / (dof * u.boltz),
            "pe": pe + pe_bias,
            "ke": ke,
            "ke_lambda": ke_lambda,
            "lambda_temp": lam_t,
            "etotal": ke + pe + pe_bias + ke_lambda,
            "press": (2.0 * ke + virial_tr) / (3.0 * vol) * u.nktv2p,
        }
        if fout.oob_low is not None:
            row["oob_low"] = int(host[7])
            row["oob_high"] = int(host[8])
        return row
