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
them (``neigh_modify check yes``; ``reneigh_check=False`` rebuilds every
block).  On the kernel path the interior steps run a fast pair variant (no
pe/virial/oob; also no scores when nothing feeds them back) and the
block's last step runs the full kernel, so thermo always reads valid
observables.  The block loop runs on the host; the neighbor overflow and
danger flags are read once per block.

On the column path in float32 the interior steps are slot-major
(``_slot_ok``): per-atom state enters the column list's real-slot order
with one wide row gather, the pair entry's ``slot_fast`` variant fills the
kernels' inputs from it (``colpack.pack_slots``) and returns its rows in
that order, and one gather takes the state back to atom order for the
block's last, full step.  Every fix inside a block is elementwise and
draws by tag, so the trajectory is that of the atom-ordered interior.

Topology (``bonded``, ``excl_tags``): the bonded terms add to the pair
pass's ForceOut.  Special exclusions leave the reference path's lists at
the build; the kernels have no per-pair identity, so on the kernel path
they compute every in-cutoff pair and the driver subtracts the style's
``excl_delta`` over the special lists (styles without one raise).  The
density styles' entries (``takes_excl_rows``) take the lists themselves
(``excl_rows=``) and subtract each pass's sums, since ρ feeds the priors
of the next pass (:func:`excl_route`).  With
``respa_inner > 1`` the bonded terms move to the inner level of a two-level
r-RESPA, the full pair entry runs once per outer step, and thermo adds the
bonded pe and virial.  The molecular paths run atom-ordered.

``cluster_switch=(params, freq)``: the event of ``fix cluster_switch``
runs at the start of a block of :meth:`Simulation.run` whenever the step
is a multiple of ``freq``: it wraps the positions, builds its own contact
list (on the kernel path a cell list at the contact cutoff), relabels the
molecules and flips types, and the forces are recomputed.  ``run_fused``
fires no event, as in the JAX package.

Random state: ``Simulation`` draws the Langevin noise, the noisy Bethe
priors and the cluster_switch accept uniforms from ``generator`` and the
``ucgstate mc`` uniforms from ``mc_generator``, a stream of their own keyed
by ``seed`` and ``UCGStateCfg.seed``.  A caller that runs several
Simulations in sequence (the deck runner, one per ``run`` command) hands
them its generators, so the streams carry on.  :meth:`Simulation.carry`
and :meth:`Simulation.resume` take a run's force carry and list-build
positions out and back in, so a continuation resumes the same trajectory
bit for bit instead of re-running ``setup``.

``SimConfig.sort_atoms`` reorders the atoms by cell at each rebuild of
the reference path's cell list (the LAMMPS atom sort; tags keep each
atom's identity, the force carry is permuted with the rows);
``SimConfig.check_safety=False`` skips the per-block reads of the
neighbor overflow and danger flags and of the event's contact-list
overflow (the event's convergence error always raises).  The box volume
is ``prod(lengths)``, also for a restricted triclinic box.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core import units as units_mod
from lammps_ucg_dev_tpu_torch.core.state import ForceOut, SimState, System
from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as fcs
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.models import bonded as bd
from lammps_ucg_dev_tpu_torch.ops import clusters, colpack
from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod

CS_CHUNK = 65536   # atoms per candidate block of the event's contact list
CARRY_FIELDS = ("f", "ucgforce", "scores", "pe", "virial", "oob_low",
                "oob_high", "ucgp")


def mc_seed(seed: int, ucgstate_seed: int) -> int:
    """Seed of the ``ucgstate mc`` stream for a Simulation seed and the
    fix's SEED: distinct pairs give distinct streams."""
    h = hashlib.sha256(f"ucgstate-mc:{seed}:{ucgstate_seed}".encode())
    return int.from_bytes(h.digest()[:8], "little") & (2**63 - 1)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float
    units: str = "lj"
    integrator: fi.IntegratorCfg = fi.IntegratorCfg()
    langevin: fl.LangevinCfg | None = None
    vlangevin: fl.VLangevinCfg | None = None   # stock velocity thermostat
    ucgstate: fs.UCGStateCfg | None = None
    reneigh_every: int = 10
    reneigh_check: bool = True    # neigh_modify check yes|no: rebuild at a
                                  # block start only when the displacement
                                  # check asks for it (True) or always
    respa_inner: int = 1          # r-RESPA inner steps: bonded forces at the
                                  # fast level, pair at the outer one
                                  # (fix_nve_ucgld.cpp:155-173 + stock Respa)
    check_safety: bool = True     # read the overflow and danger flags
                                  # every block
    sort_atoms: bool = False      # reorder atoms by cell at a rebuild of the
                                  # reference path's cell list (LAMMPS atom
                                  # sort; identity kept by SimState.tag)

    @property
    def u(self) -> units_mod.UnitSystem:
        return units_mod.get(self.units)

    @property
    def kT(self) -> float:
        """Thermostat target kT seen by pair styles at init ("any
        thermostat fix", pair_table_ucgld.cpp:872-881): the λ-Langevin's,
        else the velocity Langevin's, else 0."""
        if self.langevin is not None:
            return self.u.boltz * self.langevin.t_start
        if self.vlangevin is not None:
            return self.u.boltz * self.vlangevin.t_start
        return 0.0



def excl_route(pair_compute) -> str | None:
    """How a kernel path's pair entry leaves the special pairs out:
    ``"rows"`` when the entry takes the lists itself (``excl_rows=``; the
    density styles, whose ρ feeds the priors, subtract each pass's sums
    over them), ``"delta"`` when the driver subtracts its ``excl_delta``
    from the result, None when it cannot."""
    if getattr(pair_compute, "takes_excl_rows", False):
        return "rows"
    if getattr(pair_compute, "excl_delta", None) is not None:
        return "delta"
    return None


class Simulation:
    """Assembles state + pair style + fixes into a stepper.

    ``pair_compute(state, nbr, params) -> ForceOut`` is the pair-style
    entry; ``nbr_spec`` is a NeighborSpec (reference pair path, nsq or
    cell), a colpack.ColumnSpec (the column kernels) or a
    clusters.ClusterSpec (K8's cluster list).  ``seed`` seeds the generator that
    draws the Langevin noise, the noisy Bethe priors and the cluster_switch
    accept draws, unless ``generator`` hands in one to draw from; the
    ``ucgstate mc`` uniforms come from ``mc_generator``, else from one
    seeded by :func:`mc_seed` of ``seed`` and the fix's seed.
    ``extra_post_force(state, ucgforce, fout) -> (state, ucgforce)`` runs
    after the bias force and before ``ucgstate``; it may read anything, so
    it turns off the score-free interior and the slot-major interior.
    ``bonded`` (``models.bonded.BondedParams``) and ``excl_tags`` ((N, S)
    special-partner tags, ``bonded.special_tags``) add the topology;
    ``cluster_switch=(params, freq)`` the event of ``fix cluster_switch``,
    whose logs go to ``log_dir``."""

    def __init__(self, system: System, state: SimState,
                 pair_compute: Callable, pair_params: Any, nbr_spec,
                 cfg: SimConfig, seed: int = 0,
                 extra_post_force: Callable | None = None,
                 cluster_switch: tuple | None = None,
                 log_dir: str | None = None,
                 bonded: bd.BondedParams | None = None,
                 excl_tags: np.ndarray | None = None,
                 generator: torch.Generator | None = None,
                 mc_generator: torch.Generator | None = None):
        self.system = system
        self.state = state
        self.pair_compute = pair_compute
        self.pair_params = pair_params
        self.nbr_spec = nbr_spec
        self.cfg = cfg
        self.extra_post_force = extra_post_force
        self.seed = seed
        for g in (generator, mc_generator):
            if g is not None and g.device.type != state.device.type:
                raise ValueError(f"a generator on {g.device} for a state on "
                                 f"{state.device}")
        if generator is None:
            generator = torch.Generator(device=state.device)
            generator.manual_seed(seed)
        self.generator = generator
        self.mc_generator = mc_generator
        self._masses_by_type = torch.as_tensor(
            np.asarray(system.masses, np.float64), dtype=state.x.dtype,
            device=state.device)
        # the kernel paths (column or cluster lists) against the reference
        # path's atom neighbor lists
        self._is_kernel = not isinstance(nbr_spec, nbrmod.NeighborSpec)
        self.bonded = bonded
        if excl_tags is not None and not np.any(excl_tags):
            excl_tags = None                     # nothing excluded
        self.excl_tags = (None if excl_tags is None else torch.as_tensor(
            np.asarray(excl_tags), dtype=torch.int64, device=state.device))
        self._excl_route = excl_route(pair_compute)
        if (self.excl_tags is not None and self._is_kernel
                and self._excl_route is None):
            raise NotImplementedError(
                "special exclusions on a kernel path need the style's "
                "excl_delta (compute-and-subtract): the four column "
                "styles have one; use the reference path (a NeighborSpec) "
                "for other styles")
        # the kernel path's special lists as rows: its rows never permute,
        # so the tag→row map is fixed
        self._excl_rows_static = (self._excl_rows(state)
                                  if self.excl_tags is not None
                                  and self._is_kernel else None)
        # slot-major interior: the column path in f32 (the kernels' input
        # dtype) whose pair entry has a slot variant, with no atom-space
        # extra_post_force and no topology
        self._slot_ok = (isinstance(nbr_spec, colpack.ColumnSpec)
                         and extra_post_force is None
                         and state.x.dtype == torch.float32
                         and bonded is None and self.excl_tags is None
                         and getattr(pair_compute, "slot_fast",
                                     None) is not None)
        self.cswitch = cluster_switch
        self.log_dir = log_dir
        self.cswitch_stats = None
        self._cs_spec = None
        if cluster_switch is not None:
            params_cs, freq = cluster_switch
            if freq % cfg.reneigh_every != 0:
                raise ValueError(
                    "cluster_switch frequency must be a multiple of "
                    f"reneigh_every (got {freq} vs {cfg.reneigh_every})")
            self.cswitch_stats = fcs.ClusterSwitchStats.zeros(
                state.x.dtype, state.device)
            if self._is_kernel:
                # the kernels own the pair path; the event builds its own
                # contact list at the contact cutoff (the reference reuses
                # the pair half-list, fix_cluster_switch.cpp:537-560)
                self._cs_spec = nbrmod.make_spec(
                    state.n_atoms,
                    state.box.lengths.cpu().numpy().astype(np.float64),
                    float(np.sqrt(float(params_cs.cutsq))), 0.0,
                    method="cell", chunk=CS_CHUNK)
        self._fcarry: ForceOut | None = None
        self._nbr = None
        self.thermo_rows: list[dict] = []
        self.dangerous_builds = 0

    @property
    def _scores_inert(self) -> bool:
        """Scores are dynamically inert when nothing turns them into state
        that feeds back into forces: no fix ucgstate, or 'ld' mode (ucgp is
        observable-only there; fix_ucgstate.cpp:52-54), and no
        extra_post_force that could read them.  Read from ``cfg`` at each
        block, so a changed ``cfg`` takes effect."""
        ucgstate = self.cfg.ucgstate
        return ((ucgstate is None or ucgstate.mode == "ld")
                and self.extra_post_force is None)

    # ---- one force evaluation + post-force fixes -------------------------

    def _is_ucg(self, state: SimState) -> torch.Tensor:
        tp = getattr(self.pair_params, "tp", None)
        if tp is None:
            # styles without per-type UCG params (table_rleucg_interface)
            return torch.ones(state.n_atoms, dtype=torch.bool,
                              device=state.device)
        return tp.n_states[state.typ] > 1

    def _uniforms(self, state: SimState, *shape: int) -> torch.Tensor:
        """(rng_n, *shape) uniforms from the generator, indexed by
        tag - 1."""
        return torch.rand((state.rng_n, *shape), generator=self.generator,
                          dtype=state.ucgvl.dtype, device=state.device)

    def _mc_uniforms(self, state: SimState) -> torch.Tensor:
        """(rng_n,) uniforms of the ``ucgstate mc`` stream."""
        if self.mc_generator is None:
            self.mc_generator = torch.Generator(device=state.device)
            self.mc_generator.manual_seed(mc_seed(self.seed,
                                                  self.cfg.ucgstate.seed))
        return torch.rand((state.rng_n,), generator=self.mc_generator,
                          dtype=state.ucgvl.dtype, device=state.device)

    def _excl_rows(self, state: SimState) -> torch.Tensor:
        """The special-tag lists of each row as rows (n where empty)."""
        n = state.n_atoms
        tag = state.tag.long() - 1
        inv = torch.zeros(n, dtype=torch.int64, device=state.device)
        inv[tag] = torch.arange(n, device=state.device)
        et = self.excl_tags[tag]
        return torch.where(et > 0, inv[torch.clamp(et - 1, 0, n - 1)], n)

    def _forces(self, state: SimState, nbr, run_window, pair_fn=None,
                scores_valid: bool = True, topo: dict | None = None):
        """The pair pass, the topology and the post-force fixes.  ``topo``:
        a spatial driver's per-block topology of this rank's rows,
        ``{"excl_rows", "rows", "nloc"}`` (``excl_rows`` on the kernel path
        only; ``parallel/spatial.py``); None on one device, where the
        special rows are static and the bonded terms map their tags
        themselves."""
        cfg = self.cfg
        u = cfg.u
        kw = {}
        if getattr(self.pair_params, "prior_mode",
                   None) == "chemical_potential_noise":
            # table_ucg_bethe's noisy first-step priors, drawn by tag
            kw["prior_u"] = self._uniforms(state)
        excl = (self._excl_rows_static if topo is None
                else topo.get("excl_rows"))
        fout = self._pair_pass(state, nbr, pair_fn or self.pair_compute, kw,
                               excl)
        if self.bonded is not None and cfg.respa_inner == 1:
            # Verlet: the bonded terms fold into the pair pass (under
            # r-RESPA they live at the inner level, _block)
            bf, bpe, bvir = (
                bd.compute(state, self.bonded) if topo is None
                else bd.compute_spatial(state, self.bonded, topo["rows"],
                                        topo["nloc"]))
            fout = dataclasses.replace(fout, f=fout.f + bf, pe=fout.pe + bpe,
                                       virial=fout.virial + bvir)
        ucgforce = fout.ucgforce
        if cfg.langevin is not None:
            tT = fl.t_target(cfg.langevin, state.step, run_window[0],
                             run_window[1])
            ucgforce = ucgforce + fl.post_force(self._uniforms(state), state,
                                                tT, cfg.dt, u, cfg.langevin)
        if cfg.vlangevin is not None:
            # stock fix langevin on the velocities (post_force; drag and
            # kick enter neither pe nor the virial)
            tTv = fl.t_target(cfg.vlangevin, state.step, run_window[0],
                              run_window[1])
            mass = self._masses_by_type[state.typ]
            fout = dataclasses.replace(fout, f=fout.f + fl.post_force_v(
                self._uniforms(state, 3), state, mass, tTv, cfg.dt, u,
                cfg.vlangevin))
        if cfg.integrator.wall and cfg.integrator.bias_potential:
            bf = fi.bias_force(state.ucgl, cfg.integrator.barrier)
            g = fi.group_mask(cfg.integrator, state)
            if g is not None:
                bf = torch.where(g, bf, torch.zeros_like(bf))
            ucgforce = ucgforce + bf
        if self.extra_post_force is not None:
            state, ucgforce = self.extra_post_force(state, ucgforce, fout)
        if cfg.ucgstate is not None and scores_valid:
            # score-free interior steps skip the update (ucgp refreshes on
            # the block's full-kernel step)
            mc_u = (self._mc_uniforms(state) if cfg.ucgstate.mode == "mc"
                    else None)
            state = fs.post_force(state, fout.scores, self._is_ucg(state),
                                  cfg.ucgstate, mc_u)
        elif cfg.ucgstate is None and fout.ucgp is not None:
            # a style's own in-pass posterior (table_ucg_bethe_density)
            state = dataclasses.replace(state, ucgp=fout.ucgp)
        return state, dataclasses.replace(fout, ucgforce=ucgforce)

    def _pair_pass(self, state: SimState, nbr, pair_fn, kw: dict,
                   excl: torch.Tensor | None) -> ForceOut:
        """The pair entry ``pair_fn`` with the special partners ``excl``
        ((N, S) rows, N where empty; None without exclusions on the kernel
        path) left out, by the entry's own route (``excl_route``)."""
        in_pass = self._excl_route == "rows"
        pkw = dict(kw, excl_rows=excl) if excl is not None and in_pass else kw
        fout = pair_fn(state, nbr, self.pair_params, **pkw)
        if excl is not None and not in_pass:
            # the kernel computed every in-cutoff pair, the special
            # partners too: subtract them, in the kernel's own functional
            d = self.pair_compute.excl_delta(state, excl, self.pair_params,
                                             **kw)
            fout = dataclasses.replace(
                fout, f=fout.f - d.f, ucgforce=fout.ucgforce - d.ucgforce,
                scores=fout.scores - d.scores, pe=fout.pe - d.pe,
                virial=fout.virial - d.virial,
                oob_low=(None if fout.oob_low is None
                         else fout.oob_low - d.oob_low))
        return fout

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

    # ---- the slot-major interior ------------------------------------------

    def _to_slots(self, state: SimState, fcarry: ForceOut, nbr):
        """(state, fcarry) in the column list's real-slot order, pad rows
        poisoned (x at ``colpack._PAD_POISON``, ucgml 1, ucgp -1, tag and
        typ 1), with one float row gather and one int row gather.  Float
        columns: 0:3 x | 3:6 v | 6 ucgl | 7 ucgvl | 8 ucgml | 9 ucgp |
        10:13 f | 13 ucgforce | 14:16 scores | 16 the in-pass ucgp, when
        the style has one.  Int columns: tag typ ucgstate.  q, mol and
        image stay in atom order: no step inside a block reads them, and
        the block's last step takes them from the atom-ordered state."""
        n, dev = state.n_atoms, state.device
        sar = colpack.slot_atom_real(nbr, n)
        fl_cols = [state.x, state.v, state.ucgl[:, None],
                   state.ucgvl[:, None], state.ucgml[:, None],
                   state.ucgp[:, None], fcarry.f,
                   fcarry.ucgforce[:, None], fcarry.scores]
        if fcarry.ucgp is not None:
            fl_cols.append(fcarry.ucgp[:, None])
        M = torch.cat(fl_cols, 1)
        pad = torch.zeros((1, M.shape[1]), dtype=M.dtype, device=dev)
        pad[0, 0:3] = colpack._PAD_POISON
        pad[0, 8] = 1.0
        pad[0, 9] = -1.0
        Ms = torch.cat([M, pad])[sar]                       # (n_slots, 16+)
        ints = torch.stack([state.tag, state.typ, state.ucgstate],
                           1)                                # all int32
        ipad = torch.zeros((1, 3), dtype=ints.dtype, device=dev)
        ipad[0, 0:2] = 1
        Is = torch.cat([ints, ipad])[sar]                   # (n_slots, 3)

        def c(t, a, b=None):
            return (t[:, a] if b is None else t[:, a:b]).contiguous()

        slot_state = dataclasses.replace(
            state, x=c(Ms, 0, 3), v=c(Ms, 3, 6), ucgl=c(Ms, 6),
            ucgvl=c(Ms, 7), ucgml=c(Ms, 8), ucgp=c(Ms, 9), tag=c(Is, 0),
            typ=c(Is, 1), ucgstate=c(Is, 2), n_total=state.rng_n)
        slot_fout = dataclasses.replace(
            fcarry, f=c(Ms, 10, 13), ucgforce=c(Ms, 13), scores=c(Ms, 14, 16),
            ucgp=c(Ms, 16) if fcarry.ucgp is not None else None)
        return slot_state, slot_fout

    def _from_slots(self, state: SimState, slot_state: SimState,
                    slot_fout: ForceOut, nbr):
        """The dynamic fields back in atom order, with one float and one int
        gather.  Float columns: 0:3 x | 3:6 v | 6 ucgl | 7 ucgvl | 8 ucgp |
        9:12 f | 12 ucgforce | 13:15 scores | 15 the in-pass ucgp."""
        ss, sf = slot_state, slot_fout
        cols = [ss.x, ss.v, ss.ucgl[:, None], ss.ucgvl[:, None],
                ss.ucgp[:, None], sf.f, sf.ucgforce[:, None], sf.scores]
        if sf.ucgp is not None:
            cols.append(sf.ucgp[:, None])
        Et = torch.cat(cols, 1)[nbr.atom_slot]              # (N, 15+)

        def c(a, b=None):
            return (Et[:, a] if b is None else Et[:, a:b]).contiguous()

        state = dataclasses.replace(
            state, x=c(0, 3), v=c(3, 6), ucgl=c(6), ucgvl=c(7), ucgp=c(8),
            ucgstate=ss.ucgstate[nbr.atom_slot], step=ss.step)
        fout = dataclasses.replace(
            sf, f=c(9, 12), ucgforce=c(12), scores=c(13, 15),
            ucgp=c(15) if sf.ucgp is not None else None)
        return state, fout

    def _slot_interior(self, state: SimState, fcarry: ForceOut, nbr,
                       run_window, k: int, slot_fn, scores_valid: bool):
        """k interior Verlet steps with the per-atom state resident in the
        column list's real-slot order: one wide gather in, the kernels read
        the slot arrays (``colpack.pack_slots``) and their rows feed the
        integrator with no reordering, one wide gather out."""
        slot_state, slot_fout = self._to_slots(state, fcarry, nbr)
        for _ in range(k):
            slot_state, slot_fout = self._step(slot_state, slot_fout, nbr,
                                               run_window, slot_fn,
                                               scores_valid)
        return self._from_slots(state, slot_state, slot_fout, nbr)

    # ---- one block: conditional reneighbor + nsteps of Verlet -------------

    def _rebuild(self, state: SimState, fcarry: ForceOut | None = None):
        """(state, fcarry, list) after the PBC wrap and a rebuild; with
        ``sort_atoms`` on the reference path's cell list, the rows (and the
        per-atom rows of ``fcarry``) in cell order first.  ``setup``
        passes no carry and keeps the order, as in the JAX package."""
        # PBC remap happens ONLY together with a rebuild (LAMMPS remaps at
        # reneighbor): the column list's ghost slots assume coordinates stay
        # continuous over the list's lifetime
        x_w, image = state.box.wrap(state.x, state.image)
        state = dataclasses.replace(state, x=x_w, image=image)
        if (self.cfg.sort_atoms and fcarry is not None
                and getattr(self.nbr_spec, "method", None) == "cell"):
            cps = np.asarray(self.nbr_spec.cells_per_side)
            cid, _ = nbrmod.cell_index(state.x, state.box, cps)
            order = torch.sort(cid, stable=True).indices
            state = state.permute(order)
            fcarry = dataclasses.replace(fcarry, **{
                k: getattr(fcarry, k)[order]
                for k in ("f", "ucgforce", "scores", "ucgp")
                if getattr(fcarry, k) is not None})
        return state, fcarry, self._nbr_build(state)

    def _block(self, state: SimState, fcarry: ForceOut, run_window,
               nsteps: int, nbr=None):
        cfg = self.cfg
        if (nbr is None or not cfg.reneigh_check
                or bool(nbrmod.displacement_check(nbr, state.x, state.box,
                                                  self.nbr_spec.skin))):
            state, fcarry, nbr = self._rebuild(state, fcarry)
        if cfg.respa_inner > 1:
            state, fout = self._respa(state, fcarry, nbr, run_window, nsteps)
            danger = nbrmod.displacement_check(nbr, state.x, state.box,
                                               self.nbr_spec.skin)
            return state, fout, nbr, danger

        fast_fn = getattr(self.pair_compute, "fast_variant", None)
        fast_scores = True
        if fast_fn is not None and self._scores_inert:
            nos = getattr(self.pair_compute, "fast_variant_noscores", None)
            if nos is not None:
                fast_fn, fast_scores = nos, False
        fout = fcarry
        if self._slot_ok and nsteps > 1:
            # slot-major interior, then the full kernel in atom order
            slot_fn = self.pair_compute.slot_fast
            if not fast_scores:
                slot_fn = getattr(self.pair_compute, "slot_fast_noscores",
                                  slot_fn)
            state, fout = self._slot_interior(state, fout, nbr, run_window,
                                              nsteps - 1, slot_fn,
                                              fast_scores)
            state, fout = self._step(state, fout, nbr, run_window)
        elif fast_fn is not None and nsteps > 1:
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

    def _respa(self, state: SimState, fout: ForceOut, nbr, run_window,
               nsteps: int):
        """nsteps outer r-RESPA steps: the pair forces (the full pair entry,
        every outer step) kick at the outer level, ``respa_inner`` inner
        Verlet steps of dt/respa_inner move x and λ under the bonded
        forces."""
        cfg = self.cfg
        if self.bonded is None:
            raise ValueError("respa_inner > 1 requires bonded terms (the "
                             "fast level)")

        def bonded_f(st):
            return bd.compute(st, self.bonded)[0]

        dt_in = cfg.dt / cfg.respa_inner
        ftm2v = cfg.u.ftm2v
        fbond = bonded_f(state)
        for _ in range(nsteps):
            mass = self._masses_by_type[state.typ]
            state = fi.respa_outer_initial(state, fout.f, fout.ucgforce, mass,
                                           cfg.dt, ftm2v, cfg.integrator)
            for _ in range(cfg.respa_inner):
                state, fbond = fi.respa_inner_step(
                    state, fbond, mass, dt_in, ftm2v, cfg.integrator,
                    bonded_f)
            state, fout = self._forces(state, nbr, run_window)
            state = fi.respa_outer_final(state, fout.f, fout.ucgforce, mass,
                                         cfg.dt, ftm2v, cfg.integrator)
            state = dataclasses.replace(state, step=state.step + 1)
        return state, fout

    def _nbr_build(self, state: SimState):
        if isinstance(self.nbr_spec, colpack.ColumnSpec):
            return colpack.build(state.x, state.box, self.nbr_spec)
        if isinstance(self.nbr_spec, clusters.ClusterSpec):
            return clusters.build(state.x, state.box, self.nbr_spec)
        excl = (None if self.excl_tags is None
                else self._excl_rows(state))
        return nbrmod.build(state.x, state.box, self.nbr_spec, excl=excl)

    def _check_block(self, nbr, danger):
        if bool(nbr.overflow):
            raise RuntimeError(f"neighbor capacity exceeded (max "
                               f"occupancy {int(nbr.max_occupancy)})")
        if bool(danger):
            self.dangerous_builds += 1

    # ---- the cluster_switch event (PRE_EXCHANGE analogue) -----------------

    def _cswitch_event(self, state: SimState, stats, u: torch.Tensor):
        """One event on ``state`` with the accept uniforms ``u``: wrap, the
        contact list (the event's own on the kernel path, the pair list's
        spec on the reference path, without exclusions), ``apply``.
        Returns (state, stats, info); info adds ``nbr_overflow``."""
        params_cs, _ = self.cswitch
        x_w, image = state.box.wrap(state.x, state.image)
        state = dataclasses.replace(state, x=x_w, image=image)
        spec = self._cs_spec if self._is_kernel else self.nbr_spec
        nbr = nbrmod.build(state.x, state.box, spec)
        state, stats, info = fcs.apply(u, state, nbr, params_cs, stats)
        return state, stats, dict(info, nbr_overflow=nbr.overflow)

    def _cs_draws(self, params_cs) -> torch.Tensor:
        """An event's accept uniforms, one per molecule slot, from the
        replicated generator."""
        return torch.rand(params_cs.maxmol + 1, generator=self.generator,
                          dtype=params_cs.probON.dtype,
                          device=self.state.device)

    def _maybe_cluster_switch(self):
        if self.cswitch is None:
            return
        params_cs, freq = self.cswitch
        step = self.state.step
        if step == 0 or step % freq != 0:
            return
        self.state, self.cswitch_stats, info = self._cswitch_event(
            self.state, self.cswitch_stats, self._cs_draws(params_cs))
        if self.cfg.check_safety and bool(info["nbr_overflow"]):
            raise RuntimeError("cluster_switch contact-list capacity exceeded")
        self._finish_event(info, step)
        self._fcarry = None           # the types changed: recompute forces

    def _finish_event(self, info: dict, step: int):
        """The event's epilogue: the convergence error, then the event logs
        (fix_cluster_switch.cpp:704-725) when ``log_dir`` is set."""
        if not info["converged"]:
            raise RuntimeError(
                "cluster_switch label propagation hit max_sweeps without "
                "converging: cluster labels may be wrong (raise max_sweeps)")
        if self.log_dir is not None:
            for name, v in (("cluster_assignment", info["in_cluster"]),
                            ("state_assignment", info["mol_state"])):
                with open(f"{self.log_dir}/{name}.log", "a") as fh:
                    fh.write(f"{step} " + " ".join(
                        map(str, v.long().cpu().tolist())) + "\n")

    # ---- setup (Verlet::setup analogue) ----------------------------------

    def setup(self, run_window=(0, 0)):
        state, _, nbr = self._rebuild(self.state)
        if bool(nbr.overflow):
            raise RuntimeError(f"neighbor capacity exceeded at setup (max "
                               f"occupancy {int(nbr.max_occupancy)})")
        state, fout = self._forces(state, nbr, tuple(run_window))
        self.state, self._fcarry, self._nbr = state, fout, nbr
        return fout

    def carry(self) -> dict:
        """What a continuation needs to resume this run exactly: the force
        carry ({name: tensor} of ``CARRY_FIELDS`` that are set) and
        ``x_build``, the positions the current list was built from."""
        if self._fcarry is None or self._nbr is None:
            raise RuntimeError("no run to carry: call setup or run first")
        rec = {k: getattr(self._fcarry, k) for k in CARRY_FIELDS
               if getattr(self._fcarry, k) is not None}
        rec["x_build"] = self._nbr.x0
        return rec

    def resume(self, record: dict):
        """Continue from :meth:`carry` of a run that reached this state:
        the list is rebuilt from the recorded build positions (every build
        is a deterministic function of them) and the recorded forces carry
        into the next step, so the trajectory goes on as if it had never
        stopped.  Nothing is drawn."""
        dev = self.state.device
        fields = {k: torch.as_tensor(record[k], device=dev)
                  for k in CARRY_FIELDS if k in record}
        x_build = torch.as_tensor(record["x_build"], device=dev)
        if x_build.shape != self.state.x.shape:
            raise ValueError("the carry record is of another system")
        nbr = self._nbr_build(dataclasses.replace(self.state, x=x_build))
        if bool(nbr.overflow):
            raise RuntimeError(f"neighbor capacity exceeded at resume (max "
                               f"occupancy {int(nbr.max_occupancy)})")
        self._fcarry, self._nbr = ForceOut(**fields), nbr

    # ---- host-side run loops ---------------------------------------------

    def run(self, nsteps: int, thermo_every: int = 0,
            thermo_callback: Callable | None = None):
        """Advance ``nsteps`` (blocks of ``reneigh_every``, the
        cluster_switch event at its cadence); with ``thermo_every`` append a
        thermo row every that many steps and at the end, and hand each to
        ``thermo_callback``."""
        begin = self.state.step
        run_window = (begin, begin + nsteps)
        if self._fcarry is None:
            self.setup(run_window)
        done = 0
        while done < nsteps:
            self._maybe_cluster_switch()
            if self._fcarry is None:
                self.setup(run_window)
            todo = min(self.cfg.reneigh_every, nsteps - done)
            self.state, self._fcarry, self._nbr, danger = self._block(
                self.state, self._fcarry, run_window, todo, nbr=self._nbr)
            done += todo
            if self.cfg.check_safety:
                self._check_block(self._nbr, danger)
            if thermo_every and (done % thermo_every == 0 or done == nsteps):
                row = self.thermo()
                self.thermo_rows.append(row)
                if thermo_callback is not None:
                    thermo_callback(row)
        return self.state

    def run_fused(self, nblocks: int, run_window=None):
        """Advance nblocks × reneigh_every steps (the bench / production
        loop): no thermo, one overflow read per block, and, as in the JAX
        package, no cluster_switch event."""
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
            if self.cfg.check_safety:
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
        pe, virial = fout.pe, fout.virial
        if self.bonded is not None and cfg.respa_inner > 1:
            # under r-RESPA the pair pass holds no bonded terms
            _, bpe, bvir = bd.compute(state, self.bonded)
            pe, virial = pe + bpe, virial + bvir
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
            pe_bias = torch.zeros_like(pe)
        ke_lambda = 0.5 * torch.sum(state.ucgml * state.ucgvl**2) * u.mvv2e
        vol = torch.prod(state.box.lengths)
        virial_tr = virial[0] + virial[1] + virial[2]
        lam_t = fl.lambda_temperature(state, u)
        dt = torch.promote_types(ke.dtype, pe.dtype)
        vals = [ke, pe, pe_bias, ke_lambda, lam_t, vol, virial_tr]
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
