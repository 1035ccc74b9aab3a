"""LAMMPS input-script compatibility layer (port of
``lammps_ucg_dev_tpu/compat/script.py``): the deck entry point.

The reference package has no CLI of its own — its entire user surface is
LAMMPS input-script commands plus side files (SURVEY.md §5 "Config / flag
system").  :class:`ScriptRunner` interprets the subset of that grammar the
UCG package touches, so a reference input deck drives the port directly:

    ScriptRunner(workdir).run_file("in.deck")            # on the card
    ScriptRunner(workdir, device="cpu").run_file(...)    # on the CPU

    units / dimension / boundary / atom_style / processors Px Py 1
    read_data / write_data / read_restart / write_restart
    mass, timestep, neighbor, neigh_modify, velocity
    pair_style  table_ucgld | table_ucg_bethe | table_ucg_bethe_density |
                table_rleucg_interface   lookup | linear | spline | bitmap N
                (with their keyword grammars,
                pair_table_ucgld.cpp:654-716, pair_table_ucg_bethe.cpp:746-886)
    pair_coeff  (multi-table UCG grammar, pair_table_ucgld.cpp:719-746;
                stock single-table grammar for rleucg_interface)
    fix         nve/ucgld | nve/ucgld/wall/hard [bias_potential H] |
                ucgld/langevin Tstart Tstop Tperiod seed |
                nve | langevin Tstart Tstop damp seed |
                ucgstate [ld | mc seed rate] |
                cluster_switch molID_seed mol_offset cutoff seed rateFreq N
                               rateFile f contactFile f
    unfix, bond/angle/dihedral/improper_style + _coeff (harmonic),
    special_bonds (0/1 weights), run_style verlet | respa (2-level)
    group ID type|id|molecule ... (per-atom masks honored by the fixes)
    dump / dump_modify thresh / undump, thermo / thermo_style
    run N / rerun, log / print / echo / variable (minimal)

Each ``run`` builds a ``Simulation`` and selects the style's hand-written
kernels through ``ops/kernel_select.select_pair_kernel`` (on a CUDA device
in float32, for an orthogonal box and a LINEAR, SPLINE or BITMAP table
that fits; on the CPU it declines and the reference pair path runs); one
log line names the pair path taken.  A tilted box (``read_data`` with an
``xy xz yz`` line, or a restart with a tilt) switches the neighbor method
to ``nsq``.  Special exclusions run on the reference path, whose list
leaves the specials out, where the selection declines (the CPU); on the
kernels the style's ``excl_delta`` subtracts them (the density styles
pass by pass, ``hopper_density.compute_density``).

``processors Px Py 1`` above one subdomain runs the spatial slab
(``Py`` 1) or pencil driver (``parallel/spatial.py``) over the process
group the caller initialised, whose size must be ``Px·Py`` (``*`` for Px
is the group's size); every rank runs the same deck, topology,
``fix cluster_switch`` and r-RESPA included.  A tilted box, or a grid the
slabs and pencils cannot cut (fewer than 3 cuts on an axis, subdomains
narrower than cutoff + skin), falls back to the atom decomposition
(``parallel/domain.py``) with a log line.  Thermo rows, the log, dumps,
the event logs, ``write_data`` and ``write_restart`` come from rank 0
after the run gathers the system; a ``rerun`` sets each snapshot on every
rank.  A spatial run's carry is each rank's own (its rows), so the next
``run`` on the same ranks continues it; ``write_restart`` stores no such
carry.

Random state (the port's own, not the JAX package's threefry key, F1).  The
runner owns the generators: one for the Langevin noise, the noisy Bethe
priors and the cluster_switch draws, seeded at the first run from the
deck's thermostat seed (``fix ucgld/langevin``, else ``fix langevin``, else
0), and the ``ucgstate mc`` generator, which the first run's
``Simulation`` seeds from that seed and the fix's own
(``runtime.sim.mc_seed``) and the runner keeps until the fix's seed
changes.  Every ``run`` draws on from where the last stopped.  A run also
leaves its force carry behind (``Simulation.carry``): the next ``run``
resumes from it instead of re-running ``setup`` when nothing that defines
the physics changed in between (the pair style and coefficients, the
fixes and groups, timestep, neighbor settings, masses, topology styles)
and the state was not replaced (``read_data``, ``velocity``, ``rerun``).
``write_restart`` stores the generators' states and that carry as
``extra_`` entries, so ``read_restart`` and the same styles continue the
trajectory bit for bit.  A restart without them (the JAX package's)
restarts the streams from the deck's seed, with a log line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shlex

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core import units as units_mod
from lammps_ucg_dev_tpu_torch.core.state import (Box, SimState, System,
                                                resolve_device)
from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as fcs
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.io import data as dio
from lammps_ucg_dev_tpu_torch.io import dump as dmp
from lammps_ucg_dev_tpu_torch.io import restart as rst
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.models import bonded as bd
from lammps_ucg_dev_tpu_torch.models import registry
from lammps_ucg_dev_tpu_torch.models.typemap import (RLEUCGBuilder,
                                                     TablePairBuilder)
from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.parallel import domain, spatial
from lammps_ucg_dev_tpu_torch.runtime.sim import (SimConfig, Simulation,
                                                   excl_route)

# the kernel path's pair entries (ops/hopper_*.py) -> the kernels they run
KERNEL_PATHS = {
    "compute_style": "K1 (csrc/ucgld_pair.cu)",
    "compute_style_bethe": "K2 (csrc/bethe_pair.cu)",
    "compute_style_density": "K5 -> K3 -> K6 (csrc/density_cv.cu, "
                             "csrc/bethe_pair.cu)",
    "compute_style_rleucg": "K5 -> K4 -> K6 (csrc/density_cv.cu, "
                            "csrc/bethe_pair.cu)",
}

# commands that replace the per-atom state: the next run starts afresh
_STATE_COMMANDS = {"read_data", "read_restart", "velocity", "rerun"}


@dataclasses.dataclass
class _Dump:
    writer: dmp.DumpWriter
    every: int
    group: str = "all"


@dataclasses.dataclass
class _PendingPair:
    style: str
    tabstyle: str
    tablength: int
    settings: object = None
    method: str = "bethe"
    pseudo: bool = True
    prior_mode: str = "ucgl"
    noise_level: float = 0.0
    noise_seed: int = 0
    pair_cv: str = "conservative"        # bethe_density CV back-force mode
    backforce_derivative: bool = True    # bethe_density dw/dr vs w/r
    args: list = dataclasses.field(default_factory=list)
    coeffs: list = dataclasses.field(default_factory=list)


def _mask_key(m) -> str | None:
    if m is None:
        return None
    return hashlib.sha256(np.ascontiguousarray(m, bool).tobytes()).hexdigest()


def _cfg_key(cfg):
    """A dataclass config as JSON-able data, its group mask hashed."""
    if cfg is None:
        return None
    return [(f.name, _mask_key(getattr(cfg, f.name)) if f.name == "group"
             else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)]


class ScriptRunner:
    """Interprets an input deck; holds the building simulation.  Builds on
    the CUDA device unless given ``device="cpu"``; raises without a GPU."""

    def __init__(self, workdir: str = ".", dtype=torch.float32,
                 device="cuda", log_callback=None):
        self.workdir = workdir
        self.dtype = dtype
        self.device = resolve_device(device)
        self.units = "lj"
        self.boundary = (True, True, True)
        self.atom_style = "ucg"
        self.datafile: dio.DataFile | None = None
        self.state: SimState | None = None
        self.system: System | None = None
        self.masses_override: dict = {}
        self.dt: float | None = None
        self.skin = 0.3
        self.reneigh_every = 10
        self.reneigh_check = True
        self.respa_inner = 1
        self.neighbor_method: str | None = None
        self.neighbor_one: int | None = None
        self.pair: _PendingPair | None = None
        self.bond_style: str | None = None
        self.bond_coeffs: dict = {}
        self.angle_style: str | None = None
        self.angle_coeffs: dict = {}
        self.dihedral_style: str | None = None
        self.dihedral_coeffs: dict = {}
        self.improper_style: str | None = None
        self.improper_coeffs: dict = {}
        self.special_weights = (0.0, 0.0, 0.0)   # LAMMPS default: exclude
        self.integrator = fi.IntegratorCfg(kind="none")
        self.langevin: fl.LangevinCfg | None = None
        self.vlangevin: fl.VLangevinCfg | None = None
        self.ucgstate_cfg: fs.UCGStateCfg | None = None
        self.cswitch: tuple | None = None
        self._cswitch_args: list | None = None
        self.fix_ids: dict = {}
        self._fix_args: dict = {}
        self.groups: dict = {}
        self.dumps: dict = {}
        self.thermo_every = 0
        self.thermo_columns: list | None = None
        self.thermo_rows: list = []
        self.variables: dict = {}
        # the rank in a spatial run's process group (0 without one): the
        # other ranks run the deck silently and write no files
        self.rank = (torch.distributed.get_rank()
                     if torch.distributed.is_available()
                     and torch.distributed.is_initialized() else 0)
        self.processors = (1, 1)
        self.log = ((log_callback or (lambda msg: print(msg)))
                    if self.rank == 0 else (lambda msg: None))
        self.sim: Simulation | None = None
        self.pair_path: str | None = None    # the last run's pair path
        self._restart_settings: dict = {}
        # random state and the last run's carry (module docstring)
        self.generator: torch.Generator | None = None
        self.mc_generator: torch.Generator | None = None
        self._mc_key: int | None = None
        self._carry: tuple | None = None     # (physics key, carry record)
        self._cs_stats = None

    # ------------------------------------------------------------------

    def _path(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.workdir, p)

    def run_file(self, path: str):
        with open(path) as fh:
            self.run_string(fh.read())

    def run_string(self, text: str):
        # handle line continuations with '&'
        logical = []
        buf = ""
        for raw in text.splitlines():
            line = raw.split("#")[0].rstrip()
            if line.endswith("&"):
                buf += line[:-1] + " "
                continue
            buf += line
            if buf.strip():
                logical.append(buf.strip())
            buf = ""
        for line in logical:
            self.command(line)

    def command(self, line: str):
        toks = shlex.split(self._substitute(line))
        if not toks:
            return
        cmd, args = toks[0], toks[1:]
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            raise ValueError(f"unsupported input-script command: {cmd}")
        if cmd in _STATE_COMMANDS:
            self._carry = None
        handler(args)

    def _substitute(self, line: str) -> str:
        for name, val in self.variables.items():
            line = line.replace(f"${{{name}}}", str(val))
            line = line.replace(f"${name}", str(val))
        return line

    # ---- setup commands ------------------------------------------------

    def _cmd_units(self, a):
        self.units = a[0]
        units_mod.get(a[0])

    def _cmd_dimension(self, a):
        if int(a[0]) != 3:
            raise ValueError("only 3d is supported")

    def _cmd_boundary(self, a):
        self.boundary = tuple(tok.startswith("p") for tok in a[:3])

    def _cmd_atom_style(self, a):
        self.atom_style = a[0]

    def _cmd_log(self, a):
        pass

    def _cmd_echo(self, a):
        pass

    def _cmd_print(self, a):
        self.log(" ".join(a))

    def _cmd_variable(self, a):
        # variable name equal/string value
        if len(a) >= 3 and a[1] in ("equal", "string", "index"):
            self.variables[a[0]] = a[2]
        else:
            self.variables[a[0]] = a[-1]

    def _cmd_group(self, a):
        """group ID type|id|molecule v1 v2 ... (values or i:j ranges) —
        per-TAG boolean masks honored by the fixes (the reference's
        mask[i] & groupbit, fix_nve_ucgld.cpp:64)."""
        name, style = a[0], a[1] if len(a) > 1 else None
        if name == "all":
            return
        if self.state is None:
            raise ValueError("group before read_data")
        n = self.state.n_atoms

        def expand(toks):
            vals = []
            for t in toks:
                if ":" in t:
                    parts = t.split(":")
                    lo, hi = int(parts[0]), int(parts[1])
                    stride = int(parts[2]) if len(parts) > 2 else 1
                    vals.extend(range(lo, hi + 1, stride))
                else:
                    vals.append(int(t))
            return np.asarray(vals, np.int64)

        src = {"type": self.state.typ, "id": self.state.tag,
               "molecule": self.state.mol}.get(style)
        if src is None:
            raise ValueError(f"unsupported group style {style!r}")
        vals = expand(a[2:])
        member = np.isin(dio.host(src), vals)
        # storage order is tag order at read_data time -> per-tag mask
        mask = np.zeros(n, bool)
        mask[dio.host(self.state.tag) - 1] = member
        if name in self.groups:
            mask = self.groups[name] | mask   # LAMMPS groups are additive
        self.groups[name] = mask

    def _cmd_read_data(self, a):
        df = dio.read_data(self._path(a[0]), atom_style=self.atom_style)
        self.datafile = df
        box = Box.create(df.box_lo, df.box_hi, periodic=self.boundary,
                         dtype=self.dtype, device=self.device,
                         tilt=df.box_tilt)
        if df.box_tilt is not None:
            # triclinic: only the all-pairs list takes the tilted min-image
            # (the cell list, the column list and the kernels are
            # orthogonal)
            self.neighbor_method = "nsq"
        state = SimState.create(
            x=df.x, v=df.v, typ=df.typ, mol=df.mol, q=df.q,
            ucgstate=df.ucgstate, ucgl=df.ucgl, ucgvl=df.ucgvl,
            ucgml=df.ucgml, box=box, dtype=self.dtype, device=self.device)
        self.state = dataclasses.replace(state, image=torch.as_tensor(
            df.image, dtype=torch.int32, device=self.device))
        self.system = System(n_atoms=df.n_atoms, ntypes=df.n_types,
                             masses=df.masses.copy(), units=self.units)

    def _cmd_read_restart(self, a):
        self.state, extra, settings = rst.read_restart_all(
            self._path(a[0]), dtype=self.dtype, device=self.device)
        n = self.state.n_atoms
        ntypes = int(self.state.typ.max())
        if self.state.box.is_triclinic:
            self.neighbor_method = "nsq"     # as read_data's tilted box
        if "units" in settings and settings["units"] != self.units:
            raise ValueError(
                f"restart was written with units {settings['units']!r}, "
                f"deck says {self.units!r}")
        masses = (np.asarray(settings["masses"], np.float64)
                  if "masses" in settings else np.ones(ntypes + 1))
        self.system = System(n_atoms=n, ntypes=ntypes,
                             masses=masses, units=self.units)
        # pair settings are cross-checked when pair_style is re-declared
        # (the reference restores them outright and pair_coeff must be
        # re-issued, pair_table_ucgld.cpp:1431-1471)
        self._restart_settings = settings
        self._load_random_state(extra)
        if "carry_x_build" in extra and "carry_key" in settings:
            rec = {k[len("carry_"):]: v for k, v in extra.items()
                   if k.startswith("carry_")}
            self._carry = (settings["carry_key"], rec)
        if "cswitch_stats" in extra:
            self._cs_stats = extra["cswitch_stats"]

    def _load_random_state(self, extra: dict):
        self.generator = self.mc_generator = self._mc_key = None
        dev = self.device.type
        if ("rng_state" not in extra
                or str(extra.get("rng_device")) != dev):
            self.log("read_restart: no random state of this port on this "
                     f"device ({dev}) in the file; the random streams "
                     "restart from the deck's seed")
            return
        self.generator = torch.Generator(device=self.device)
        self.generator.set_state(torch.as_tensor(extra["rng_state"]))
        if "mc_rng_state" in extra:
            self.mc_generator = torch.Generator(device=self.device)
            self.mc_generator.set_state(torch.as_tensor(
                extra["mc_rng_state"]))
            self._mc_key = int(extra["mc_rng_key"])

    def _cmd_write_restart(self, a):
        if self.rank != 0:
            return
        extra = {}
        if self.sim is not None and self.sim.cswitch_stats is not None:
            extra["cswitch_stats"] = self.sim.cswitch_stats.v
        settings = {"units": self.units, "masses": self._masses()}
        if self.pair is not None:
            settings.update(pair_style=self.pair.style,
                            tabstyle=self.pair.tabstyle,
                            tablength=self.pair.tablength)
        if self.generator is not None:
            extra["rng_state"] = self.generator.get_state()
            extra["rng_device"] = np.asarray(self.device.type)
        if self.mc_generator is not None:
            extra["mc_rng_state"] = self.mc_generator.get_state()
            extra["mc_rng_key"] = np.asarray(self._mc_key)
        if (self._carry is not None
                and not isinstance(self.sim, spatial.SpatialSimulation)):
            # one process's carry (a spatial rank's rows do not restart)
            key, rec = self._carry
            settings["carry_key"] = key
            extra.update({f"carry_{k}": v for k, v in rec.items()})
        rst.write_restart(self._path(a[0]), self.state, extra,
                          settings=settings, seed=self._deck_seed())

    def _cmd_write_data(self, a):
        if self.rank != 0:
            return
        dio.write_data(self._path(a[0]), self.state, self.system,
                       topology=self.datafile)

    def _cmd_mass(self, a):
        self.masses_override[int(a[0])] = float(a[1])

    def _cmd_timestep(self, a):
        self.dt = float(a[0])

    def _cmd_neighbor(self, a):
        self.skin = float(a[0])
        if len(a) > 1 and a[1] == "nsq":
            self.neighbor_method = "nsq"

    def _cmd_neigh_modify(self, a):
        i = 0
        while i < len(a):
            if a[i] == "every":
                self.reneigh_every = int(a[i + 1])
                i += 2
            elif a[i] == "check":
                # check yes: rebuild at block cadence only when the
                # displacement check demands it (the default); check no:
                # rebuild every block unconditionally
                self.reneigh_check = a[i + 1] == "yes"
                i += 2
            elif a[i] == "one":
                # neigh_modify one N — per-atom neighbor capacity, the
                # knob for locally-dense configurations (bonded molecules)
                # whose coordination exceeds the mean-density estimate
                self.neighbor_one = int(a[i + 1])
                i += 2
            elif a[i] in ("delay", "once", "page"):
                # rebuild candidacy is at block cadence; LAMMPS
                # delay/once/page have no exact analogue
                if (a[i], a[i + 1]) != ("delay", "0"):
                    self.log(f"WARNING: neigh_modify {a[i]} {a[i + 1]} has no "
                             "effect (block-cadence rebuilds + displacement "
                             "check)")
                i += 2
            else:
                i += 1

    def _cmd_processors(self, a):
        """processors Px Py Pz — the LAMMPS processor grid: Px > 1, Py 1
        runs Px x-slabs, Px, Py > 1 x-y pencils (parallel/spatial.py), one
        rank of the caller's process group each; ``*`` for Px is the
        group's size (one without a group), for Py 1.  Pz must be 1 or *
        (the z axis is not decomposed).  A grid above one subdomain needs
        an initialised process group of exactly Px·Py ranks."""
        if len(a) < 3:
            raise ValueError("processors requires Px Py Pz")
        if a[2] not in ("1", "*"):
            raise ValueError("processors: Pz must be 1 or * (the z axis "
                             "is not decomposed)")
        dist = torch.distributed
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        px = world if a[0] == "*" else int(a[0])
        py = 1 if a[1] == "*" else int(a[1])
        if px * py > 1 and px * py != world:
            raise ValueError(
                f"processors {px}x{py} needs a process group of {px * py} "
                f"ranks (parallel/launch.py); this one has {world}")
        self.processors = (px, py)

    def _cmd_run_style(self, a):
        # run_style verlet | respa 2 N bond 1 pair 2  (two-level r-RESPA:
        # bonded at the inner level, pair at the outer — the shape the
        # reference fixes support, fix_nve_ucgld.cpp:155-173)
        if a[0] == "verlet":
            self.respa_inner = 1
            return
        if a[0] != "respa":
            raise ValueError(f"unsupported run_style {a[0]!r}")
        nlevels = int(a[1])
        if nlevels != 2:
            raise ValueError("only 2-level respa (bond inner, pair outer) "
                             "is supported")
        self.respa_inner = int(a[2])
        if self.respa_inner < 1:
            raise ValueError("respa inner loop count must be >= 1 "
                             "(1 == plain Verlet with bonded folded into "
                             "the pair pass)")
        kw = a[3:]
        for i in range(0, len(kw) - 1, 2):
            k, lvl = kw[i], int(kw[i + 1])
            if (k, lvl) not in (("bond", 1), ("angle", 1), ("pair", 2)):
                raise ValueError(f"unsupported respa assignment {k} {lvl} "
                                 "(bond/angle -> 1, pair -> 2)")

    def _topology_style(self, what: str, a):
        if a[0] not in ("harmonic", "none", "zero"):
            raise ValueError(f"unsupported {what}_style {a[0]!r}")
        setattr(self, f"{what}_style",
                None if a[0] in ("none", "zero") else a[0])

    def _cmd_bond_style(self, a):
        self._topology_style("bond", a)

    def _cmd_bond_coeff(self, a):
        # bond_coeff TYPE K r0  (bond_style harmonic)
        self.bond_coeffs[int(a[0])] = (float(a[1]), float(a[2]))

    def _cmd_angle_style(self, a):
        self._topology_style("angle", a)

    def _cmd_angle_coeff(self, a):
        # angle_coeff TYPE K theta0(degrees)
        self.angle_coeffs[int(a[0])] = (float(a[1]), float(a[2]))

    def _cmd_dihedral_style(self, a):
        self._topology_style("dihedral", a)

    def _cmd_dihedral_coeff(self, a):
        # dihedral_coeff TYPE K d n  (dihedral_style harmonic:
        # E = K [1 + d cos(n phi)], d = +1/-1, integer n >= 0)
        self.dihedral_coeffs[int(a[0])] = (float(a[1]), float(a[2]),
                                           int(a[3]))

    def _cmd_improper_style(self, a):
        self._topology_style("improper", a)

    def _cmd_improper_coeff(self, a):
        # improper_coeff TYPE K chi0(degrees)  (improper_style harmonic)
        self.improper_coeffs[int(a[0])] = (float(a[1]), float(a[2]))

    def _cmd_special_bonds(self, a):
        # special_bonds lj w12 w13 w14 | lj/coul w12 w13 w14 (0/1 only)
        if a and a[0] in ("lj", "lj/coul", "coul"):
            w = tuple(float(t) for t in a[1:4])
        elif a and a[0] == "amber":
            raise NotImplementedError("special_bonds amber unsupported")
        else:
            w = tuple(float(t) for t in a[:3])
        self.special_weights = w

    def _cmd_velocity(self, a):
        # velocity all create T seed — numpy's default_rng(seed), as the
        # JAX package draws it, so both start from the same velocities
        if len(a) >= 4 and a[1] == "create":
            T = float(a[2])
            seed = int(a[3])
            u = units_mod.get(self.units)
            rng = np.random.default_rng(seed)
            n = self.state.n_atoms
            masses = (self.system.masses if not self.masses_override
                      else self._masses())
            m = masses[dio.host(self.state.typ)]
            sigma = np.sqrt(u.boltz * T / (m * u.mvv2e))
            v = rng.normal(0, 1, (n, 3)) * sigma[:, None]
            v -= v.mean(axis=0)   # zero linear momentum
        elif len(a) >= 2 and a[1] == "set":
            v = np.full((self.state.n_atoms, 3), 0.0)
            for d in range(3):
                if a[2 + d] != "NULL":
                    v[:, d] = float(a[2 + d])
        else:
            raise ValueError(f"unsupported velocity command: {a}")
        self.state = dataclasses.replace(self.state, v=torch.as_tensor(
            v, dtype=self.dtype, device=self.device))

    def _masses(self):
        masses = self.system.masses.copy()
        for t, m in self.masses_override.items():
            masses[t] = m
        return masses

    # ---- pair style ----------------------------------------------------

    def _cmd_pair_style(self, a):
        style = a[0]
        registry.pair_style(style)          # raises for an unknown style
        tabstyle = a[1]
        tablength = int(a[2])
        rs = self._restart_settings
        if rs and "pair_style" in rs:
            mism = [(k, rs[k], v) for k, v in
                    (("pair_style", style), ("tabstyle", tabstyle),
                     ("tablength", tablength)) if rs[k] != v]
            if mism:
                raise ValueError(
                    "pair_style disagrees with the restart's stored "
                    f"settings: {mism} (restart persists settings, "
                    "pair_table_ucgld.cpp:1431-1471)")
        pending = _PendingPair(style=style, tabstyle=tabstyle,
                               tablength=tablength, args=list(a))
        pending.settings = parse_state_settings(
            self._path(a[3]), registry.PAIR_DIALECTS[style])
        # optional keywords (method/pseudo/prior for bethe; kspace flags
        # accepted and ignored — no long-range solver here)
        i = 4
        while i < len(a):
            kw = a[i]
            if kw in ("ewald", "pppm", "msm", "dispersion", "tip4p"):
                i += 1
            elif kw == "method":
                pending.method = {"mf": "mf", "meanfield": "mf",
                                  "bethe": "bethe", "Bethe": "bethe"}[a[i + 1]]
                i += 2
            elif kw == "pseudo":
                pending.pseudo = a[i + 1] == "yes"
                i += 2
            elif kw == "prior":
                if a[i + 1] == "chemical_potential":
                    if i + 2 < len(a) and a[i + 2] == "noise":
                        pending.prior_mode = "chemical_potential_noise"
                        pending.noise_level = float(a[i + 3])
                        pending.noise_seed = int(a[i + 4])
                        i += 5
                    else:
                        pending.prior_mode = "chemical_potential"
                        i += 2
                elif a[i + 1] == "ucgl":
                    pending.prior_mode = "ucgl"
                    i += 2
                else:
                    raise ValueError(f"unknown prior mode {a[i + 1]!r}")
            elif kw == "pair_cv":
                # engine extension (bethe_density): "conservative" (default,
                # F = -dE/dx) or "reference" (literal back-force of
                # pair_table_ucg_bethe_density.cpp:707-732, w(r)/r weighting)
                if a[i + 1] not in ("conservative", "reference"):
                    raise ValueError(f"unknown pair_cv mode {a[i + 1]!r}")
                pending.pair_cv = a[i + 1]
                i += 2
            elif kw == "backforce_derivative":
                # engine extension (bethe_density): yes = dw/dr weighting
                # (P4's convention); no = the reference P3's w(r)/r (:719)
                pending.backforce_derivative = a[i + 1] == "yes"
                i += 2
            else:
                raise ValueError(f"unknown pair_style keyword {kw!r}")
        self.pair = pending

    def _cmd_pair_coeff(self, a):
        if self.pair is None:
            raise ValueError("pair_coeff before pair_style")
        self.pair.coeffs.append(list(a))

    def _build_pair(self, kT: float):
        """(reference compute, params, max cutoff) of the declared style,
        through ``models.registry``."""
        p = self.pair
        if p is None:
            raise ValueError("no pair_style defined")
        dtype, dev = self.dtype, self.device
        compute, make = registry.pair_style(p.style)
        if p.style == "table_rleucg_interface":
            b = RLEUCGBuilder(p.tabstyle, p.tablength, p.settings)
            for c in p.coeffs:
                # pair_coeff i j file keyword cutoff
                b.pair_coeff(c[0], c[1], (self._path(c[2]), c[3]), float(c[4]))
            params = make(b, p.settings, kT, dtype=dtype, device=dev)
            return compute, params, b.max_cutoff
        b = TablePairBuilder(p.tabstyle, p.tablength, p.settings)
        for c in p.coeffs:
            ns_i, ns_j = int(c[2]), int(c[3])
            entries = []
            rest = c[4:]
            for k in range(ns_i * ns_j):
                f, kw, cut = rest[3 * k], rest[3 * k + 1], rest[3 * k + 2]
                entries.append(((self._path(f), kw), float(cut)))
            b.pair_coeff(c[0], c[1], ns_i, ns_j, entries)
        bank, tp = b.build(dtype=dtype, device=dev)
        if p.style == "table_ucgld":
            params = make(bank=bank, tp=tp, kT=torch.as_tensor(
                kT, dtype=dtype, device=dev))
        elif p.style == "table_ucg_bethe":
            params = make(bank, tp, kT, method=p.method, pseudo=p.pseudo,
                          prior_mode=p.prior_mode,
                          noise_level=p.noise_level, dtype=dtype)
        else:                               # table_ucg_bethe_density
            if not p.pseudo:
                raise ValueError("table_ucg_bethe_density implements only "
                                 "pseudolikelihood scores (pseudo yes)")
            params = make(bank, tp, kT, method=p.method, pair_cv=p.pair_cv,
                          backforce_derivative=p.backforce_derivative,
                          dtype=dtype)
        return compute, params, b.max_cutoff

    # ---- fixes ---------------------------------------------------------

    def _cmd_fix(self, a):
        fid, group, style = a[0], a[1], a[2]
        rest = a[3:]
        make = registry.fix_style(style)    # raises for an unknown style
        if group == "all":
            gmask = None
        elif group in self.groups:
            gmask = self.groups[group]
        else:
            raise ValueError(f"fix references undefined group {group!r}")
        if style == "nve/ucgld":
            self.integrator = make(kind="nve/ucgld", group=gmask)
        elif style == "nve/ucgld/wall/hard":
            bias = False
            barrier = 0.1
            i = 0
            while i < len(rest):
                if rest[i] == "bias_potential":
                    bias = True
                    if i + 1 < len(rest):
                        barrier = float(rest[i + 1])
                    i += 2
                else:
                    raise ValueError(f"unknown wall/hard arg {rest[i]!r}")
            self.integrator = make(
                kind="nve/ucgld/wall/hard", bias_potential=bias,
                barrier=barrier, group=gmask)
        elif style == "ucgld/langevin":
            self.langevin = make(
                t_start=float(rest[0]), t_stop=float(rest[1]),
                t_period=float(rest[2]), seed=int(rest[3]), group=gmask)
        elif style == "nve":
            # stock fix nve: plain velocity-Verlet on (x, v); λ untouched
            self.integrator = make(kind="nve", group=gmask)
        elif style == "langevin":
            # stock fix langevin Tstart Tstop damp seed [keywords ignored]
            # — the particle-DOF thermostat production UCG decks run under
            # (every pair style takes kT from it, pair_table_ucgld.cpp:
            # 872-881); pair with `fix nve` for NVT
            if len(rest) > 4:
                self.log(f"WARNING: fix langevin keywords {rest[4:]} ignored")
            self.vlangevin = make(
                t_start=float(rest[0]), t_stop=float(rest[1]),
                damp=float(rest[2]), seed=int(rest[3]), group=gmask)
        elif style == "ucgstate":
            if not rest:
                self.ucgstate_cfg = make(mode="default",
                                                   group=gmask)
            elif rest[0] == "ld":
                self.ucgstate_cfg = make(mode="ld", group=gmask)
            elif rest[0] == "mc":
                # fix ucgstate mc seed rate (fix_ucgstate.cpp:37-67); the
                # seed selects the mc stream (runtime.sim.mc_seed)
                self.ucgstate_cfg = make(
                    mode="mc", seed=int(rest[1]), mc_rate=float(rest[2]),
                    group=gmask)
            else:
                raise ValueError(f"unknown ucgstate arg {rest[0]!r}")
        elif style == "cluster_switch":
            if gmask is not None:
                self.log(f"WARNING: fix cluster_switch group {group!r} "
                         "treated as 'all' (molecule selection comes from "
                         "the rates file types)")
            # molID_seed mol_offset cutoff seed rateFreq N rateFile f
            # contactFile f
            mol_seed = int(rest[0])
            mol_offset = int(rest[1])
            cutoff = float(rest[2])
            kw = {rest[i]: rest[i + 1] for i in range(4, len(rest) - 1, 2)}
            freq = int(kw.get("rateFreq", rest[5] if len(rest) > 5 else 1000))
            rates = _read_rates_file(self._path(kw["rateFile"]))
            contacts = _read_contacts_file(self._path(kw["contactFile"]))
            maxmol = int(self.state.mol.max())
            # the reference propagates labels until no change
            # (fix_cluster_switch.cpp:596-685); a label moves one contact
            # a sweep, so n + 1 sweeps always reach the fixpoint, and a
            # converged event reads its flag every 16 sweeps whatever the
            # cap (make_params' 64 raised from a few thousand beads)
            params = make(
                ntypes=self.system.ntypes, contacts=contacts,
                atomtypes_on=rates["on"], atomtypes_off=rates["off"],
                probON=rates["probON"], cutoff=cutoff, mol_seed=mol_seed,
                mol_offset=mol_offset, maxmol=maxmol,
                max_sweeps=self.state.n_atoms + 1, dtype=self.dtype,
                device=self.device)
            self.cswitch = (params, freq)
            self._cswitch_args = list(rest)
        self.fix_ids[fid] = style
        self._fix_args[fid] = [group, style, *rest]

    def _cmd_unfix(self, a):
        style = self.fix_ids.pop(a[0], None)
        self._fix_args.pop(a[0], None)
        if style in ("nve/ucgld", "nve/ucgld/wall/hard", "nve"):
            self.integrator = fi.IntegratorCfg(kind="none")
        elif style == "ucgld/langevin":
            self.langevin = None
        elif style == "langevin":
            self.vlangevin = None
        elif style == "ucgstate":
            self.ucgstate_cfg = None
        elif style == "cluster_switch":
            self.cswitch = self._cswitch_args = None

    # ---- dumps & thermo ------------------------------------------------

    def _cmd_dump(self, a):
        did, group, style, every, fname = a[0], a[1], a[2], int(a[3]), a[4]
        if style != "custom":
            raise ValueError("only 'dump custom' is supported")
        cols = tuple(a[5:])
        w = dmp.DumpWriter(self._path(fname), columns=cols)
        self.dumps[did] = _Dump(writer=w, every=every, group=group)

    def _cmd_dump_modify(self, a):
        did = a[0]
        if a[1] == "thresh":
            self.dumps[did].writer.modify_thresh(a[2], a[3], float(a[4]))
        else:
            self.log(f"WARNING: dump_modify {a[1]} ignored")

    def _cmd_undump(self, a):
        self.dumps.pop(a[0], None)

    def _cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def _cmd_thermo_style(self, a):
        # thermo_style custom <cols>: select/rename output columns.  LAMMPS
        # names map onto the engine's thermo row where meaningful.
        if a and a[0] == "custom":
            mapping = {"step": "step", "temp": "temp", "pe": "pe", "ke": "ke",
                       "etotal": "etotal", "press": "press", "epair": "pe",
                       "evdwl": "pe"}
            self.thermo_columns = [mapping.get(c, c) for c in a[1:]]

    # ---- run -----------------------------------------------------------

    def _deck_seed(self) -> int:
        """The seed of the runner's generator: the λ-Langevin fix's, else
        the velocity Langevin's, else 0."""
        cfg = self.langevin or self.vlangevin
        return cfg.seed if cfg is not None else 0

    def _physics_key(self) -> str:
        """Hash of everything that defines a step's physics: the carry of
        one run resumes into the next only under the same key."""
        p = self.pair
        key = {
            "units": self.units, "dtype": str(self.dtype),
            "device": self.device.type, "dt": self.dt, "skin": self.skin,
            "neigh": [self.reneigh_every, self.reneigh_check,
                      self.neighbor_method, self.neighbor_one],
            "respa": self.respa_inner, "processors": self.processors,
            "pair": None if p is None else [p.args, p.coeffs],
            "fixes": sorted(self._fix_args.values()),
            "groups": {k: _mask_key(v) for k, v in self.groups.items()},
            "cfgs": [_cfg_key(c) for c in (self.integrator, self.langevin,
                                           self.vlangevin, self.ucgstate_cfg)],
            "masses": None if self.system is None else self._masses().tolist(),
            "topology": [self.bond_style, self.bond_coeffs, self.angle_style,
                         self.angle_coeffs, self.dihedral_style,
                         self.dihedral_coeffs, self.improper_style,
                         self.improper_coeffs, self.special_weights],
        }
        text = json.dumps(key, sort_keys=True, default=str)
        return hashlib.sha256(text.encode()).hexdigest()

    def _resumable(self) -> dict | None:
        """The last run's carry when the physics is the same, else None."""
        if self._carry is None:
            return None
        if self._carry[0] == self._physics_key():
            return self._carry[1]
        self.log("run: the styles changed since the last run; forces are "
                 "set up afresh")
        return None

    def _make_sim(self, resume: dict | None = None) -> Simulation:
        """Build the run's Simulation.  ``resume``: a carry record whose
        list spec the new Simulation takes over (a spec measured anew from
        the current positions could lay the list out otherwise)."""
        u = units_mod.get(self.units)
        t_thermo = (self.langevin.t_start if self.langevin
                    else self.vlangevin.t_start if self.vlangevin else 0.0)
        kT = u.boltz * t_thermo
        if t_thermo == 0.0:
            # Missing-thermostat guard.  The reference pair styles silently
            # take T=0 from an absent thermostat (pair_table_ucgld.cpp:
            # 872-881 leaves T unset), which for the Bethe family means
            # exp(-J/kT) -> NaN forces with no diagnostic; FixUCGState DOES
            # error (fix_ucgstate.cpp:152-154).  Raise for every kT-dividing
            # consumer instead of running NaN physics.
            style = self.pair.style if self.pair else None
            if style in ("table_ucg_bethe", "table_ucg_bethe_density",
                         "table_rleucg_interface"):
                raise ValueError(
                    f"pair_style {style} requires a thermostat fix (fix "
                    "langevin / fix ucgld/langevin) to set the target "
                    "temperature kT; none is defined "
                    "(exp(-J/kT) would be NaN at kT=0)")
            if self.ucgstate_cfg is not None:
                raise ValueError(
                    "FixUCGState requires a thermostat fix BEFORE ITSELF to "
                    "set the target temperature T. "
                    "(fix_ucgstate.cpp:152-154)")
        pair_compute, pair_params, cutoff = self._build_pair(kT)
        n = self.state.n_atoms
        # row-chunk the reference pair loop at large N (bounds memory;
        # exact); the kernel path resets it
        if hasattr(pair_params, "chunk") and n >= 32768:
            for c in (16384, 8192, 4096):
                if n % c == 0:
                    pair_params = dataclasses.replace(pair_params, chunk=c)
                    break
        L = dio.host(self.state.box.lengths).astype(np.float64)
        bparams, excl = self._build_bonded(n)
        # the hand-written kernel path (ops/kernel_select.py) on a CUDA
        # device in f32; bonded terms add to it, special exclusions are
        # subtracted through the style's excl_delta (the density styles
        # pass by pass), and the cluster_switch event builds its own
        # contact list.  Where the selection declines (the CPU), the
        # reference list leaves the specials out
        topo = bparams is not None or excl is not None
        sel = select_pair_kernel(pair_params, self.state, cutoff, self.skin)
        if (sel is not None and excl is not None and np.any(excl)
                and excl_route(sel[0]) is None):
            raise NotImplementedError(
                f"{self.pair.style} with special exclusions has no "
                "excl_delta on the kernel path")
        if sel is not None:
            pair_compute, spec, pair_params = sel
            self.pair_path = (
                f"hand-written CUDA kernels "
                f"{KERNEL_PATHS.get(pair_compute.__name__, '')} via "
                f"{pair_compute.__module__}.{pair_compute.__name__}"
                + (" (+ bonded terms, excl_delta subtracted)" if topo
                   else ""))
        else:
            spec = nbrmod.make_spec(n, L, cutoff, self.skin,
                                    method=self.neighbor_method,
                                    capacity=self.neighbor_one)
            self.pair_path = (f"reference PyTorch pair path "
                              f"{pair_compute.__module__}."
                              f"{pair_compute.__name__} on a {spec.method} "
                              f"list ({self.device.type}, {self.dtype})"
                              + (" (+ bonded terms)" if topo else ""))
        self.log(f"pair path: {self.pair_path}")
        if resume is not None and "spec" in resume:
            kind, fields = json.loads(str(resume["spec"]))
            if kind == type(spec).__name__:
                spec = type(spec)(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in fields.items()})
        dt = self.dt if self.dt is not None else u.dt_default
        cfg = SimConfig(
            dt=dt, units=self.units, integrator=self.integrator,
            langevin=self.langevin, vlangevin=self.vlangevin,
            ucgstate=self.ucgstate_cfg,
            reneigh_every=self.reneigh_every,
            reneigh_check=self.reneigh_check,
            respa_inner=self.respa_inner)
        system = System(n_atoms=n, ntypes=self.system.ntypes,
                        masses=self._masses(), units=self.units)
        seed = self._deck_seed()
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(seed)
        mc = self.ucgstate_cfg is not None and self.ucgstate_cfg.mode == "mc"
        if mc and self._mc_key != self.ucgstate_cfg.seed:
            # the fix's seed changed: the Simulation seeds the new stream
            self.mc_generator, self._mc_key = None, self.ucgstate_cfg.seed
        kw = dict(seed=seed, cluster_switch=self.cswitch,
                  log_dir=self.workdir if self.cswitch else None,
                  bonded=bparams, excl_tags=excl, generator=self.generator,
                  mc_generator=self.mc_generator if mc else None)
        if self.processors[0] * self.processors[1] > 1:
            self.sim = self._make_spatial_sim(
                system, cfg, pair_compute, pair_params, spec,
                None if resume is None else resume.get("slab"), kw)
        else:
            self.sim = Simulation(system, self.state, pair_compute,
                                  pair_params, spec, cfg, **kw)
        if self.sim.cswitch_stats is not None and self._cs_stats is not None:
            self.sim.cswitch_stats = fcs.ClusterSwitchStats(
                v=torch.as_tensor(self._cs_stats, dtype=self.dtype,
                                  device=self.device))
        return self.sim

    def _make_spatial_sim(self, system, cfg, pair_compute, pair_params, spec,
                          slab, kw: dict):
        """The slab or pencil driver of a ``processors`` deck (JAX
        ``script.py:_make_spatial_sim``) on this rank's group, on the
        decomposition ``slab`` when a continued run hands it over; the
        atom decomposition for a tilted box or a grid the slabs and pencils
        cannot cut."""
        px, py = self.processors
        ring = spatial.Ring((px, py))
        n = self.state.n_atoms
        why = "a tilted box" if self.state.box.is_triclinic else None
        if why is None and slab is None:
            L = dio.host(self.state.box.lengths).astype(np.float64)
            x = dio.host(self.state.box.wrap(self.state.x)
                         - self.state.box.lo).astype(np.float64)
            caps = ({} if self.neighbor_one is None
                    else {"nbr_capacity": self.neighbor_one})
            try:
                slab = spatial.make_spec(n, L, spec, (px, py), x, **caps)
            except ValueError as e:
                why = f"the spatial decomposition is infeasible ({e})"
        if why is not None:
            self.log(f"processors {px}x{py}: {why}; falling back to the "
                     f"atom decomposition (parallel/domain.py) over "
                     f"{ring.world} ranks")
            return domain.DomainSimulation(system, self.state, pair_compute,
                                           pair_params, spec, cfg, ring,
                                           **kw)
        sim = spatial.SpatialSimulation(system, self.state, pair_compute,
                                        pair_params, slab, cfg, ring, **kw)
        self.log(f"spatial {'slab' if py == 1 else 'pencil'} decomposition "
                 f"{px}x{py}: {sim.ring.backend} process group, "
                 f"{slab.cap_local} local + {2 * slab.cap_halo} x-halo "
                 f"+ {2 * slab.cap_halo_y} y-halo rows a rank")
        return sim

    def _build_bonded(self, n):
        """BondedParams + special exclusion tags from the data-file topology
        and the declared bond/angle styles (models/bonded.py)."""
        df = self.datafile
        bonds = df.bonds if (df is not None and self.bond_style) else None
        angles = df.angles if (df is not None and self.angle_style) else None
        dihedrals = (df.dihedrals
                     if (df is not None and self.dihedral_style) else None)
        impropers = (df.impropers
                     if (df is not None and self.improper_style) else None)
        if (bonds is None and angles is None and dihedrals is None
                and impropers is None):
            return None, None
        params = bd.make_params(bonds, self.bond_coeffs, angles,
                                self.angle_coeffs, dtype=self.dtype,
                                dihedrals=dihedrals,
                                dihedral_coeffs=self.dihedral_coeffs,
                                impropers=impropers,
                                improper_coeffs=self.improper_coeffs,
                                device=self.device)
        excl = bd.special_tags(
            n, bonds=bonds, angles=angles,
            dihedrals=df.dihedrals if df is not None else None,
            weights=self.special_weights)
        return params, excl

    def _cmd_run(self, a):
        nsteps = int(a[0])
        resume = self._resumable()
        sim = self._make_sim(resume)
        cadences = [c for c in
                    [self.thermo_every] + [d.every for d in self.dumps.values()]
                    if c > 0]
        chunk = min(cadences) if cadences else nsteps
        chunk = max(chunk, 1)

        def emit():
            step = int(sim.state.step)
            if self.thermo_every and step % self.thermo_every == 0:
                self._thermo_row(sim, self.thermo_columns)
            for d in self.dumps.values():
                if step % d.every == 0 and self.rank == 0:
                    d.writer.write(sim.state)

        if resume is not None:
            sim.resume(resume)
        else:
            step0 = int(sim.state.step)
            sim.setup((step0, step0 + nsteps))
        emit()
        done = 0
        while done < nsteps:
            todo = min(chunk, nsteps - done)
            sim.run(todo)
            done += todo
            emit()
        self.state = sim.state
        self._keep_mc_stream(sim)
        rec = sim.carry()
        if not isinstance(sim, spatial.SpatialSimulation):
            rec["spec"] = np.asarray(json.dumps(
                [type(sim.nbr_spec).__name__,
                 dataclasses.asdict(sim.nbr_spec)]))
        self._carry = (self._physics_key(), rec)
        if sim.cswitch_stats is not None:
            self._cs_stats = sim.cswitch_stats.v

    def _thermo_row(self, sim: Simulation, columns=None):
        row = sim.thermo()
        self.thermo_rows.append(row)
        shown = row
        if columns:
            shown = {c: row.get(c, float("nan")) for c in columns}
        self.log("  ".join(f"{k}={v:.6g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in shown.items()))

    def _cmd_rerun(self, a):
        """rerun dumpfile [first N last N every N] dump x y z [ucgl ucgp ucgstate ...]
        (read_dump.cpp + rerun semantics: re-evaluate forces/posteriors per
        snapshot; fix ucgstate setup-time evaluation enables state
        assignment, fix_ucgstate.cpp:165-169).  Under ``processors`` every
        rank sets each snapshot and runs the setup; rank 0 writes the
        dumps."""
        fname = self._path(a[0])
        i = 1
        first, last, every = None, None, 1
        fields = ["x", "y", "z"]
        while i < len(a):
            if a[i] == "first":
                first = int(a[i + 1]); i += 2
            elif a[i] == "last":
                last = int(a[i + 1]); i += 2
            elif a[i] == "every":
                every = int(a[i + 1]); i += 2
            elif a[i] == "dump":
                fields = list(a[i + 1:])
                break
            else:
                i += 1
        if self.processors[0] * self.processors[1] > 1:
            # rank 0's dump frames are whole before any rank reads them
            spatial.Ring(self.processors).barrier()
        snaps = dmp.read_dump(fname)
        sim = self._make_sim()
        for snap in snaps:
            if first is not None and snap.step < first:
                continue
            if last is not None and snap.step > last:
                continue
            # LAMMPS rerun 'every N': process snapshots whose TIMESTEP is a
            # multiple of N (read_dump.cpp), not every Nth snapshot
            if every > 1 and snap.step % every:
                continue
            st = dmp.apply_snapshot(sim.state, snap, fields=tuple(fields))
            st = dataclasses.replace(st, step=int(snap.step))
            if isinstance(sim, spatial.SpatialSimulation):
                sim.set_state(st)
                sim.setup()
                sim.state, sim._fcarry = sim.gather()
            else:
                sim.state, sim._fcarry = st, None
                sim.setup()
            if self.thermo_every:
                self._thermo_row(sim)
            for d in self.dumps.values():
                if self.rank == 0:
                    d.writer.write(sim.state)
        self.state = sim.state
        self._keep_mc_stream(sim)

    def _keep_mc_stream(self, sim: Simulation):
        """Take over the ``ucgstate mc`` generator that ``sim`` seeded or
        drew on, so the next run and ``write_restart`` carry it on."""
        if sim.mc_generator is not None:
            self.mc_generator = sim.mc_generator


def _read_rates_file(path: str) -> dict:
    """rates.txt: probON; nSwitchTypes; ON types row; OFF types row
    (fix_cluster_switch.cpp:206-282)."""
    rows = []
    with open(path) as fh:
        for raw in fh:
            s = raw.split("#")[0].strip()
            if s:
                rows.append(s.split())
    probON = float(rows[0][0])
    if probON > 1.0:
        raise ValueError("Incorrect probability in rates file")
    nst = int(rows[1][0])
    on = [int(v) for v in rows[2][:nst]]
    off = [int(v) for v in rows[3][:nst]]
    return {"probON": probON, "on": on, "off": off}


def _read_contacts_file(path: str) -> list:
    """contacts.txt: two header lines (counts) then contact type pairs
    (fix_cluster_switch.cpp:286-355)."""
    rows = []
    with open(path) as fh:
        for raw in fh:
            s = raw.split("#")[0].strip()
            if s:
                rows.append(s.split())
    # rows[0] = [label?, nContactTypes], rows[1] = [label?, nAtomsPerContact]
    pairs = []
    for r in rows[2:]:
        pairs.append((int(r[0]), int(r[1])))
    return pairs
