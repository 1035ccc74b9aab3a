"""The topology slice — bonded terms, special exclusions, r-RESPA and the
``fix cluster_switch`` event in ``Simulation`` — against the JAX package on
the CPU (no interpret-mode Pallas: the JAX side runs its XLA code).

* ``build_nsq(excl=)``: the same list as ``build_cell(excl=)`` and as the
  JAX package's nsq builder.
* ``hopper_pair.excl_delta`` / ``hopper_bethe.excl_delta_bethe`` against
  the JAX package's on the same f32 inputs, within 2e-5 of each field's
  scale (pe 2e-5 relative, the inner-cutoff count exact): the port mixes
  D-form rows taken from the fit in float64, the JAX package raw rows
  differenced in float32, so the channels differ by f32 rounding of the
  largest row.  Single-type trimers, a two-type fluid (the per-type-pair
  block) and both Bethe score modes.
* K1's and K2's twins over every pair minus the delta, against the JAX
  package's XLA pair path on a list with the specials excluded, at the
  JAX package's kernel-vs-XLA gates (f 5e-5 of max|f|, pe 3e-5, λ-force
  and scores 3e-5).
* The molecular UCG-LD deck (``flagship.build_molecular_sim``, 70 bent
  trimers, Langevin off) on the float64 reference path against the JAX
  ``Simulation`` built from the same arrays, 2 blocks of 5 steps: x, v, λ,
  λ-velocity, f, pe and the virial at 1e-9; the same system under r-RESPA
  (``build_respa_sim``: bond K 400, 4 inner steps, dt 0.004).
* The molecular deck on the kernel path (K1's twin, f32, ``excl_delta``
  subtracted) against the JAX float64 run: the state within 5e-5 and the
  thermo rows within 1e-5 relative, the gates of the flagship slice
  (``test_torch_slice.py``; fit error < 1e-4 relative times 10 steps of
  dt 0.002 plus f32 rounding); f and the virial within 5e-5 of their
  largest magnitude, the JAX package's kernel-vs-XLA force gate.
* The cluster_switch event of ``Simulation`` on the column path (config 4
  on K5/K3/K6's twins) and on the reference path (config 4, and the
  molecular switch deck) with the JAX package's draws injected: the same
  types and 7-stat vector as the JAX event, bit for bit; the event inside
  ``run`` (logs, cadence, recomputed forces).
* The errors: exclusions on a density column path, r-RESPA without bonded
  terms, a switch frequency that is no multiple of the reneighbour
  interval; ``_slot_ok`` is off with topology.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import cluster_switch as jcs
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu.io.table_io import RawTable as JRawTable
from lammps_ucg_dev_tpu.models import bonded as jbd
from lammps_ucg_dev_tpu.models import pair_bethe as jpb
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu.ops import chebtab as jchebtab
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.ops import pallas_pair as pk
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu.runtime.sim import Simulation as JSimulation
from lammps_ucg_dev_tpu_torch import convert, flagship
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation
from test_torch_core import one_torch_thread  # noqa: F401

NMOL, NSTEPS, EVERY = 70, 10, 5
FIELDS = ("x", "v", "ucgl", "ucgvl", "f")


# ---- the JAX package's side of the molecular systems -----------------------

@functools.lru_cache(maxsize=None)
def jax_tables(tablength, dtype, style="ucgld"):
    st = parse_state_settings(flagship.TWO_STATE_SETTINGS, style)
    b = TablePairBuilder("linear", tablength, st)
    b.pair_coeff(1, 1, 2, 2, [
        (JRawTable(**dataclasses.asdict(flagship.soft_table(e, 2000))),
         flagship.RC) for e in flagship.EPS])
    return b.build(dtype=dtype)


def jax_state(a, dtype):
    return JSimState.create(
        x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
        ucgstate=a["ucgstate"], ucgml=a["ucgml"], mol=a["mol"],
        box=JBox.create([0, 0, 0], [a["L"]] * 3, dtype=dtype), dtype=dtype)


def jax_molecular(respa_inner=1):
    """The JAX twin of ``build_molecular_sim`` (or, with ``respa_inner``,
    ``build_respa_sim``) in float64 on its XLA pair path, Langevin off."""
    a = flagship.molecular_arrays(NMOL)
    n, f64 = 3 * NMOL, jnp.float64
    bank, tp = jax_tables(2000, f64)
    params = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8, f64))
    spec = jnb.make_spec(n, [a["L"]] * 3, flagship.RC, 0.4)
    if respa_inner > 1:
        cfg = JSimConfig(dt=0.004, units="lj",
                         integrator=jfi.IntegratorCfg("nve/ucgld"),
                         reneigh_every=EVERY, respa_inner=respa_inner)
        bond = {1: (400.0, 0.9)}
    else:
        cfg = JSimConfig(dt=0.002, units="lj",
                         integrator=jfi.IntegratorCfg("nve/ucgld/wall/hard"),
                         ucgstate=jfs.UCGStateCfg(mode="ld"),
                         reneigh_every=EVERY)
        bond = {1: flagship.BOND}
    bonded = jbd.make_params(a["bonds"], bond, a["angles"],
                             {1: flagship.ANGLE}, dtype=f64)
    excl = jbd.special_tags(n, a["bonds"], a["angles"])
    sim = JSimulation(JSystem(n_atoms=n, ntypes=1,
                              masses=np.array([0.0, 1.0])),
                      jax_state(a, f64), jpu.compute, params, spec, cfg,
                      bonded=bonded, excl_tags=excl)
    # its list build jitted: ``setup`` runs it op by op, which compiles
    # slower than the whole build at once (the results are the same)
    sim._nbr_build = jax.jit(sim._nbr_build)
    return sim


def record(sim):
    sim.run(NSTEPS, thermo_every=EVERY)
    return ({f: np.asarray(sim.property_atom(f)) for f in FIELDS},
            np.asarray(sim._fcarry.virial), sim.thermo_rows)


@pytest.fixture(scope="module")
def jax_verlet():
    return record(jax_molecular())


@pytest.fixture(scope="module")
def jax_respa():
    return record(jax_molecular(respa_inner=4))


def check_rows(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ("temp", "pe", "ke", "ke_lambda", "etotal", "press"):
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, err_msg=k)
        assert r["oob_low"] == q["oob_low"] == 0


def compare(sim, ref, atol, rtol_rows, f_rel=None):
    """The port's run against the JAX one: x, v, λ, λ-velocity (and f and
    the virial unless ``f_rel``) within ``atol``; with ``f_rel``, f and
    the virial within ``f_rel`` of their largest magnitude; the thermo
    rows within ``rtol_rows``."""
    got, vir, rows = record(sim)
    fields, ref_vir, ref_rows = ref
    for f in FIELDS:
        tol = atol
        if f == "f" and f_rel is not None:
            tol = f_rel * float(np.abs(fields[f]).max())
        np.testing.assert_allclose(got[f], fields[f], rtol=0, atol=tol,
                                   err_msg=f)
    vtol = atol if f_rel is None else f_rel * float(np.abs(ref_vir).max())
    np.testing.assert_allclose(vir, ref_vir, rtol=0, atol=vtol)
    check_rows(rows, ref_rows, rtol_rows)


def port_sim(builder, dtype, kernel, **kw):
    sim = builder(nmol=NMOL, dtype=dtype, kernel=kernel, device="cpu", **kw)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    return sim


# ---- the slice: reference path, r-RESPA, kernel path ------------------------

def test_molecular_reference_path_float64(jax_verlet):
    sim = port_sim(flagship.build_molecular_sim, torch.float64, False)
    assert sim.nbr_spec.method == "nsq" and sim.excl_tags is not None
    compare(sim, jax_verlet, 1e-9, 1e-9)


def test_molecular_respa_float64(jax_respa):
    sim = port_sim(flagship.build_respa_sim, torch.float64, False)
    assert sim.cfg.respa_inner == 4 and sim.cfg.dt == 0.004
    compare(sim, jax_respa, 1e-9, 1e-9)


def test_molecular_kernel_path_twin_float32(jax_verlet):
    before = dict(hp.ucgld_pair.launches)
    sim = port_sim(flagship.build_molecular_sim, torch.float32, True)
    assert sim.pair_compute is hp.compute_style
    assert isinstance(sim.nbr_spec, tcp.ColumnSpec)
    assert sim._excl_rows_static is not None and not sim._slot_ok
    compare(sim, jax_verlet, 5e-5, 1e-5, f_rel=5e-5)
    assert hp.ucgld_pair.launches == before        # CPU tensors: the twin


# ---- the list builders with exclusions -------------------------------------

def test_nsq_excl_matches_cell_and_jax():
    a = flagship.molecular_arrays(NMOL)
    n, L = 3 * NMOL, a["L"]
    excl_tags = flagship.bonded.special_tags(n, a["bonds"], a["angles"])
    rows = np.where(excl_tags > 0, excl_tags - 1, n)   # tag - 1 == row
    x = torch.as_tensor(a["x"])
    box = flagship.Box.create([0, 0, 0], [L] * 3, dtype=torch.float64)
    ex = torch.as_tensor(rows, dtype=torch.int64)
    got = {}
    for method in ("nsq", "cell"):
        spec = tnb.make_spec(n, [L] * 3, flagship.RC, 0.4, method=method)
        got[method] = tnb.build(x, box, spec, excl=ex)
        full = tnb.build(x, box, spec)
        assert int(got[method].max_occupancy) < int(full.max_occupancy)
    for i in range(n):
        assert (set(got["nsq"].idx[i].tolist())
                == set(got["cell"].idx[i].tolist())), i
    for b in a["bonds"]:
        assert b[3] - 1 not in got["nsq"].idx[b[2] - 1].tolist()
    jspec = jnb.make_spec(n, [L] * 3, flagship.RC, 0.4, method="nsq")
    jl = jax.jit(jnb.build, static_argnums=2)(
        jnp.asarray(a["x"]), JBox.create([0, 0, 0], [L] * 3,
                                         dtype=jnp.float64), jspec,
        excl=jnp.asarray(rows, jnp.int32))
    assert np.array_equal(got["nsq"].idx.numpy(), np.asarray(jl.idx))
    with pytest.raises(ValueError):
        tnb.build(x, box, tnb.make_spec(n, [L] * 3, 2.5, 0.4, method="nsq"),
                  valid=torch.ones(n, dtype=torch.bool))


# ---- excl_delta against the JAX package's ----------------------------------

@functools.lru_cache(maxsize=None)
def pair_inputs(kind):
    """(JAX state, port state, JAX params with their fit, port params,
    exclusion rows (N, S), JAX pair path function) of one f32 system:
    "ucgld" the molecular trimers, "mixed" a two-type fluid with
    synthetic close partners, "bethe"/"sce" the trimers under
    table_ucg_bethe with assigned posteriors."""
    f32 = jnp.float32
    if kind == "mixed":
        rng = np.random.default_rng(3)
        st, bank, tp, rc = helpers.build_mixed(dtype=f32)
        n, L = 256, 9.0
        x = rng.uniform(0, L, (n, 3))
        x[1::2] = (x[0::2] + rng.normal(0, 0.45, (n // 2, 3))) % L
        a = dict(x=x, L=L, v=np.zeros((n, 3)),
                 typ=np.where(rng.uniform(size=n) < 0.4, 1, 2),
                 ucgl=rng.uniform(0.2, 0.8, n),
                 ucgstate=rng.integers(0, 2, n), ucgml=np.full(n, 5.0),
                 mol=np.arange(1, n + 1))
        rows = np.full((n, 2), n, np.int64)
        rows[0::2, 0] = np.arange(1, n, 2)
        rows[1::2, 0] = np.arange(0, n, 2)
    else:
        a = flagship.molecular_arrays(NMOL)
        n = 3 * NMOL
        bank, tp = jax_tables(2000, f32,
                              "ucgld" if kind == "ucgld" else "bethe")
        et = flagship.bonded.special_tags(n, a["bonds"], a["angles"])
        rows = np.where(et > 0, et - 1, n)
        if kind != "ucgld":
            a = dict(a, ucgp=np.random.default_rng(4).uniform(0.1, 0.9, n))
    jstate = jax_state(a, f32)
    if "ucgp" in a:
        jstate = dataclasses.replace(jstate, ucgp=jnp.asarray(a["ucgp"], f32))
    cheb = fit(bank)
    if kind in ("ucgld", "mixed"):
        jparams = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8, f32),
                                  cheb=cheb)
        tparams = convert.params_from_numpy(convert.as_numpy_dict(jparams),
                                            device="cpu")
        jfn = jpu.compute
    else:
        jparams = dataclasses.replace(
            jpb.make_params(bank, tp, 0.8, prior_mode="chemical_potential",
                            pseudo=kind == "bethe", dtype=f32), cheb=cheb)
        tparams = convert.bethe_params_from_numpy(
            convert.as_numpy_dict(jparams), device="cpu")
        jfn = jpb.compute
    tstate = convert.state_from_numpy(convert.as_numpy_dict(jstate),
                                      device="cpu")
    return jstate, tstate, jparams, tparams, rows, jfn


_fits = {}


def fit(bank):
    """The JAX package's Chebyshev fit of ``bank``, once per bank."""
    if id(bank) not in _fits:
        _fits[id(bank)] = (bank, jchebtab.fit_bank(bank))
    return _fits[id(bank)][1]


def near(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("kind", ["ucgld", "mixed", "bethe", "sce"])
def test_excl_delta_matches_jax(kind):
    jstate, tstate, jparams, tparams, rows, _ = pair_inputs(kind)
    jfn, tfn = ((pk.excl_delta, hp.excl_delta) if kind in ("ucgld", "mixed")
                else (pk.excl_delta_bethe, hb.excl_delta_bethe))
    jd = jax.jit(lambda s, r: jfn(s, r, jparams))(
        jstate, jnp.asarray(rows, jnp.int32))
    td = tfn(tstate, torch.as_tensor(rows), tparams)
    for f in ("f", "ucgforce", "scores", "virial"):
        near(getattr(td, f).numpy(), getattr(jd, f), 2e-5, f)
    np.testing.assert_allclose(float(td.pe), float(jd.pe), rtol=2e-5)
    assert int(td.oob_low) == int(jd.oob_low)
    assert float(np.abs(np.asarray(jd.f)).max()) > 0


@pytest.mark.parametrize("kind", ["ucgld", "bethe"])
def test_twin_minus_excl_delta_matches_excluded_reference(kind):
    """The kernel path's composition on its twin: every in-cutoff pair of
    the column list, minus the special lists' delta, against the JAX
    package's XLA pair path on an nsq list without the specials."""
    jstate, tstate, jparams, tparams, rows, jfn = pair_inputs(kind)
    n, L = tstate.n_atoms, float(tstate.box.lengths[0])
    spec = tcp.measure_spec(tstate.x.numpy().astype(np.float64), [L] * 3,
                            flagship.RC, 0.4)
    cl = tcp.build(tstate.x, tstate.box, spec)
    ex = torch.as_tensor(rows)
    if kind == "ucgld":
        out = hp.compute(tstate, cl, tparams, tparams.cheb)
        d = hp.excl_delta(tstate, ex, tparams)
    else:
        out = hb.compute_bethe(tstate, cl, tparams, tparams.cheb)
        d = hb.excl_delta_bethe(tstate, ex, tparams)
    # the excluded nsq list (the JAX package's, test_nsq_excl_matches_...)
    tl = tnb.build(tstate.x, tstate.box,
                   tnb.make_spec(n, [L] * 3, flagship.RC, 0.4, method="nsq"),
                   excl=ex)
    jl = jnb.NeighborList(idx=jnp.asarray(tl.idx.numpy(), jnp.int32),
                          x0=jstate.x, overflow=jnp.asarray(False),
                          max_occupancy=jnp.asarray(0), capacity=tl.capacity)
    jp = dataclasses.replace(jparams, cheb=None)
    ref = jax.jit(lambda s, nl: jfn(s, nl, jp))(jstate, jl)
    near((out.f - d.f).numpy(), ref.f, 5e-5, "f")
    np.testing.assert_allclose(float(out.pe - d.pe), float(ref.pe),
                               rtol=3e-5)
    np.testing.assert_allclose((out.ucgforce - d.ucgforce).numpy(),
                               np.asarray(ref.ucgforce), rtol=0, atol=3e-5)
    np.testing.assert_allclose((out.scores - d.scores).numpy(),
                               np.asarray(ref.scores), rtol=0, atol=3e-5)


# ---- the cluster_switch event in both drivers ------------------------------

def jax_events(a, spec, n_events=1, **cs_kw):
    """The JAX package's events on the state of ``a`` (float64), as its
    driver's ``_cswitch_impl`` runs them from its state's key: wrap, the
    contact list of ``spec``, ``apply`` with a fresh split of the key.
    Returns [(types, 7-stat vector, the draws)] per event."""
    f64 = jnp.float64
    n = len(a["x"])
    cs = jcs.make_params(ntypes=2, dtype=f64, **cs_kw)

    @jax.jit
    def event(state, stats):
        state = dataclasses.replace(state, x=state.box.wrap(state.x))
        nbr = jnb.build(state.x, state.box, spec)
        key, sub = jax.random.split(state.key)
        u = jax.random.uniform(sub, (cs.maxmol + 1,), dtype=f64)
        st, stats, info = jcs.apply(sub, dataclasses.replace(state, key=key),
                                    nbr, cs, stats)
        return st, stats, u, info["converged"], nbr.overflow

    out, state = [], jax_state(a, f64)
    stats = jcs.ClusterSwitchStats.zeros(f64)
    for _ in range(n_events):
        state, stats, u, conv, ovf = event(state, stats)
        assert bool(conv) and not bool(ovf) and n == state.n_atoms
        out.append((np.asarray(state.typ), np.asarray(stats.v),
                    np.asarray(u)))
    return out


@functools.lru_cache(maxsize=None)
def jax_density_event(n):
    """The JAX package's first config-4 event at ``n`` beads on a contact
    cell list at the contact cutoff (its column-path event), max_sweeps
    n + 1 (the port builder's default)."""
    a = flagship.density_arrays(n)
    spec = jnb.make_spec(n, [a["L"]] * 3, 1.3, 0.0, method="cell")
    return jax_events(a, spec, maxmol=n, max_sweeps=n + 1,
                      **flagship.DENSITY_SWITCH)[0]


def port_event(sim, u):
    state, stats, info = sim._cswitch_event(sim.state, sim.cswitch_stats,
                                            torch.tensor(u))
    assert info["converged"] and not bool(info["nbr_overflow"])
    return state.typ.numpy(), stats.v.numpy()


@pytest.mark.parametrize("kernel", [True, False])
def test_density_event_matches_jax(kernel):
    """Config 4 at 512 beads: the port driver's event on the column path
    (its own contact cell list) and on the reference path (its pair
    list), against the JAX package's event, from the same state with the
    same draws.  Both packages get the same max_sweeps."""
    n = 512
    jtyp, jv, u = jax_density_event(n)
    sim = flagship.build_density_sim(n=n, dtype=torch.float64
                                     if not kernel else torch.float32,
                                     device="cpu", kernel=kernel,
                                     cluster_switch=True)
    assert (sim._cs_spec is not None) == kernel
    assert sim.cswitch[0].max_sweeps == n + 1
    typ, v = port_event(sim, u)
    assert np.array_equal(typ, jtyp) and np.array_equal(v, jv)
    assert (typ != sim.state.typ.numpy()).sum() > 0     # something flipped


def test_switch_deck_events_match_jax(tmp_path):
    """The molecular switch deck (reference path, bonded trimers): two
    events in a row from the same state as the JAX package's on its pair
    list, then the port driver's own ``run`` over 45 steps: events at
    steps 20 and 40 (the start of their blocks), two log rows each, whole molecules flipping,
    forces recomputed after each."""
    a = flagship.switch_arrays(64)
    events = jax_events(a, jnb.make_spec(192, [a["L"]] * 3, flagship.RC,
                                         0.4), n_events=2, maxmol=64,
                        **flagship.DENSITY_SWITCH)
    sim = flagship.build_switch_sim(dtype=torch.float64, device="cpu",
                                    log_dir=str(tmp_path))
    state, stats = sim.state, sim.cswitch_stats
    for jtyp, jv, u in events:
        state, stats, info = sim._cswitch_event(state, stats,
                                                torch.tensor(u))
        assert np.array_equal(state.typ.numpy(), jtyp)
        assert np.array_equal(stats.v.numpy(), jv)
    setups = []
    setup = sim.setup
    sim.setup = lambda w: setups.append(w) or setup(w)
    sim.run(45)
    assert len(setups) == 3                   # the start and two events
    for name in ("cluster_assignment", "state_assignment"):
        lines = (tmp_path / f"{name}.log").read_text().splitlines()
        assert [ln.split()[0] for ln in lines] == ["20", "40"]
        assert len(lines[0].split()) == 1 + 65
    typ = sim.state.typ.numpy().reshape(-1, 3)
    assert np.all(typ == typ[:, :1]) and float(sim.cswitch_stats.v[0]) > 0


# ---- errors and gates -------------------------------------------------------

def test_errors():
    dens = flagship.build_density_sim(n=512, device="cpu", kernel=True)
    excl = np.zeros((512, 1), np.int32)
    excl[0, 0], excl[1, 0] = 2, 1
    # a kernel path whose entry has no excl_delta (K8's) refuses exclusions
    clus = flagship.build_cluster_sim(n=512, device="cpu")
    assert getattr(clus.pair_compute, "excl_delta", None) is None
    with pytest.raises(NotImplementedError):
        Simulation(clus.system, clus.state, clus.pair_compute,
                   clus.pair_params, clus.nbr_spec, clus.cfg, excl_tags=excl)
    # the density styles take them pass by pass (tests/test_torch_density_
    # excl.py holds the result against the reference path)
    taken = Simulation(dens.system, dens.state, dens.pair_compute,
                       dens.pair_params, dens.nbr_spec, dens.cfg,
                       excl_tags=excl)
    assert (taken._excl_route == "rows"
            and taken._excl_rows_static is not None)
    # an all-zero list excludes nothing and is accepted
    Simulation(dens.system, dens.state, dens.pair_compute, dens.pair_params,
               dens.nbr_spec, dens.cfg, excl_tags=np.zeros((512, 1)))
    with pytest.raises(ValueError):
        Simulation(dens.system, dens.state, dens.pair_compute,
                   dens.pair_params, dens.nbr_spec, dens.cfg,
                   cluster_switch=(flagship.fcs.make_params(
                       ntypes=2, maxmol=512, device="cpu",
                       **flagship.DENSITY_SWITCH), 15))
    flag = flagship.build_sim(n=96, dtype=torch.float64, kernel=False,
                              device="cpu")
    flag.cfg = dataclasses.replace(flag.cfg, respa_inner=2)
    with pytest.raises(ValueError):
        flag.run(5)


def test_slot_interior_off_with_topology():
    mol = flagship.build_molecular_sim(nmol=NMOL, device="cpu", kernel=True)
    plain = flagship.build_sim(n=512, device="cpu", kernel=True)
    assert isinstance(mol.nbr_spec, tcp.ColumnSpec) and not mol._slot_ok
    assert plain._slot_ok
    bonded_only = Simulation(mol.system, mol.state, mol.pair_compute,
                             mol.pair_params, mol.nbr_spec, mol.cfg,
                             bonded=mol.bonded)
    assert not bonded_only._slot_ok
