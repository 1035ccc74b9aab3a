"""The rest of the spatial drivers on gloo ranks on the CPU: topology,
r-RESPA and ``fix cluster_switch`` on slabs and pencils
(``parallel/spatial.py``), the atom decomposition (``parallel/domain.py``)
and the decks that reach them, float64 on the reference path unless named.

* ``bonded.compute_spatial`` on a split of the rows against
  ``bonded.compute``: the sums over the ranks of f, pe and the virial are
  one device's, and a term with an absent member adds nothing;
* bent trimers with ``special_bonds lj 0 0 0`` (``build_molecular_sim``,
  300 beads) on 3 slabs and a 3×3 pencil grid against the port's single
  device at 1e-10 (x, v, λ, its velocity, f and the thermo rows), with
  Langevin on and, streaming at +4 in x so atoms migrate, under NVE; the
  NVE slabs against the JAX ``SpatialSimulation`` with ``bonded=`` and
  ``excl_tags=`` on 3 virtual CPU devices at 1e-9 (F1: the packages draw
  different noise);
* the kernel paths (the twins, float32) with the specials subtracted on
  slabs, at ``test_torch_spatial.py``'s kernel gates: K1 and K2 on
  trimers, and P3's in-pass route (ρ corrected on the owned rows before
  it reaches the ghosts) on bonded nearest-neighbour pairs;
* r-RESPA (2 inner steps) on slabs against one device at 1e-10, thermo
  included, and against JAX at 1e-9;
* config 4 with ``fix cluster_switch`` (512 beads, events at steps 4 and
  8) on slabs and pencils, and on slabs through the twins: the types, the
  7-stat vector and the logs exactly one device's; under NVE on slabs
  (events at steps 2 and 4), with the JAX package's accept draws injected,
  the types and the 7-stat vector exactly and the fields at 1e-9 of the
  JAX ``SpatialSimulation`` with ``cluster_switch=``; a ``max_sweeps`` of
  2 and a bond longer than the halo raise on every rank;
* the atom decomposition on 2 and 4 ranks bit for bit against one process,
  its thermo rows at 1e-6 (pe and the virial summed by rank): the flagship
  through K1's twin and in float64, P3 through K5/K3/K6's twins and
  ``xchg``, with and without bonds and their specials subtracted pass by
  pass; and a tilted deck (nsq) under ``processors 2 2 1``;
* decks under ``processors 3 1 1``: the molecular deck and config 4's with
  its switch against one process, ``rerun`` of a dump, and ``run 10`` then
  ``run 10`` bit for bit against ``run 20`` on the same ranks.

Each group of ranks runs under its own join limit (300 s); the references
on one process and the JAX runs go on meanwhile in the test process."""

import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.models import bonded as jbd
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.parallel import spatial as jsp
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
from lammps_ucg_dev_tpu_torch.models import bonded
from lammps_ucg_dev_tpu_torch.parallel import launch
from lammps_ucg_dev_tpu_torch.tools import make_deck as tmd
from lammps_ucg_dev_tpu_torch.tools import spatial_check as sc
from test_torch_core import one_torch_thread  # noqa: F401
from test_torch_spatial import COL_TOL, ROW_KEYS, near
from test_torch_topology_slice import jax_state, jax_tables

NMOL, SW_N, JOIN_S = 100, 512, 300.0
MOL_L = (3 * NMOL / flagship.MOL_RHO) ** (1 / 3)
SW_L = flagship.density_arrays(SW_N)["L"]
REF_F = ("x", "v", "ucgl", "ucgvl", "ucgp", "f")


def job(style, kernel=False, steps=10, **kw):
    return dict(kind="run", style=style, n=kw.pop("n", 3 * NMOL),
                steps=steps, thermo_every=5, arrays=True, kernel=kernel,
                dtype="float32" if kernel else "float64", **kw)


def switch_job(**kw):
    """Config 4 with its switch: reneighbour every 2, an event every 4
    unless ``freq`` says otherwise."""
    return job("switch", **dict(dict(n=SW_N, reneigh=2, freq=4), **kw))


MOL = job("molecular")
MOL_NVE = job("molecular", nve=True, stream=4.0)
SLAB_COL = {"K1": job("molecular", True), "K2": job("mol_bethe", True),
            "P3": job("p3", True, n=SW_N, reneigh=2, steps=6, bonds=96)}
RESPA = job("respa", respa_inner=2)
SWITCH = switch_job()
SWITCH_COL = switch_job(kernel=True)
SWITCH_NVE = switch_job(nve=True, freq=2, steps=6)   # events at 2 and 4
DOMAIN2 = [dict(kind="domain", style="ucgld", n=SW_N, kernel=True,
                dtype="float32", steps=6, reneigh=3, thermo_every=3),
           dict(kind="domain", style="p3", n=SW_N, kernel=True,
                dtype="float32", steps=6, reneigh=3, thermo_every=3),
           dict(kind="domain", style="p3", n=SW_N, kernel=True,
                dtype="float32", steps=6, reneigh=3, thermo_every=3,
                bonds=96)]
DOMAIN4 = dict(kind="domain", style="ucgld", n=SW_N, dtype="float64",
               steps=6, reneigh=3, thermo_every=3)


def single(j, log_dir=None):
    """One process's run of a job: (arrays, thermo rows, stats)."""
    sim = sc.build(dict(j, log_dir=log_dir), "cpu")
    sim.run(j["steps"], thermo_every=j.get("thermo_every", 0))
    stats = (None if sim.cswitch_stats is None
             else sim.cswitch_stats.v.tolist())
    return sc.arrays_of(sim.state, sim._fcarry), sim.thermo_rows, stats


def jax_molecular_slabs(respa_inner=1):
    """The JAX ``SpatialSimulation`` of the NVE trimers (or, with
    ``respa_inner``, ``build_respa_sim``'s) on 3 slabs: gathered fields in
    tag order."""
    import jax.numpy as jnp

    f64 = jnp.float64
    a = flagship.molecular_arrays(NMOL)
    n = 3 * NMOL
    bank, tp = jax_tables(2000, f64)
    params = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8, f64))
    if respa_inner > 1:
        cfg = JSimConfig(dt=0.004, units="lj",
                         integrator=jfi.IntegratorCfg("nve/ucgld"),
                         reneigh_every=5, respa_inner=respa_inner)
        bond = {1: (400.0, 0.9)}
    else:
        a["v"] = a["v"].copy()
        a["v"][:, 0] += MOL_NVE["stream"]
        cfg = JSimConfig(dt=0.002, units="lj",
                         integrator=jfi.IntegratorCfg("nve/ucgld/wall/hard"),
                         ucgstate=jfs.UCGStateCfg(mode="ld"),
                         reneigh_every=5)
        bond = {1: flagship.BOND}
    bp = jbd.make_params(a["bonds"], bond, a["angles"], {1: flagship.ANGLE},
                         dtype=f64)
    excl = jbd.special_tags(n, a["bonds"], a["angles"])
    state = jax_state(a, f64)
    slab = jsp.make_slab_spec(n, [a["L"]] * 3, flagship.RC, 0.4, 3,
                              x=np.asarray(state.x))
    sim = jsp.SpatialSimulation(
        JSystem(n_atoms=n, ntypes=1, masses=np.array([0.0, 1.0])), state,
        jpu.compute, params, slab, cfg, bonded=bp, excl_tags=excl)
    sim.run(10)
    st, _ = sim.gather()
    return {f: np.asarray(getattr(st, f)) for f in ("x", "v", "ucgl",
                                                    "ucgvl", "ucgp")}


def jax_switch_slabs():
    """The JAX ``SpatialSimulation`` of ``SWITCH_NVE`` (config 4 under NVE,
    ``cluster_switch=`` with events at steps 2 and 4) on 3 slabs: gathered
    fields in tag order, the 7-stat vector, and each event's accept draws,
    read from the key its ``attempt_switch`` is handed."""
    import jax
    import jax.numpy as jnp
    from lammps_ucg_dev_tpu.fixes import cluster_switch as jcs
    from lammps_ucg_dev_tpu.models import pair_bethe_density as jpd
    from test_torch_density import jax_p3_bank

    f64, n = jnp.float64, SW_N
    a = flagship.density_arrays(n)
    bank, tp = jax_p3_bank(flagship.DENSITY_SETTINGS, f64)
    params = jpd.make_params(bank, tp, flagship.DECK_T, dtype=f64)
    cs = jcs.make_params(ntypes=2, maxmol=n, max_sweeps=n + 1, dtype=f64,
                         **flagship.DENSITY_SWITCH)
    cfg = JSimConfig(dt=0.002, units="lj",
                     integrator=jfi.IntegratorCfg("nve/ucgld"),
                     reneigh_every=SWITCH_NVE["reneigh"])
    state = jax_state(a, f64)
    slab = jsp.make_slab_spec(n, [a["L"]] * 3, flagship.RC, 0.4, 3,
                              x=np.asarray(state.x))
    draws = {}              # every device draws alike: one entry an event
    attempt = jcs.attempt_switch

    def record(u):
        u = np.asarray(u)
        draws.setdefault(u.tobytes(), u)

    def attempt_recorded(key, *args):
        jax.debug.callback(record, jax.random.uniform(
            key, (cs.maxmol + 1,), dtype=f64))
        return attempt(key, *args)

    jcs.attempt_switch = attempt_recorded
    try:
        sim = jsp.SpatialSimulation(
            JSystem(n_atoms=n, ntypes=2, masses=np.array([0.0, 1.0, 1.0])),
            state, jpd.compute, params, slab, cfg,
            cluster_switch=(cs, SWITCH_NVE["freq"]))
        sim.run(SWITCH_NVE["steps"])
        st, _ = sim.gather()
    finally:
        jcs.attempt_switch = attempt
    arrays = {f: np.asarray(getattr(st, f))
              for f in ("x", "v", "ucgl", "ucgvl", "ucgp", "typ")}
    return arrays, np.asarray(sim.cswitch_stats.v).tolist(), [
        u.tolist() for u in draws.values()]


def deck_file(d, writer, processors=None, edit=None) -> str:
    """A deck from ``writer(d)``, ``processors`` prepended, ``edit``
    applied to its text."""
    path = writer(str(d))
    text = open(path).read()
    if edit is not None:
        text = edit(text)
    if processors:
        text = f"processors {processors}\n" + text
    with open(path, "w") as fh:
        fh.write(text)
    return path


DECKS = {
    "molecular": (lambda d: tmd.write_molecular_ucgld_deck(
        d, nmol=NMOL, nsteps=20, thermo_every=10), None),
    "config4": (lambda d: tmd.write_bethe_density_deck(
        d, n=SW_N, nsteps=25, switch_freq=10, thermo_every=5), None),
    "rerun": (lambda d: tmd.write_molecular_ucgld_deck(
        d, nmol=NMOL, nsteps=10, thermo_every=5),
        lambda t: t.replace("thermo 5", "thermo 5\ndump d1 all custom 5 "
                            "traj.dump id type x y z ucgstate ucgl ucgp")
        .replace("run 10", "run 10\nundump d1\nrerun traj.dump dump x y z "
                 "ucgstate ucgl ucgp")),
    "tilted": (lambda d: tmd.write_ucgld_deck(
        d, n=SW_N, nsteps=10, thermo_every=5, tilt=(0.1, -0.05, 0.08)),
        None),
}
DECKS["cont"] = (DECKS["molecular"][0],
                 lambda t: t.replace("run 20", "run 10\nrun 10"))


def one_deck(d, name):
    writer, edit = DECKS[name]
    r = ScriptRunner(workdir=str(d), device="cpu",
                     log_callback=lambda m: None)
    r.run_file(deck_file(d, writer, None, edit))
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_topology")
    logs = {k: tmp / k for k in ("one", "slabs", "pencils")}
    for d in logs.values():
        d.mkdir()

    def deck_job(name, processors, edit=None, sub=None):
        d = tmp / (sub or name)
        writer, e = DECKS.get(name, (None, None))
        return dict(kind="deck", path=deck_file(d, writer, processors,
                                                edit or e),
                    workdir=str(d), arrays=True)

    a = launch.start(sc.run_jobs, 3, [
        dict(j, dims=(3, 1)) for j in
        [MOL, MOL_NVE, *SLAB_COL.values(), RESPA,
         dict(SWITCH, log_dir=str(logs["slabs"])), SWITCH_COL,
         dict(SWITCH, max_sweeps=2, expect_error=True, steps=5),
         dict(MOL, far_bond=True, expect_error=True, steps=0)]],
        device="cpu", timeout=JOIN_S)
    b = launch.start(sc.run_jobs, 3, [
        dict(deck_job(k, "3 1 1"), dims=(3, 1))
        for k in ("molecular", "config4", "rerun", "cont")]
        + [dict(deck_job("molecular", "3 1 1", sub="run20"), dims=(3, 1))],
        device="cpu", timeout=JOIN_S)
    c = launch.start(sc.run_jobs, 9, [
        dict(MOL, dims=(3, 3)),
        dict(SWITCH, dims=(3, 3), log_dir=str(logs["pencils"]))],
        device="cpu", timeout=JOIN_S)
    e = launch.start(sc.run_jobs, 4, [
        dict(DOMAIN4, dims=(4, 1)),
        dict(deck_job("tilted", "2 2 1"), dims=(2, 2))],
        device="cpu", timeout=JOIN_S)
    f = launch.start(sc.run_jobs, 2, [dict(j, dims=(2, 1)) for j in DOMAIN2],
                     device="cpu", timeout=JOIN_S)
    jsw = jax_switch_slabs()
    g = launch.start(sc.run_jobs, 3, [dict(SWITCH_NVE, dims=(3, 1),
                                           cs_draws=jsw[2])],
                     device="cpu", timeout=JOIN_S)
    out = {"jax": {1: jax_molecular_slabs(1), 2: jax_molecular_slabs(2),
                   "switch": jsw}}
    out["single"] = {k: single(j) for k, j in
                     [("mol", MOL), ("mol_nve", MOL_NVE), ("respa", RESPA),
                      ("switch_col", SWITCH_COL)]
                     + [(k, j) for k, j in SLAB_COL.items()]}
    out["single"]["switch"] = single(SWITCH, str(logs["one"]))
    out["single"]["domain"] = [single(dict(j, kind="run"))
                               for j in DOMAIN2 + [DOMAIN4]]
    out["single"]["domain4"] = out["single"]["domain"].pop()
    out["decks"] = {k: one_deck(tmp / f"{k}_one", k)
                    for k in ("molecular", "config4", "rerun", "tilted")}
    res = a.join()
    out["slabs"] = dict(zip(
        ["mol", "mol_nve", *SLAB_COL, "respa", "switch", "switch_col"],
        res[0][:8]))
    out["errors"] = {"max_sweeps": [r[8]["error"] for r in res],
                     "far_bond": [r[9]["error"] for r in res]}
    res = b.join()
    out["slab_decks"] = dict(zip(("molecular", "config4", "rerun", "cont",
                                  "run20"), res[0]))
    res = c.join()
    out["pencils"] = {"mol": res[0][0], "switch": res[0][1]}
    res = e.join()
    out["domain4"] = [r[0] for r in res]
    out["tilted"] = res[0][1]
    res = f.join()
    out["domain2"] = [[r[k] for r in res] for k in range(len(DOMAIN2))]
    out["slabs"]["switch_jax"] = g.join()[0][0]
    out["logs"] = {k: {name: open(d / f"{name}.log").read()
                       for name in ("cluster_assignment", "state_assignment")}
                   for k, d in logs.items()}
    return out


def rows_near(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ROW_KEYS:
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, atol=1e-12,
                                       err_msg=k)


def equal(got, ref):
    """Every per-atom field bit for bit."""
    for f in ref:
        assert torch.equal(torch.as_tensor(got[f]),
                           torch.as_tensor(ref[f])), f


# ---- compute_spatial --------------------------------------------------------

def test_compute_spatial_sums_to_one_device():
    """Three x-slabs of the trimers, each with its owned rows first and
    every other atom behind them (the rows of a rank that sees the whole
    system): f by tag, pe and the virial summed over the slabs equal
    ``compute``'s; with the ghosts cut to those within 1.5 of the slab,
    the terms that lose a member add nothing and the rest are unchanged."""
    sim = flagship.build_molecular_sim(NMOL, dtype=torch.float64,
                                       device="cpu", kernel=False)
    st, bp = sim.state, sim.bonded
    f1, pe1, vir1 = bonded.compute(st, bp)
    x = st.box.wrap(st.x)[:, 0]
    w = MOL_L / 3
    f, pe, vir = torch.zeros_like(f1), 0.0, 0.0
    part = []
    for d in range(3):
        own = (x >= d * w) & (x < (d + 1) * w)
        near_ = (torch.remainder(x - d * w + 1.5, MOL_L) < w + 3.0) & ~own
        for keep in (torch.ones_like(own), near_):
            order = torch.cat([torch.nonzero(own)[:, 0],
                               torch.nonzero(keep & ~own)[:, 0]])
            loc = st.permute(order)
            inv = torch.full((st.n_atoms + 1,), len(order), dtype=torch.long)
            inv[loc.tag.long() - 1] = torch.arange(len(order))
            rows = {k: tuple(inv[getattr(bp, f"{k}_tags")[:, m] - 1]
                             for m in range(getattr(bp, f"{k}_tags")
                                            .shape[1]))
                    for k in ("bond", "angle", "dihedral", "improper")}
            fl, pel, virl = bonded.compute_spatial(loc, bp, rows,
                                                   int(own.sum()))
            if keep.all():
                f[order] += fl
                pe, vir = pe + pel, vir + virl
            else:
                part.append((order, fl, rows, int(own.sum())))
    assert float((f - f1).abs().max()) <= 1e-12 * float(f1.abs().max())
    assert abs(float(pe) - float(pe1)) <= 1e-12 * abs(float(pe1))
    assert float((vir - vir1).abs().max()) <= 1e-12 * float(
        vir1.abs().max())
    lost = 0
    for order, fl, rows, nloc in part:
        n = len(order)
        whole = torch.ones(bp.n_bonds, dtype=torch.bool)
        for r in rows["bond"]:
            whole &= r < n
        lost += int((~whole).sum())
        # an owned atom's force is the whole system's where all its terms
        # are present
        full = f1[order[:nloc]]
        touched = torch.zeros(n, dtype=torch.bool)
        for k in ("bond", "angle"):
            rs = rows[k]
            pres = rs[0] < n
            for r in rs[1:]:
                pres = pres & (r < n)
            for r in rs:
                touched[r[~pres & (r < n)]] = True
        ok = ~touched[:nloc]
        assert torch.allclose(fl[:nloc][ok], full[ok], rtol=0, atol=1e-12)
        assert float(fl[nloc:].abs().max()) == 0.0
    assert lost > 0


def test_a_bond_past_the_halo_raises_on_every_rank(runs):
    assert all(e is not None and "spatial capacity" in e
               for e in runs["errors"]["far_bond"])


# ---- topology on slabs and pencils ------------------------------------------

@pytest.mark.parametrize("grid", ["slabs", "pencils"])
def test_trimers_match_one_device(runs, grid):
    got = runs[grid]["mol"]
    arrays, rows, _ = runs["single"]["mol"]
    near(got["arrays"], arrays, {f: 1e-10 for f in REF_F}, MOL_L)
    assert (got["arrays"]["ucgstate"] == arrays["ucgstate"]).all()
    rows_near(got["rows"], rows, 1e-10)
    assert got["tags_ok"]


def test_trimers_migrate_and_match_one_device_and_jax(runs):
    got = runs["slabs"]["mol_nve"]
    arrays, rows, _ = runs["single"]["mol_nve"]
    assert got["migrations"] > 0
    near(got["arrays"], arrays, {f: 1e-10 for f in REF_F}, MOL_L)
    rows_near(got["rows"], rows, 1e-10)
    near(got["arrays"], runs["jax"][1],
         {f: 1e-9 for f in ("x", "v", "ucgl", "ucgvl", "ucgp")}, MOL_L)


@pytest.mark.parametrize("path", sorted(SLAB_COL))
def test_column_path_with_exclusions_on_slabs(runs, path):
    """K1 and K2 with ``excl_delta`` subtracted, and P3 with the specials
    subtracted pass by pass, through the twins on 3 slabs."""
    got = runs["slabs"][path]
    arrays, rows, _ = runs["single"][path]
    L = SW_L if path == "P3" else MOL_L
    near(got["arrays"], arrays, COL_TOL, L)
    assert (got["arrays"]["ucgstate"] == arrays["ucgstate"]).all()
    rows_near(got["rows"], rows, 1e-5)


def test_respa_on_slabs(runs):
    got = runs["slabs"]["respa"]
    arrays, rows, _ = runs["single"]["respa"]
    near(got["arrays"], arrays, {f: 1e-10 for f in REF_F}, MOL_L)
    rows_near(got["rows"], rows, 1e-10)
    near(got["arrays"], runs["jax"][2],
         {f: 1e-9 for f in ("x", "v", "ucgl", "ucgvl")}, MOL_L)


# ---- fix cluster_switch -----------------------------------------------------

@pytest.mark.parametrize("grid", ["slabs", "pencils", "slabs_column"])
def test_cluster_switch_matches_one_device(runs, grid):
    if grid == "slabs_column":
        got, ref = runs["slabs"]["switch_col"], runs["single"]["switch_col"]
    else:
        got, ref = runs[grid]["switch"], runs["single"]["switch"]
    arrays, rows, stats = ref
    assert got["cs_stats"] == stats and stats[0] > 0
    assert len(got["cs_sweeps"]) == 2
    assert np.array_equal(got["arrays"]["typ"], arrays["typ"])
    tol = (COL_TOL if grid == "slabs_column"
           else {f: 1e-10 for f in REF_F})
    near(got["arrays"], arrays, tol, SW_L)
    if grid != "slabs_column":
        assert runs["logs"][grid] == runs["logs"]["one"]
        assert runs["logs"]["one"]["state_assignment"].count("\n") == 2


def test_cluster_switch_on_slabs_matches_jax(runs):
    """Config 4 under NVE on 3 slabs, the events drawing the JAX package's
    uniforms: the flipped types and the 7-stat vector exactly, the fields
    at 1e-9 of the JAX ``SpatialSimulation``'s."""
    got = runs["slabs"]["switch_jax"]
    arrays, stats, draws = runs["jax"]["switch"]
    assert len(draws) == 2 and len(got["cs_sweeps"]) == 2
    assert got["cs_stats"] == stats and stats[1] > 0
    assert np.array_equal(got["arrays"]["typ"], arrays["typ"])
    near(got["arrays"], arrays,
         {f: 1e-9 for f in ("x", "v", "ucgl", "ucgvl", "ucgp")}, SW_L)


def test_max_sweeps_raises_on_every_rank(runs):
    assert all(e is not None and "max_sweeps" in e
               for e in runs["errors"]["max_sweeps"])


# ---- the atom decomposition -------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 2],
                         ids=["flagship_k1", "p3_xchg", "p3_bonds"])
def test_domain_two_ranks_bit_identical(runs, k):
    """Every rank's state bit for bit one process's; the thermo rows, pe
    and the virial summed by rank, at 1e-6 (with bonds: the specials come
    off each rank's owned rows once)."""
    ref, rows, _ = runs["single"]["domain"][k]
    for got in runs["domain2"][k]:
        equal(got["arrays"], ref)
        rows_near(got["rows"], rows, 1e-6)


def test_domain_four_ranks_bit_identical(runs):
    ref, rows, _ = runs["single"]["domain4"]
    for got in runs["domain4"]:
        equal(got["arrays"], ref)
        rows_near(got["rows"], rows, 1e-10)


def test_tilted_deck_falls_back_to_domain(runs):
    got = runs["tilted"]
    one = runs["decks"]["tilted"]
    assert got["driver"] == "DomainSimulation" and "nsq" in got["pair_path"]
    equal(got["arrays"], sc.arrays_of(one.state, one.sim._fcarry))
    rows_near(got["rows"], one.thermo_rows, 1e-6)   # f32 pe summed by rank


def test_domain_needs_divisible_atoms():
    from lammps_ucg_dev_tpu_torch.parallel import domain

    class Two:
        world, rank, dims = 3, 0, (3, 1)

    sim = flagship.build_sim(n=512, dtype=torch.float64, device="cpu",
                             kernel=False)
    with pytest.raises(ValueError, match="not divisible"):
        domain.from_simulation(sim, Two())


# ---- decks ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["molecular", "config4", "rerun"])
def test_processors_decks_match_one_process(runs, name):
    got = runs["slab_decks"][name]
    one = runs["decks"][name]
    assert got["spatial"]
    rows_near(got["rows"], one.thermo_rows, 1e-6)
    if name == "config4":
        assert got["cs_stats"] == one.sim.cswitch_stats.v.tolist()
    if name == "rerun":
        assert [r["step"] for r in got["rows"]] == [0, 5, 10, 0, 5, 10]


def test_continued_run_is_bit_identical(runs):
    """``run 10`` then ``run 10`` under ``processors 3 1 1`` resume the
    ranks' carry: the state and the thermo rows of ``run 20``."""
    cont, whole = runs["slab_decks"]["cont"], runs["slab_decks"]["run20"]
    equal(cont["arrays"], whole["arrays"])
    rows = [r for k, r in enumerate(cont["rows"]) if k != 2]  # run 2's head
    assert rows == whole["rows"]
