"""The deck entry point, ``compat.script.ScriptRunner``, against the JAX
package's on the CPU (float64; the JAX side runs jitted XLA, never
interpret-mode Pallas; on the CPU the port's kernel selection declines and
its reference pair paths run).

* Each of the seven deck writers' decks (and six on other table styles)
  through both runners: the state after ``read_data`` and ``velocity``
  bit for bit, and the step-0 thermo row at 1e-10 relative.
* NVE trajectories (no thermostat, no ``ucgstate``), thermo rows and state
  at 1e-9 over 20 steps: the UCG-LD deck (also on ``lookup``, ``spline``
  and ``bitmap`` tables), a ``fix nve`` deck (kind
  ``"nve"``), ``unfix 1`` then ``run`` (kind ``"none"``), and the molecular
  deck under ``run_style respa``.
* The missing-thermostat guard's errors, word for word the JAX runner's.
* ``rerun ... every N`` takes the snapshots whose TIMESTEP is a multiple
  of N.
* ``fix ucgstate mc SEED``: the same seed gives the same stream, another
  seed another.
* Continuity: ``run 20`` against ``run 10`` + ``write_restart`` + a new
  runner's ``read_restart`` + ``run 10``, and against two ``run 10``, bit
  for bit with the Langevin noise on.
* The refusals: ``processors 2 1 1`` without a process group of 2 ranks
  raises ValueError; without a GPU the default device raises.
* Table styles: decks with ``lookup``, ``spline`` and ``bitmap`` tables
  at step 0 (cases of ``test_deck_step0_matches_jax``), and a tilted box
  (``xy xz yz`` in the data file): the runner switches to the nsq list,
  step 0 and a 20-step NVE trajectory against the JAX runner, then the
  port's restart of it, read by both runners, 10 steps more.
* Special exclusions on a style without ``excl_delta`` (a density deck
  with bonds): the runner takes the reference path, whose list leaves the
  specials out, and matches the JAX runner at step 0; with the kernel
  selection forced it raises.
* Config 4's deck at 4,096 beads runs its events to convergence under
  the runner's ``max_sweeps`` n + 1 (the second took more than 64 sweeps,
  the cap that raised before).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.compat.script import ScriptRunner as JRunner
from lammps_ucg_dev_tpu_torch.compat import script as script_mod
from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
from lammps_ucg_dev_tpu_torch.io import dump as dmp
from lammps_ucg_dev_tpu_torch.io import restart as rst
from lammps_ucg_dev_tpu_torch.tools import make_deck as tmd
from test_torch_core import one_torch_thread  # noqa: F401

FIELDS = ("x", "v", "tag", "typ", "mol", "q", "image", "ucgstate", "ucgl",
          "ucgvl", "ucgml", "ucgp")
DYNAMIC = ("x", "v", "ucgl", "ucgvl", "ucgp", "ucgstate")

WRITERS = {
    "ucgld": (tmd.write_ucgld_deck, dict(n=128, tablength=800)),
    "bethe": (tmd.write_bethe_deck, dict(n=128)),
    "bethe_density": (tmd.write_bethe_density_deck, dict(n=128)),
    "rleucg": (tmd.write_rleucg_deck, dict(n=128)),
    "molecular_switch": (tmd.write_molecular_switch_deck, dict(nmol=32)),
    "molecular_ucgld": (tmd.write_molecular_ucgld_deck, dict(nmol=32)),
    "molecular_tetramer": (tmd.write_molecular_tetramer_deck,
                           dict(nmol=24)),
    # the table styles: LOOKUP, SPLINE and BITMAP banks (BITMAP's length is
    # its index bits)
    "ucgld_lookup": (tmd.write_ucgld_deck,
                     dict(n=128, tabstyle="lookup", tablength=800)),
    "ucgld_spline": (tmd.write_ucgld_deck,
                     dict(n=128, tabstyle="spline", tablength=800)),
    "ucgld_bitmap": (tmd.write_ucgld_deck,
                     dict(n=128, tabstyle="bitmap", tablength=12)),
    "bethe_spline": (tmd.write_bethe_deck,
                     dict(n=128, tabstyle="spline", tablength=800)),
    "bethe_density_bitmap": (tmd.write_bethe_density_deck,
                             dict(n=128, tabstyle="bitmap", tablength=12)),
    "rleucg_lookup": (tmd.write_rleucg_deck,
                      dict(n=128, tabstyle="lookup", tablength=800)),
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def runners(d, logs=None):
    j = JRunner(workdir=str(d), dtype=jnp.float64, log_callback=lambda m: None)
    t = ScriptRunner(workdir=str(d), dtype=torch.float64, device="cpu",
                     log_callback=(logs.append if logs is not None
                                   else lambda m: None))
    return j, t


def lines_of(text):
    return [s.strip() for s in text.splitlines()
            if s.split("#")[0].strip()]


def assert_rows_close(jrows, trows, rtol):
    assert len(jrows) == len(trows) > 0
    for a, b in zip(jrows, trows):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_deck_step0_matches_jax(tmp_path, name):
    writer, kw = WRITERS[name]
    deck = writer(str(tmp_path), nsteps=0, **kw)
    text = lines_of(open(deck).read())
    assert text[-1] == "run 0"
    jr, tr = runners(tmp_path)
    for line in text[:-1]:
        jr.command(line)
        tr.command(line)
    for f in FIELDS:                 # read_data and velocity, bit for bit
        a, b = np.asarray(getattr(jr.state, f)), _np(getattr(tr.state, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    jr.command("run 0")
    tr.command("run 0")
    assert_rows_close(jr.thermo_rows, tr.thermo_rows, 1e-10)
    assert tr.pair_path.startswith("reference PyTorch pair path")


def _drop(text, *prefixes):
    return "\n".join(s for s in text.splitlines()
                     if not s.startswith(prefixes)) + "\n"


TABSTYLES = {"ucgld": ("linear", 800), "lookup": ("lookup", 800),
             "spline": ("spline", 800), "bitmap": ("bitmap", 12)}


def nve_deck(tmp_path, kind):
    """Deck text of the NVE trajectory cases: no thermostat and no
    ucgstate, thermo every 10.  ``ucgld`` (and on ``lookup``, ``spline``
    and ``bitmap`` tables) and ``respa``: 20 steps; ``nve_none``: ``fix
    nve`` for 20 steps, then ``unfix 1`` and 10 more."""
    if kind == "respa":
        deck = tmd.write_molecular_ucgld_deck(str(tmp_path), nmol=40,
                                              nsteps=20, thermo_every=10)
        text = _drop(open(deck).read(), "fix 2", "fix 3")
        return text.replace("run 20",
                            "run_style respa 2 4 bond 1 angle 1 pair 2\n"
                            "run 20")
    tabstyle, length = TABSTYLES.get(kind, TABSTYLES["ucgld"])
    deck = tmd.write_ucgld_deck(str(tmp_path), n=128, nsteps=20,
                                thermo_every=10, tablength=length,
                                tabstyle=tabstyle, thermostat=False)
    text = _drop(open(deck).read(), "fix 3")
    if kind == "nve_none":
        text = text.replace("fix 1 all nve/ucgld/wall/hard bias_potential 0.1",
                            "fix 1 all nve")
        text = text.replace("run 20", "run 20\nunfix 1\nrun 10")
    return text


def assert_state_close(jstate, tstate, tol=1e-9):
    for f in ("x", "v", "ucgl", "ucgvl"):
        np.testing.assert_allclose(_np(getattr(tstate, f)),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("kind", ["ucgld", "respa", "lookup", "spline",
                                  "bitmap"])
def test_nve_trajectory_matches_jax(tmp_path, kind):
    text = nve_deck(tmp_path, kind)
    jr, tr = runners(tmp_path)
    jr.run_string(text)
    tr.run_string(text)
    assert_rows_close(jr.thermo_rows, tr.thermo_rows, 1e-9)
    assert_state_close(jr.state, tr.state)
    assert tr.state.step == 20


@pytest.fixture(scope="module")
def nve_then_none(tmp_path_factory):
    """The ``fix nve`` deck through both runners, split after its first
    run: (JAX runner, port runner, states after the first run)."""
    d = tmp_path_factory.mktemp("nve_none")
    text = nve_deck(d, "nve_none")
    first, rest = text.split("unfix 1\n")
    jr, tr = runners(d)
    out = []
    for r in (jr, tr):
        r.run_string(first)
        out.append(r.state)
        r.run_string("unfix 1\n" + rest)
    return jr, tr, out


def test_fix_nve_trajectory_matches_jax(nve_then_none):
    """Kind "nve": stock fix nve moves x and v, leaves λ."""
    jr, tr, (j20, t20) = nve_then_none
    assert_rows_close(jr.thermo_rows[:3], tr.thermo_rows[:3], 1e-9)
    assert_state_close(j20, t20)
    assert t20.step == 20
    lam0 = np.clip(np.asarray(jr.datafile.ucgl), 0, 1)
    np.testing.assert_array_equal(_np(t20.ucgl), lam0)
    assert float(t20.ucgvl.abs().max()) == 0.0


def test_unfix_leaves_kind_none(nve_then_none):
    """Kind "none": after ``unfix 1`` a run integrates nothing."""
    jr, tr, (_, t20) = nve_then_none
    assert tr.integrator.kind == "none" and tr.state.step == 30
    assert_rows_close(jr.thermo_rows[3:], tr.thermo_rows[3:], 1e-9)
    assert [r["step"] for r in tr.thermo_rows] == [0, 10, 20, 20, 30]
    for f in DYNAMIC:
        assert torch.equal(getattr(tr.state, f), getattr(t20, f)), f
    assert_state_close(jr.state, tr.state)


@pytest.mark.parametrize("deck", ["bethe", "ucgstate"])
def test_missing_thermostat_guard(tmp_path, deck):
    if deck == "bethe":
        path = tmd.write_bethe_deck(str(tmp_path), n=64, nsteps=5)
    else:
        path = tmd.write_ucgld_deck(str(tmp_path), n=64, nsteps=5,
                                    tablength=800)
    text = _drop(open(path).read(), "fix 2")
    jr, tr = runners(tmp_path)
    with pytest.raises(ValueError) as je:
        jr.run_string(text)
    with pytest.raises(ValueError) as te:
        tr.run_string(text)
    assert str(te.value) == str(je.value)
    assert ("thermostat" in str(te.value)
            and ("kT" in str(te.value)) == (deck == "bethe"))


def test_rerun_every_is_timestep_multiple(tmp_path):
    deck = tmd.write_ucgld_deck(str(tmp_path), n=128, nsteps=30, dt=0.002,
                                tablength=800)
    text = open(deck).read().replace(
        "thermo 100",
        "dump d1 all custom 10 traj.lammpstrj id type x y z ucgl\nthermo 100")
    r = ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                     device="cpu", log_callback=lambda m: None)
    r.run_string(text)   # snapshots at steps 0, 10, 20, 30
    assert [s.step for s in dmp.read_dump(
        str(tmp_path / "traj.lammpstrj"))] == [0, 10, 20, 30]
    r2 = ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                      device="cpu", log_callback=lambda m: None)
    r2.run_string("""units lj
atom_style ucg
read_data system.data
pair_style table_ucgld linear 800 ucg.settings
pair_coeff 1 1 2 2 ucg.table UCG_00 2.5 ucg.table UCG_01 2.5 ucg.table UCG_10 2.5 ucg.table UCG_11 2.5
timestep 0.002
fix 2 all ucgld/langevin 0.8 0.8 0.5 99
fix 3 all ucgstate
thermo 1
dump d2 all custom 1 rerun_out.lammpstrj id ucgl
rerun traj.lammpstrj every 20 dump x y z ucgl
""")
    out = dmp.read_dump(str(tmp_path / "rerun_out.lammpstrj"))
    assert [s.step for s in out] == [0, 20]
    assert [row["step"] for row in r2.thermo_rows] == [0, 20]


def test_ucgstate_mc_seed_selects_the_stream(tmp_path):
    """fix ucgstate mc SEED rate: the seed selects the mc draw stream
    (fix_ucgstate.cpp:37-67); the states of every step are dumped."""
    def run(sub, seed):
        d = tmp_path / sub
        deck = tmd.write_bethe_deck(str(d), n=96, nsteps=20, thermo_every=0)
        text = open(deck).read().replace(
            "fix 3 all ucgstate",
            f"fix 3 all ucgstate mc {seed} 0.9\n"
            "dump d1 all custom 1 s.lammpstrj id ucgstate")
        r = ScriptRunner(workdir=str(d), dtype=torch.float64, device="cpu",
                         log_callback=lambda m: None)
        r.run_string(text)
        assert r.mc_generator is not None
        return np.stack([s.fields["ucgstate"] for s in
                         dmp.read_dump(str(d / "s.lammpstrj"))])

    s_a, s_b, s_a2 = run("a", 12345), run("b", 54321), run("c", 12345)
    assert s_a.shape == (21, 96)
    np.testing.assert_array_equal(s_a, s_a2)   # same seed = same stream
    assert np.any(s_a != s_b)                  # another seed, another


CONT_STYLES = """units lj
atom_style ucg
read_restart a.npz
pair_style table_ucgld linear 800 ucg.settings
pair_coeff 1 1 2 2 ucg.table UCG_00 2.5 ucg.table UCG_01 2.5 ucg.table UCG_10 2.5 ucg.table UCG_11 2.5
neighbor 0.4 bin
neigh_modify every 10
timestep 0.004
fix 1 all nve/ucgld/wall/hard bias_potential 0.1
fix 2 all ucgld/langevin 0.8 0.8 0.5 9
fix 3 all ucgstate ld
thermo 10
"""


def test_restart_continuity_bit_for_bit(tmp_path):
    """The deck's Langevin noise and carried forces survive a restart and
    a second ``run``: three ways to 20 steps give the same bits."""
    deck = tmd.write_ucgld_deck(str(tmp_path), n=128, nsteps=20,
                                thermo_every=10, tablength=800)
    text = open(deck).read()

    def runner(logs=None):
        return ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                            device="cpu",
                            log_callback=(logs.append if logs is not None
                                          else lambda m: None))

    a = runner()
    a.run_string(text)
    b = runner()
    b.run_string(text.replace("run 20", "run 10\nwrite_restart a.npz"))
    logs = []
    c = runner(logs)
    c.run_string(CONT_STYLES + "run 10\n")
    d = runner()
    d.run_string(text.replace("run 20", "run 10\nrun 10"))
    assert not any("afresh" in m or "restart from" in m for m in logs)
    for other in (c, d):
        assert other.state.step == 20
        for f in DYNAMIC:
            assert torch.equal(getattr(a.state, f), getattr(other.state, f)), f
    assert a.thermo_rows[-1] == c.thermo_rows[-1] == d.thermo_rows[-1]
    # another thermostat seed is another physics: set up afresh
    e = runner(logs)
    e.run_string(CONT_STYLES.replace("0.5 9", "0.5 10") + "run 10\n")
    assert any("afresh" in m for m in logs)
    assert not torch.equal(a.state.ucgvl, e.state.ucgvl)


def test_restart_without_port_random_state_reseeds(tmp_path):
    """A restart without the port's random state (as the JAX package
    writes it) restarts the streams from the deck's seed, with a log
    line."""
    deck = tmd.write_ucgld_deck(str(tmp_path), n=128, nsteps=10,
                                thermo_every=10, tablength=800)
    r = ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                     device="cpu", log_callback=lambda m: None)
    r.run_file(deck)
    rst.write_restart(str(tmp_path / "a.npz"), r.state,
                      settings={"units": "lj", "masses": np.ones(2)})
    logs = []
    c = ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                     device="cpu", log_callback=logs.append)
    c.run_string(CONT_STYLES + "run 10\n")
    assert any("restart from the deck's seed" in m for m in logs)
    assert c.state.step == 20 and c.thermo_rows[0]["step"] == 10


def test_refusals(tmp_path):
    deck = tmd.write_ucgld_deck(str(tmp_path), n=64, nsteps=5, tablength=800)
    text = open(deck).read()

    def runner():
        return ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                            device="cpu", log_callback=lambda m: None)

    # a grid above one subdomain needs a process group of its size (the
    # spatial drivers, tests/test_torch_spatial.py); here there is none
    with pytest.raises(ValueError, match="process group"):
        runner().run_string("processors 2 1 1\n" + text)
    runner().run_string("processors 1 1 1\n" + text)        # one device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ScriptRunner(workdir=str(tmp_path))


def exclusion_deck_checks(tmp_path, monkeypatch, writer, entry):
    """The checks of the density styles' special exclusions on one deck
    style (``writer``, whose kernel entry is ``entry``): bonds with
    ``special_bonds lj 0 0 0``; the float64 reference path where the
    selection declines (the CPU) at step 0 against the JAX runner at
    1e-10; then the kernel path forced onto the wrappers' CPU twins
    (float32) with the density ``excl_delta``, against the JAX runner's
    float64 rows at step 0 and over 20 steps and against the float32
    reference path, at 1e-6 relative in temp, pe, ke and press (measured
    ≤ 2.5e-7 against float64, ≤ 1.4e-7 against float32).  λ's rows are
    not compared over the run: the two runners draw different Langevin
    noise (ROADMAP F1), which these styles' forces never read."""
    def deck(nsteps):
        d = tmp_path / f"n{nsteps}"
        kw = dict(thermo_every=10) if nsteps else {}
        return tmd.add_bonds(writer(str(d), n=512, nsteps=nsteps, **kw),
                             nbonds=16), d

    def runner(d, logs, dtype=torch.float32):
        return ScriptRunner(workdir=str(d), dtype=dtype, device="cpu",
                            log_callback=logs.append)

    path, d = deck(0)
    jr, tr = runners(d)
    jr.run_file(path)
    tr.run_file(path)
    assert_rows_close(jr.thermo_rows, tr.thermo_rows, 1e-10)
    logs = []
    r = runner(d, logs)
    r.run_file(path)
    assert r.pair_path.startswith("reference PyTorch pair path") and \
        r.pair_path.endswith("(+ bonded terms)")
    assert r.sim._excl_rows_static is None and r.sim.excl_tags is not None
    monkeypatch.setattr(script_mod, "select_pair_kernel", functools.partial(
        script_mod.select_pair_kernel, force=True))
    for nsteps in (0, 20):
        path, d = deck(nsteps)
        jr = runners(d)[0]
        jr.run_file(path)
        logs = []
        k = runner(d, logs)
        k.run_file(path)
        assert k.sim.pair_compute is entry and k.sim._excl_route == "rows"
        assert k.pair_path.endswith("(+ bonded terms, excl_delta "
                                    "subtracted)")
        monkeypatch.undo()
        ref = runner(d, [])
        ref.run_file(path)
        monkeypatch.setattr(script_mod, "select_pair_kernel",
                            functools.partial(
                                script_mod.select_pair_kernel, force=True))
        assert ref.sim._excl_rows_static is None
        assert len(k.thermo_rows) == len(jr.thermo_rows) == len(
            ref.thermo_rows) == (3 if nsteps else 1)
        for other in (jr.thermo_rows, ref.thermo_rows):
            for a, b in zip(other, k.thermo_rows):
                for key in ("temp", "pe", "ke", "press"):
                    np.testing.assert_allclose(b[key], a[key], rtol=1e-6,
                                               err_msg=key)
                assert (b["oob_low"], b["oob_high"]) == (a["oob_low"],
                                                         a["oob_high"])


def test_exclusions_without_excl_delta_refused(tmp_path, monkeypatch):
    """table_ucg_bethe_density with special exclusions: the reference path
    on the CPU, and the kernel path (K5 → K3 → K6, forced onto the twins)
    with the density ``excl_delta``, which used to be refused
    (:func:`exclusion_deck_checks`); without exclusions the forced kernel
    path takes the same deck."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd

    exclusion_deck_checks(tmp_path, monkeypatch, tmd.write_bethe_density_deck,
                          hd.compute_style_density)
    path = tmd.add_bonds(tmd.write_bethe_density_deck(
        str(tmp_path / "plain"), n=512, nsteps=0), nbonds=16)
    text = open(path).read().replace("lj 0 0 0", "lj 1 1 1")
    logs = []
    r = ScriptRunner(workdir=str(tmp_path / "plain"), dtype=torch.float32,
                     device="cpu", log_callback=logs.append)
    r.run_string(text)
    assert any("K5 -> K3 -> K6" in m for m in logs)
    assert r.sim.excl_tags is None and r.sim._excl_rows_static is None


def test_rleucg_deck_with_exclusions(tmp_path, monkeypatch):
    """table_rleucg_interface with special exclusions
    (:func:`exclusion_deck_checks`): K5 → K4 → K6 with the density
    ``excl_delta``."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    exclusion_deck_checks(tmp_path, monkeypatch, tmd.write_rleucg_deck,
                          hr.compute_style_rleucg)


TILT = (0.1, -0.05, 0.08)     # in units of the box length


def tilted_deck(tmp_path, n=256, nsteps=20):
    """The UCG-LD deck under NVE (no thermostat, no ucgstate) in a box
    tilted by TILT × L."""
    deck = tmd.write_ucgld_deck(str(tmp_path), n=n, nsteps=nsteps,
                                thermo_every=10, tablength=800,
                                thermostat=False, tilt=TILT)
    return _drop(open(deck).read(), "fix 3")


def test_tilted_deck_matches_jax(tmp_path):
    """A tilted data file: both runners switch to the nsq list; the step-0
    row at 1e-10 and the 20-step NVE trajectory at 1e-9; write_restart and
    read_restart keep the tilt and the nsq list."""
    text = tilted_deck(tmp_path)
    logs = []
    jr, tr = runners(tmp_path, logs)
    jr.run_string(text)
    tr.run_string(text)
    assert tr.neighbor_method == "nsq" and tr.state.box.is_triclinic
    assert tr.sim.nbr_spec.method == "nsq"
    assert any("on a nsq list" in m for m in logs)
    assert_rows_close(jr.thermo_rows[:1], tr.thermo_rows[:1], 1e-10)
    assert_rows_close(jr.thermo_rows, tr.thermo_rows, 1e-9)
    assert_state_close(jr.state, tr.state)
    np.testing.assert_array_equal(_np(tr.state.box.tilt),
                                  np.asarray(jr.state.box.tilt))
    # the port's restart, read by both runners, continues 10 NVE steps
    tr.command("write_restart t.npz")
    cont = [("read_restart t.npz" if s.startswith("read_data") else s)
            for s in lines_of(text) if not s.startswith(("velocity", "run"))]
    jc, tc = runners(tmp_path)
    jc.run_string("\n".join(cont) + "\nrun 10\n")
    tc.run_string("\n".join(cont) + "\nrun 10\n")
    assert tc.neighbor_method == jc.neighbor_method == "nsq"
    assert torch.equal(tc.sim.state.box.tilt, tr.state.box.tilt)
    np.testing.assert_array_equal(np.asarray(jc.state.box.tilt),
                                  _np(tr.state.box.tilt))
    assert_rows_close(jc.thermo_rows, tc.thermo_rows, 1e-9)
    assert_state_close(jc.state, tc.state)
    assert tc.state.step == 30


def test_config4_deck_events_converge(tmp_path):
    """Config 4's deck at 4,096 beads through two events (steps 20 and
    40): every event converges under the runner's ``max_sweeps`` n + 1;
    the second needs more than the 64 sweeps that capped it before."""
    from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation

    deck = tmd.write_bethe_density_deck(str(tmp_path), n=4096, nsteps=60,
                                        thermo_every=20)
    event, info = Simulation._cswitch_event, []

    def counted(self, *a):
        out = event(self, *a)
        info.append((int(out[2]["sweeps"]), bool(out[2]["converged"])))
        return out

    r = ScriptRunner(workdir=str(tmp_path), dtype=torch.float32,
                     device="cpu", log_callback=lambda m: None)
    try:
        Simulation._cswitch_event = counted
        r.run_file(deck)
    finally:
        Simulation._cswitch_event = event
    assert r.sim.cswitch[0].max_sweeps == 4097
    assert len(info) == 2 and all(ok for _, ok in info)
    assert max(sw for sw, _ in info) > 64, info
    assert r.state.step == 60 and all(
        np.isfinite(row["etotal"]) for row in r.thermo_rows)
