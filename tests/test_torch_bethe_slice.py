"""The whole Bethe slice: the config-3 self-consistent Bethe fluid
(``flagship.build_bethe_sim``) at n=512 with Langevin off — ``fix
nve/ucgld``, ``table_ucg_bethe`` (bethe, pseudo yes, prior
chemical_potential) and ``fix ucgstate`` in its default mode, 2 blocks x 5
steps — against a JAX ``Simulation`` built from the same numpy arrays on its
float64 XLA pair path.

* the port's reference pair path in float64: x, v, ucgl, ucgp and ucgstate
  at 1e-9, thermo rows to 1e-9 relative;
* the port's column path through K2's twin in float32 (the kernel path's
  dtype): x and v within 5e-5, ucgl and ucgp within 1e-5, ucgstate exact,
  thermo within 1e-5 relative.  Each force carries the Chebyshev fit error
  (< 1e-4 relative by the selection gate; this bank fits to ~1e-6) and f32
  rounding, and the posterior carries the same through the scores; over
  10 steps of dt 0.002 that stays well inside these bounds.  ucgstate =
  round(ucgp) is discontinuous at 0.5, so the test also asserts that no
  ucgp of the f32 run came within the ucgp tolerance of 0.5 — where one
  did, the two paths could round an atom differently and part ways."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu.io.table_io import RawTable as JRawTable
from lammps_ucg_dev_tpu.models import pair_bethe as jpb
from lammps_ucg_dev_tpu.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu.runtime.sim import Simulation as JSimulation
from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from test_torch_core import one_torch_thread  # noqa: F401

N, NSTEPS, EVERY = 512, 10, 5
FIELDS = ("x", "v", "ucgl", "ucgp", "ucgstate")
P_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_run():
    a = flagship.bethe_arrays(N)
    L = a["L"]
    dt = jnp.float64
    st = parse_state_settings(flagship.TWO_STATE_SETTINGS, "bethe")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 2, 2, [
        (JRawTable(**dataclasses.asdict(flagship.soft_table(e, 2000))),
         flagship.RC) for e in flagship.EPS])
    bank, tp = b.build(dtype=dt)
    state = JSimState.create(
        x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
        ucgstate=a["ucgstate"], ucgml=a["ucgml"],
        box=JBox.create([0, 0, 0], [L] * 3, dtype=dt), dtype=dt)
    params = jpb.make_params(bank, tp, 0.8, method="bethe", pseudo=True,
                             prior_mode="chemical_potential", dtype=dt)
    spec = jnb.make_spec(N, [L] * 3, flagship.RC, 0.4, method="nsq")
    cfg = JSimConfig(dt=0.002, units="lj",
                     integrator=jfi.IntegratorCfg("nve/ucgld"),
                     ucgstate=jfs.UCGStateCfg(mode="default"),
                     reneigh_every=EVERY)
    sim = JSimulation(JSystem(n_atoms=N, ntypes=1,
                              masses=np.array([0.0, 1.0])),
                      state, jpb.compute, params, spec, cfg)
    sim.run(NSTEPS, thermo_every=EVERY)
    return ({f: np.asarray(sim.property_atom(f)) for f in FIELDS},
            sim.thermo_rows)


def port_run(dtype, kernel, loop):
    sim = flagship.build_bethe_sim(n=N, dtype=dtype, kernel=kernel,
                                   device="cpu", reneigh_every=EVERY)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    if loop == "run":
        sim.run(NSTEPS, thermo_every=EVERY)
        rows = sim.thermo_rows
    else:
        sim.run_fused(1, run_window=(0, NSTEPS))
        rows = [sim.thermo()]
        sim.run_fused(1, run_window=(0, NSTEPS))
        rows.append(sim.thermo())
    return sim, {f: sim.property_atom(f) for f in FIELDS}, rows


def check_rows(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ("temp", "pe", "ke", "etotal", "press"):
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, err_msg=k)
        assert r["oob_low"] == q["oob_low"] == 0


@pytest.mark.parametrize("loop", ["run", "run_fused"])
def test_bethe_slice_reference_path_float64(jax_run, loop):
    ref, ref_rows = jax_run
    sim, got, rows = port_run(torch.float64, False, loop)
    assert sim.pair_compute.__module__.endswith("models.pair_bethe")
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-9,
                                   err_msg=f)
    check_rows(rows, ref_rows, 1e-9)


def test_bethe_slice_kernel_path_twin_float32(jax_run, monkeypatch):
    ref, ref_rows = jax_run
    margins, post_force = [], tfs.post_force

    def recording(*args, **kw):
        out = post_force(*args, **kw)
        margins.append(float((out.ucgp - 0.5).abs().min()))
        return out

    monkeypatch.setattr(tfs, "post_force", recording)
    before = dict(hb.bethe_pair.launches)
    sim, got, rows = port_run(torch.float32, True, "run")
    assert sim.pair_compute is hb.compute_style_bethe
    assert isinstance(sim.nbr_spec, tcp.ColumnSpec)
    assert hb.bethe_pair.launches == before        # CPU tensors: the twin
    assert len(margins) == NSTEPS + 1 and min(margins) > P_TOL
    for f, tol in (("x", 5e-5), ("v", 5e-5), ("ucgl", P_TOL),
                   ("ucgp", P_TOL), ("ucgstate", 0)):
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol,
                                   err_msg=f)
    check_rows(rows, ref_rows, 1e-5)
    assert sim.dangerous_builds == 0


def test_bethe_simulation_runs_ucgstate_mc():
    """``fix ucgstate mc`` in the run loop: the uniforms come from the
    Simulation's generator (tag-indexed); ucgl follows ucgp."""
    sim = flagship.build_bethe_sim(n=N, dtype=torch.float64, kernel=False,
                                   device="cpu")
    sim.cfg = dataclasses.replace(
        sim.cfg, ucgstate=tfs.UCGStateCfg(mode="mc", mc_rate=0.5))
    s0 = sim.state.ucgstate.clone()
    sim.run(5)
    np.testing.assert_array_equal(sim.state.ucgl.numpy(),
                                  sim.state.ucgp.numpy())
    assert bool((sim.state.ucgstate != s0).any())
