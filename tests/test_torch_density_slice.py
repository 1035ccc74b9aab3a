"""The whole density-CV slice: the config-4 system (``flagship.
build_density_sim``, P3: ``table_ucg_bethe_density``, ``fix nve/ucgld``)
and the config-5 system (``flagship.build_rleucg_sim``, P4:
``table_rleucg_interface``, ``fix nve/ucgld/wall/hard bias_potential
0.1``) at n=512 with Langevin off, 2 blocks x 10 steps, against JAX
``Simulation``s built from the same numpy arrays on their float64 XLA pair
paths.

* the port's reference pair paths in float64: x, v, ucgl and ucgp at 1e-9,
  thermo rows to 1e-9 relative;
* the port's column paths through the twins of K5, K3/K4 and K6 in float32
  (the kernel paths' dtype): x within 2e-5, v within 1e-4, ucgp within
  1e-5, thermo within 5e-6 relative.  f32 positions in a box of side ~10
  round by ~1e-6 each step; each force carries the Chebyshev fit error
  (< 1e-4 relative by the selection gate; these banks fit to ~1e-6) and f32
  rounding, the CV back-force that of ρ and of the prior-force tallies
  (their f32 envelope is intrinsic to P3: PARITY.md 3b).  Over 20 steps of
  dt 0.002 the errors measured on this system are 4x (x) to 70x (ucgp)
  below these bounds;
* ``thermo()`` on the P4 system, whose params carry no per-type UCG table
  (the driver treats every atom as UCG there, as the JAX package does);
* the P3 posterior leaves the -1 sentinel at setup and the driver carries
  it across the score-free interior steps of the column path.

The kernel paths run their interior steps slot-major."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.models import pair_bethe_density as jpd
from lammps_ucg_dev_tpu.models import pair_rleucg as jpr
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu.runtime.sim import Simulation as JSimulation
from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.fixes import integrate as tfi
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr
from test_torch_density import jax_p3_bank, jax_p4_builder
from test_torch_core import one_torch_thread  # noqa: F401

N, NSTEPS, EVERY = 512, 20, 10
FIELDS = ("x", "v", "ucgl", "ucgp")
F32_TOL = {"x": 2e-5, "v": 1e-4, "ucgl": 1e-9, "ucgp": 1e-5}
STYLES = {"p3": (flagship.build_density_sim, hd.compute_style_density),
          "p4": (flagship.build_rleucg_sim, hr.compute_style_rleucg)}


def jax_run(style):
    dt = jnp.float64
    if style == "p3":
        a = flagship.density_arrays(N)
        bank, tp = jax_p3_bank(flagship.DENSITY_SETTINGS, dt)
        params = jpd.make_params(bank, tp, 0.8, dtype=dt)
        compute, integ = jpd.compute, jfi.IntegratorCfg("nve/ucgld")
        masses = np.array([0.0, 1.0, 1.0])
    else:
        a = flagship.rleucg_arrays(N)
        st, b = jax_p4_builder()
        params = jpr.make_params(b, st, 0.8, dtype=dt)
        compute = jpr.compute
        integ = jfi.IntegratorCfg("nve/ucgld/wall/hard", bias_potential=True,
                                  barrier=0.1)
        masses = np.array([0.0, 1.0, 1.0, 1.0])
    L = a["L"]
    state = JSimState.create(
        x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
        ucgstate=a["ucgstate"], ucgml=a["ucgml"],
        box=JBox.create([0, 0, 0], [L] * 3, dtype=dt), dtype=dt)
    spec = jnb.make_spec(N, [L] * 3, flagship.RC, 0.4, method="nsq")
    cfg = JSimConfig(dt=0.002, units="lj", integrator=integ,
                     reneigh_every=EVERY)
    sim = JSimulation(JSystem(n_atoms=N, ntypes=len(masses) - 1,
                              masses=masses),
                      state, compute, params, spec, cfg)
    sim.run(NSTEPS, thermo_every=EVERY)
    return ({f: np.asarray(sim.property_atom(f)) for f in FIELDS},
            sim.thermo_rows)


@pytest.fixture(scope="module")
def jax_runs():
    return {s: jax_run(s) for s in STYLES}


def port_run(style, dtype, kernel):
    sim = STYLES[style][0](n=N, dtype=dtype, kernel=kernel, device="cpu")
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    sim.run(NSTEPS, thermo_every=EVERY)
    return sim, {f: sim.property_atom(f) for f in FIELDS}


def check_rows(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ("temp", "pe", "ke", "etotal", "press"):
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, err_msg=k)
        assert r["oob_low"] == q["oob_low"] == 0


@pytest.mark.parametrize("style", list(STYLES))
def test_density_slice_reference_path_float64(jax_runs, style):
    ref, ref_rows = jax_runs[style]
    sim, got = port_run(style, torch.float64, False)
    assert sim.pair_compute.__module__.endswith(
        "pair_bethe_density" if style == "p3" else "pair_rleucg")
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-9,
                                   err_msg=f)
    check_rows(sim.thermo_rows, ref_rows, 1e-9)


@pytest.mark.parametrize("style", list(STYLES))
def test_density_slice_kernel_path_twins_float32(jax_runs, style):
    ref, ref_rows = jax_runs[style]
    sim, got = port_run(style, torch.float32, True)
    assert sim.pair_compute is STYLES[style][1]
    assert isinstance(sim.nbr_spec, tcp.ColumnSpec)
    assert sim._slot_ok                            # slot-major interior
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=F32_TOL[f],
                                   err_msg=f)
    check_rows(sim.thermo_rows, ref_rows, 5e-6)
    assert sim.dangerous_builds == 0


def test_p4_thermo_has_the_bias_of_every_atom():
    """``thermo()`` on the P4 system: RLEUCGParams has no ``tp``, so the
    wall/hard bias energy covers every atom."""
    sim = flagship.build_rleucg_sim(n=N, dtype=torch.float64, kernel=False,
                                    device="cpu")
    sim.setup()
    row = sim.thermo()
    assert bool(sim._is_ucg(sim.state).all())
    lam = sim.state.ucgl
    bias = float(tfi.bias_energy(lam, 0.1).sum())
    assert bias > 0
    np.testing.assert_allclose(row["pe"], float(sim._fcarry.pe) + bias,
                               rtol=1e-12)


def test_p3_posterior_leaves_sentinel_and_is_carried():
    sim = flagship.build_density_sim(n=N, kernel=True, device="cpu")
    assert bool((sim.state.ucgp == -1.0).all())
    sim.setup((0, 2 * EVERY))
    typ = sim.state.typ
    p = sim.state.ucgp
    assert bool(((p[typ == 2] >= 1e-6) & (p[typ == 2] <= 1 - 1e-6)).all())
    assert bool((p[typ == 1] == 1.0).all())
    sim.run_fused(1, run_window=(0, 2 * EVERY))
    # the block's last (full) step set both; the interior steps, score-free,
    # carried the posterior instead of writing softmax(0) = 0.5
    assert torch.equal(sim.state.ucgp, sim._fcarry.ucgp)
    assert not bool((sim.state.ucgp[typ == 2] == 0.5).any())
