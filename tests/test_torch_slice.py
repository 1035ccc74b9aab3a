"""The whole slice: the flagship UCG-LD fluid (``flagship.build_sim``, the
port of ``__graft_entry__._build_sim``) at n=512 under the drift protocol's
NVE (Langevin off), wall/hard + bias, ``ucgstate ld``, 2 blocks x 5 steps,
against the JAX ``Simulation`` on its XLA pair path in float64.

* the port's reference pair path in float64: x, v, ucgl, ucgvl and ucgp at
  1e-9, thermo rows to 1e-9 relative;
* the port's column path through K1's twin in float32 (the kernel path's
  dtype): 5e-5 absolute on the state and 1e-5 relative on thermo.  Each
  force carries the Chebyshev fit error (the selection gate holds its max
  relative error below 1e-4; this bank fits to ~1e-6) plus f32 rounding
  (~1e-7 relative); over 10 steps of dt 0.004 that moves v by at most
  ~10·dt·1e-4·max|f| ≈ 3e-5 and x by far less, and the thermo sums carry
  f32 rounding of ~1e-7 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_sim
from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from test_torch_core import one_torch_thread  # noqa: F401

N, NSTEPS, EVERY = 512, 10, 5
FIELDS = ("x", "v", "ucgl", "ucgvl", "ucgp")


@pytest.fixture(scope="module")
def jax_run():
    sim = _build_sim(n=N, dtype=jnp.float64, pallas=False)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    sim.run(NSTEPS, thermo_every=EVERY)
    return ({f: np.asarray(sim.property_atom(f)) for f in FIELDS},
            sim.thermo_rows)


def port_run(dtype, kernel, loop):
    sim = flagship.build_sim(n=N, dtype=dtype, kernel=kernel, device="cpu")
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    if loop == "run":
        sim.run(NSTEPS, thermo_every=EVERY)
        rows = sim.thermo_rows
    else:
        sim.run_fused(1)
        rows = [sim.thermo()]
        sim.run_fused(1, run_window=(0, NSTEPS))
        rows.append(sim.thermo())
    return sim, {f: sim.property_atom(f) for f in FIELDS}, rows


def check_rows(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ("temp", "pe", "ke", "ke_lambda", "lambda_temp", "etotal",
                  "press"):
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, err_msg=k)
        assert r["oob_low"] == q["oob_low"] == 0


@pytest.mark.parametrize("loop", ["run", "run_fused"])
def test_slice_reference_path_float64(jax_run, loop):
    ref, ref_rows = jax_run
    sim, got, rows = port_run(torch.float64, False, loop)
    assert sim.pair_compute.__module__.endswith("models.pair_ucgld")
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-9,
                                   err_msg=f)
    check_rows(rows, ref_rows, 1e-9)


def test_slice_kernel_path_twin_float32(jax_run):
    ref, ref_rows = jax_run
    before = dict(hp.ucgld_pair.launches)
    sim, got, rows = port_run(torch.float32, True, "run")
    assert sim.pair_compute is hp.compute_style
    assert isinstance(sim.nbr_spec, tcp.ColumnSpec)
    assert sim._slot_ok                            # slot-major interior
    assert hp.ucgld_pair.launches == before        # CPU tensors: the twin
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=5e-5,
                                   err_msg=f)
    check_rows(rows, ref_rows, 1e-5)
    assert sim.dangerous_builds == 0
