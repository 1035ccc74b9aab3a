"""The ``cell`` neighbor method of the port (``ops/neighbor.py``) against
the JAX package's, in float64:

* ``build_cell`` gives the JAX package's list row for row (the same first K
  partners in the same stencil order), with and without the ``valid``
  (shadow cell), ``i_valid`` (empty rows) and ``excl`` (special partners)
  arguments, and the same overflow flag and occupancy;
* ``make_spec`` chooses the method and the capacities as the JAX package
  does (nsq at 512 beads, cell at 4,096);
* the reference pair path on a cell list gives the nsq list's result; only
  the summation order differs, so it is held at 1e-12 of each field's
  scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.core.state import Box
from lammps_ucg_dev_tpu_torch.models import pair_ucgld as tpu
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from test_torch_core import one_torch_thread  # noqa: F401

N, RHO, RC, SKIN = 1000, 0.6, 2.5, 0.4
L = (N / RHO) ** (1 / 3)


@pytest.fixture(scope="module")
def fluid():
    x = np.random.default_rng(7).uniform(0, L, (N, 3))
    jbox = JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64)
    tbox = Box.create([0, 0, 0], [L] * 3, dtype=torch.float64, device="cpu")
    return x, jbox, tbox


def both_lists(x, jbox, tbox, spec_kw, **masks):
    jspec = jnb.make_spec(N, [L] * 3, RC, SKIN, **spec_kw)
    tspec = tnb.make_spec(N, [L] * 3, RC, SKIN, **spec_kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    jm = {k: (None if v is None else jnp.asarray(v)) for k, v in masks.items()}
    tm = {k: (None if v is None else torch.as_tensor(v))
          for k, v in masks.items()}
    jl = jnb.build(jnp.asarray(x), jbox, jspec, **jm)
    tl = tnb.build(torch.as_tensor(x), tbox, tspec, **tm)
    return jl, tl


def assert_same_list(jl, tl):
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    assert int(tl.max_occupancy) == int(jl.max_occupancy)
    assert bool(tl.overflow) == bool(jl.overflow)
    assert tl.capacity == jl.capacity


MASKS = ["none", "valid", "i_valid", "excl", "all"]


@pytest.mark.parametrize("masks", MASKS)
def test_build_cell_matches_jax_row_for_row(fluid, masks):
    x, jbox, tbox = fluid
    rng = np.random.default_rng(MASKS.index(masks))
    kw = {"valid": None, "i_valid": None, "excl": None}
    if masks in ("valid", "all"):
        kw["valid"] = rng.uniform(size=N) > 0.1
    if masks in ("i_valid", "all"):
        kw["i_valid"] = rng.uniform(size=N) > 0.2
    if masks in ("excl", "all"):
        ex = rng.integers(0, N, (N, 3)).astype(np.int32)
        kw["excl"] = np.where(rng.uniform(size=(N, 3)) > 0.3, ex, N)
    jl, tl = both_lists(x, jbox, tbox, {"method": "cell", "chunk": 256},
                        **kw)
    assert not bool(tl.overflow)
    assert_same_list(jl, tl)


def test_build_cell_overflow_flag(fluid):
    x, jbox, tbox = fluid
    for spec_kw in ({"method": "cell", "capacity": 16},        # K exceeded
                    {"method": "cell", "cell_capacity": 12}):  # a cell full
        jl, tl = both_lists(x, jbox, tbox, spec_kw)
        assert bool(tl.overflow) and bool(jl.overflow)
        if "capacity" in spec_kw:
            assert_same_list(jl, tl)


def test_nsq_builder_takes_no_masks(fluid):
    x, _, tbox = fluid
    spec = tnb.make_spec(N, [L] * 3, RC, SKIN, method="nsq")
    with pytest.raises(ValueError):
        tnb.build(torch.as_tensor(x), tbox, spec,
                  valid=torch.ones(N, dtype=torch.bool))


@pytest.mark.parametrize("n,method", [(512, "nsq"), (4096, "cell")])
def test_make_spec_chooses_method_as_jax(n, method):
    Ln = (n / RHO) ** (1 / 3)
    tspec = tnb.make_spec(n, [Ln] * 3, RC, SKIN)
    jspec = jnb.make_spec(n, [Ln] * 3, RC, SKIN)
    assert tspec.method == jspec.method == method
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    k, cc = tnb.estimate_capacities(n, [Ln] * 3, RC, SKIN)
    assert (k, cc) == jnb.estimate_capacities(n, [Ln] * 3, RC, SKIN)
    with pytest.raises(ValueError):
        tnb.make_spec(n, [7.0] * 3, RC, SKIN, method="cell")


def test_reference_pair_path_cell_equals_nsq():
    rng = np.random.default_rng(12345)
    _, bank, tp, rc = helpers.build_two_state(dtype=jnp.float64)
    x = rng.uniform(0, L, (N, 3))
    js = JSimState.create(
        x=x, typ=np.ones(N, np.int32), ucgl=rng.uniform(0.2, 0.8, N),
        ucgstate=rng.integers(0, 2, N),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64),
        dtype=jnp.float64)
    jp = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp_ = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    spec = tnb.make_spec(N, [L] * 3, rc, SKIN)
    assert spec.method == "cell"
    cell = tpu.compute(ts, tnb.build(ts.x, ts.box, spec), tp_)
    nsq = tpu.compute(ts, tnb.build_nsq(ts.x, ts.box, spec), tp_)
    for name in ("f", "ucgforce", "scores", "virial"):
        a, b = getattr(cell, name), getattr(nsq, name)
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * scale, err_msg=name)
    np.testing.assert_allclose(float(cell.pe), float(nsq.pe), rtol=1e-12)
    assert int(cell.oob_low) == int(nsq.oob_low)
