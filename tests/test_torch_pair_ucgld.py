"""PyTorch port vs the JAX package: the reference pair path
(``models/pair_ucgld.compute`` on an nsq neighbor list) at n=512 in float64,
held at 1e-10 — the level the JAX package's own oracle tests use."""

import jax
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
from lammps_ucg_dev_tpu_torch.models import pair_ucgld as tpu
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from test_torch_core import one_torch_thread  # noqa: F401

N, L = 512, 10.5


@pytest.fixture(scope="module")
def two_state():
    return systems(np.random.default_rng(12345), "two_state")


@pytest.fixture(scope="module")
def mixed():
    return systems(np.random.default_rng(12345), "mixed")


def systems(rng, kind):
    build = helpers.build_two_state if kind == "two_state" \
        else helpers.build_mixed
    _, bank, tp, rc = build(dtype=jnp.float64)
    x = helpers.random_fluid(rng, N, L, min_sep=0.8)
    typ = (np.ones(N, np.int32) if kind == "two_state"
           else rng.integers(1, 3, N))
    js = JSimState.create(
        x=x, typ=typ, ucgl=rng.uniform(0.2, 0.8, N),
        ucgstate=rng.integers(0, 2, N),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64),
        dtype=jnp.float64)
    jp = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp_ = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    jspec = jnb.make_spec(N, [L] * 3, rc, 0.4, method="nsq")
    tspec = tnb.make_spec(N, [L] * 3, rc, 0.4)
    assert tspec.capacity == jspec.capacity
    return js, jp, jspec, ts, tp_, tspec


def test_nsq_list_matches_jax(two_state):
    js, _, jspec, ts, _, tspec = two_state
    jl = jax.jit(lambda x, box: jnb.build_nsq(x, box, jspec))(js.x, js.box)
    tl = tnb.build_nsq(ts.x, ts.box, tspec)
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    assert int(tl.max_occupancy) == int(jl.max_occupancy)
    assert bool(tl.overflow) == bool(jl.overflow)


def test_nsq_chunked_rows_and_overflow(two_state):
    _, _, _, ts, _, tspec = two_state
    whole = tnb.build_nsq(ts.x, ts.box, tspec)
    chunked = tnb.build_nsq(ts.x, ts.box, tnb.NeighborSpec(
        cutoff=tspec.cutoff, skin=tspec.skin, capacity=tspec.capacity,
        chunk=100))
    assert torch.equal(whole.idx, chunked.idx)
    tiny = tnb.build_nsq(ts.x, ts.box, tnb.NeighborSpec(
        cutoff=tspec.cutoff, skin=tspec.skin, capacity=8))
    assert bool(tiny.overflow) and tiny.idx.shape == (N, 8)
    with pytest.raises(ValueError):          # fewer than 3 cells a side
        tnb.make_spec(N, [7.0] * 3, 2.5, 0.4, method="cell")


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("kind", ["two_state", "mixed"])
def test_reference_pair_path_matches_jax(request, kind, chunk):
    js, jp, jspec, ts, tp_, tspec = request.getfixturevalue(kind)
    jout = jax.jit(lambda s, p: jpu.compute(
        s, jnb.build_nsq(s.x, s.box, jspec), p))(js, jp)
    tp_ = type(tp_)(bank=tp_.bank, tp=tp_.tp, kT=tp_.kT, chunk=chunk)
    tout = tpu.compute(ts, tnb.build_nsq(ts.x, ts.box, tspec), tp_)
    for name in ("f", "ucgforce", "scores", "virial"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=1e-10)
    assert int(tout.oob_low) == int(jout.oob_low)
    assert int(tout.oob_high) == int(jout.oob_high)
