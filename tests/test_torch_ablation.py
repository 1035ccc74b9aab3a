"""K7's plain twins (``ops/hopper_ablation.ablation_reference``, what the
wrapper runs on CPU tensors) against the JAX package's ablation kernel
``_abl_kernel`` of ``tools/kbench.py``, run in interpret mode on the JAX
window geometry, on the flagship fluid at 4,096 beads in float32.

The two packages lay the slots out differently (the JAX windows, the port's
column spans), so the outputs are compared per atom, each through its own
``atom_slot``.  Levels 1–4 are sums over pairs (self is excluded by
rsq > 0 in both), so they agree whatever the geometry; level 0 times the
walk itself and differs by design.  Tolerance: every column within 2e-5 of
its largest magnitude — both sides compute the same f32 arithmetic on the
same positions and differ in summation order.  Level 4 is K1's no-scores
variant: it equals K1's twin on the same inputs bit for bit, and that twin
is held against the JAX package's K1 in interpret mode by
tests/test_torch_hopper_pair.py, so level 4 is not interpreted again here
(it would be the costliest of the four).

``UCG_KERNEL_SPAN=0`` (the window layout kbench reads) is set only around
the JAX ``measure_spec``."""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _build_sim
from lammps_ucg_dev_tpu.ops import chebtab as jcheb
from lammps_ucg_dev_tpu.ops import colpack as jcp
from lammps_ucg_dev_tpu.ops import pallas_pair as jpk
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from test_torch_core import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N = 4096
TOL = 2e-5


@pytest.fixture(scope="module")
def kbench():
    """``tools/kbench.py``, loaded by path (it prepends the repo root to
    ``sys.path``; that is undone)."""
    spec = importlib.util.spec_from_file_location(
        "kbench_tool", ROOT / "tools" / "kbench.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side():
    """kbench's staged inputs on the JAX window geometry:
    (ColumnList, scal, meta, ipack, pages, cheb, tp)."""
    sim = _build_sim(n=N)
    js, jp = sim.state, sim.pair_params
    cheb = jcheb.fit_bank(jp.bank)
    L = float(js.box.lengths[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UCG_KERNEL_SPAN", "0")
        spec = jcp.measure_spec(np.asarray(js.x), [L] * 3, 2.5, 0.4)
    cl = jcp.build(js.x, js.box, spec)
    assert cl.NV == 0 and not bool(cl.overflow)
    tp = jp.tp
    lam = jnp.where(tp.n_states[js.typ] > 1, js.ucgl, 0.0)
    ipack, pages = jcp.pack(cl, js.box, js.x, lam, js.ucgstate)
    f32 = jnp.float32
    uscale, uoff = jpk._u_map(cheb, f32)
    scal = jnp.stack([js.box.lengths[0], js.box.lengths[1],
                      tp.cutsq[1, 1].astype(f32),
                      jp.bank.innersq[0].astype(f32), uscale, uoff,
                      jnp.zeros((), f32), jnp.zeros((), f32)])[None, :]
    meta = jnp.pad(cl.meta, ((0, -cl.meta.shape[0] % 8), (0, 0)))
    return sim, cl, scal, meta, ipack, pages, cheb, tp


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The same system carried into the port, on its own column list:
    (K7 args, K7 kwargs, ColumnList)."""
    sim, _, _, _, _, _, cheb, _ = jax_side
    ts = convert.state_from_numpy(convert.as_numpy_dict(sim.state),
                                  device="cpu")
    params = convert.params_from_numpy(convert.as_numpy_dict(sim.pair_params),
                                       device="cpu")
    tcheb = convert.cheb_from_numpy(convert.as_numpy_dict(cheb), device="cpu")
    L = float(ts.box.lengths[0])
    cl = tcp.build(ts.x, ts.box,
                   tcp.measure_spec(ts.x.numpy(), [L] * 3, 2.5, 0.4))
    assert not bool(cl.overflow)
    args, kw = ha.kernel_inputs(ts, cl, params, tcheb)
    return args, kw, cl, ts, params, tcheb


def kbench_rows(cheb, tp) -> list:
    """kbench's six rows [eB eD fA fB fC fD] (tools/kbench.py:209-223)."""
    ce = np.asarray(cheb.coeffs, np.float64)
    i00, i01, i10, i11 = jpk._type_classes(tp, 4)[0][2]
    T = ce.shape[0] // 2

    def abcd(base):
        A = ce[base + i00]
        return (A, ce[base + i10] - A, ce[base + i01] - A,
                (ce[base + i11] - ce[base + i01])
                - (ce[base + i10] - ce[base + i00]))

    _, eB, _, eD = abcd(0)
    fA, fB, fC, fD = abcd(T)
    return [[float(c) for c in r] for r in (eB, eD, fA, fB, fC, fD)]


def run_abl_kernel(kbench, jax_side, level: int) -> np.ndarray:
    """``_abl_kernel`` at ``level`` in interpret mode (kbench's ``_call``
    with ``interpret=True``), per atom."""
    _, cl, scal, meta, ipack, pages, cheb, tp = jax_side
    kern = functools.partial(kbench._abl_kernel, kbench_rows(cheb, tp),
                             cheb.degree, cl.G, level)
    (out,) = pl.pallas_call(
        kern, grid=(cl.n_prog,),
        in_specs=[
            pl.BlockSpec((1, 8), lambda p: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((8, 32), lambda p: (p // 8, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((cl.gs, 8), lambda p: (p, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=[pl.BlockSpec((cl.gs, 8), lambda p: (p, 0),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((cl.n_slots, 8), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((jcp.NSTEN, 8, jcp.W), jnp.float32),
                        pltpu.SemaphoreType.DMA((jcp.NSTEN,))],
        interpret=True,
    )(scal, meta, ipack, pages)
    return np.asarray(out)[np.asarray(cl.atom_slot)]


def test_rows_are_kbench_rows(jax_side, port_side):
    cheb, tp = jax_side[6], jax_side[7]
    coef = port_side[0][5]
    np.testing.assert_array_equal(
        coef.numpy(), np.asarray(kbench_rows(cheb, tp), np.float32))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_twin_matches_kbench_kernel_interpret(kbench, jax_side, port_side,
                                              level):
    args, kw, cl = port_side[:3]
    before = dict(ha.ucgld_ablation.launches)
    out = ha.ucgld_ablation(*args, **kw, level=level)
    assert ha.ucgld_ablation.launches == before      # CPU tensors: the twin
    got = out[cl.atom_slot].numpy()
    ref = run_abl_kernel(kbench, jax_side, level)
    cols = 1
    assert np.isfinite(got).all() and np.isfinite(ref[:, :cols]).all()
    for c in range(cols):
        scale = float(np.abs(ref[:, c]).max())
        assert scale > 0
        np.testing.assert_allclose(got[:, c], ref[:, c], rtol=0,
                                   atol=TOL * scale, err_msg=f"column {c}")
    assert not got[:, cols:].any()


def test_level4_is_k1_noscores(port_side):
    args, kw, _, ts, params, cheb = port_side
    l4 = ha.ablation_reference(*args, **kw, level=4)
    k1_args, k1_kw = hp.kernel_inputs(ts, port_side[2], params, cheb,
                                      False, False)
    k1, _ = hp.ucgld_pair_reference(*k1_args, **k1_kw)
    assert torch.equal(l4, k1)
    l0 = ha.ablation_reference(*args, **kw, level=0)
    assert bool(torch.isfinite(l0).all()) and not l0[:, 1:].any()
    with pytest.raises(ValueError):
        ha.ucgld_ablation(*args, **kw, level=5)
