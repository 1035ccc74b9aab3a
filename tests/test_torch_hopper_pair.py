"""K1's plain PyTorch twin (``ops/hopper_pair.ucgld_pair_reference``, what
the wrapper runs on CPU tensors) vs the JAX package, at n=512 in float32.

* full variant vs the Pallas kernel itself (``pallas_pair.compute`` in
  interpret mode): f within 2e-5·max|f|, ucgforce and scores within 2e-5,
  pe and virial within 2e-5 relative (both f32, sums in another order);
* fast and score-free variants vs the twin's full variant, at the
  tolerances of tests/test_pallas_pair.py;
* a multi-type system vs the JAX XLA reference path in float64, within the
  Chebyshev fit error (3e-5·max|f|, as tests/test_pallas_pair.py; 2e-5 on
  ucgforce and 5e-5 on scores, the fit error summed over the neighbours).

The CUDA kernel itself is held against this twin on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.ops import chebtab as jcheb
from lammps_ucg_dev_tpu.ops import colpack as jcp
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.ops import pallas_pair as jpk
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from test_torch_core import one_torch_thread  # noqa: F401

N, L = 512, 10.5


def system(rng, kind="two_state", dtype=jnp.float32):
    build = helpers.build_two_state if kind == "two_state" \
        else helpers.build_mixed
    _, bank, tp, rc = build(dtype=dtype)
    x = helpers.random_fluid(rng, N, L, min_sep=0.8)
    typ = (np.ones(N, np.int32) if kind == "two_state"
           else rng.integers(1, 3, N))
    js = JSimState.create(
        x=x, typ=typ, ucgl=rng.uniform(0.2, 0.8, N),
        ucgstate=rng.integers(0, 2, N),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=dtype), dtype=dtype)
    jp = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8, dtype))
    return js, jp, rc


def port(js, jp, rc, cheb=None):
    """The same system in the port (f32), with its own column list."""
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    if cheb is not None:
        tp = type(tp)(bank=tp.bank, tp=tp.tp, kT=tp.kT,
                      cheb=convert.cheb_from_numpy(convert.as_numpy_dict(cheb), device="cpu"))
    spec = tcp.measure_spec(ts.x.numpy(), [L] * 3, rc, 0.4)
    cl = tcp.build(ts.x, ts.box, spec)
    assert not bool(cl.overflow)
    return ts, tp, cl


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def flagship_like():
    """The two-state system in both packages (f32), with the fit."""
    js, jp, rc = system(np.random.default_rng(12345))
    cheb = jcheb.fit_bank(jp.bank)
    return (js, jp, rc, cheb) + port(js, jp, rc, cheb)


def test_twin_full_matches_pallas_kernel_interpret(flagship_like):
    js, jp, rc, cheb, ts, tp, cl = flagship_like
    assert float(jnp.max(cheb.max_rel_err)) < 1e-4
    jcl = jcp.build(js.x, js.box,
                    jcp.measure_spec(np.asarray(js.x), [L] * 3, rc, 0.4))
    jout = jpk.compute(js, jcl, jp, cheb, interpret=True)
    tout = hp.compute(ts, cl, tp, tp.cheb)

    scale = float(np.abs(_np(jout.f)).max())
    np.testing.assert_allclose(_np(tout.f), _np(jout.f), rtol=0,
                               atol=2e-5 * scale)
    for name in ("ucgforce", "scores"):
        np.testing.assert_allclose(_np(getattr(tout, name)),
                                   _np(getattr(jout, name)), rtol=0,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=2e-5)
    vscale = float(np.abs(_np(jout.virial)).max())
    np.testing.assert_allclose(_np(tout.virial), _np(jout.virial), rtol=0,
                               atol=2e-5 * vscale)
    assert int(tout.oob_low) == int(jout.oob_low) == 0


def test_twin_fast_variants_match_full(flagship_like):
    ts, tp, cl = flagship_like[4:]
    full = hp.compute(ts, cl, tp, tp.cheb)
    fast = hp.compute_style.fast_variant(ts, cl, tp)
    nos = hp.compute_style.fast_variant_noscores(ts, cl, tp)
    scale = float(full.f.abs().max())
    for out in (fast, nos):
        np.testing.assert_allclose(_np(out.f), _np(full.f), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(_np(out.ucgforce), _np(full.ucgforce),
                                   rtol=0, atol=1e-5)
        assert float(out.pe) == 0.0 and float(out.virial.abs().max()) == 0.0
    np.testing.assert_allclose(_np(fast.scores), _np(full.scores), rtol=0,
                               atol=1e-5)
    assert float(nos.scores.abs().max()) == 0.0


def as_f32(ts):
    """A float64 port state cast to float32."""
    f = {k: getattr(ts, k).float()
         for k in ("x", "v", "q", "ucgl", "ucgvl", "ucgml", "ucgp")}
    box = type(ts.box)(lo=ts.box.lo.float(), hi=ts.box.hi.float())
    return dataclasses.replace(ts, box=box, **f)


def test_twin_multitype_matches_xla_reference(rng):
    js, jp, rc = system(rng, "mixed", jnp.float64)
    jspec = jnb.make_spec(N, [L] * 3, rc, 0.4, method="nsq")
    jout = jax.jit(lambda s, p: jpu.compute(
        s, jnb.build_nsq(s.x, s.box, jspec), p))(js, jp)
    ts = as_f32(convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu"))
    assert set(ts.typ.tolist()) == {1, 2}
    _, bank32, tp32, _ = helpers.build_mixed(dtype=jnp.float32)
    tp = convert.params_from_numpy(convert.as_numpy_dict(
        jpu.UCGLDParams(bank=bank32, tp=tp32, kT=jnp.asarray(0.8,
                                                             jnp.float32))), device="cpu")
    sel = select_pair_kernel(tp, ts, rc, 0.4, force=True)
    assert sel is not None and sel[0] is hp.compute_style
    _, spec, tp = sel
    assert tp.tp.ntypes == 2 and tp.bank.n_tables == 7
    tout = hp.compute(ts, tcp.build(ts.x, ts.box, spec), tp, tp.cheb)
    scale = float(np.abs(_np(jout.f)).max())
    np.testing.assert_allclose(_np(tout.f), _np(jout.f), rtol=0,
                               atol=3e-5 * scale)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=3e-5)
    # λ-forces and scores sum the per-pair fit error (max relative 1e-6 on
    # e ≤ 2) over ~40 neighbours; scores also carry 1/kT = 1.25
    np.testing.assert_allclose(_np(tout.ucgforce), _np(jout.ucgforce),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(tout.scores), _np(jout.scores), rtol=0,
                               atol=5e-5)


def test_twin_float64_agrees_with_reference_path(rng):
    """The twin computes in its inputs' dtype: in f64 it is bounded only by
    the Chebyshev fit error against the table interpolant."""
    from lammps_ucg_dev_tpu_torch.models import pair_ucgld as tpu
    from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb

    f64 = torch.float64
    js, jp, rc = system(rng, dtype=jnp.float64)
    ts, tp, cl = port(js, jp, rc, jcheb.fit_bank(jp.bank, dtype=jnp.float64))
    ipack, cols = tcp.pack(cl, ts.box, ts.x, ts.ucgl, ts.ucgstate, dtype=f64)
    coef = hp.kernel_rows(tp.cheb, tp.tp, True, True, f64)
    scal = hp.kernel_scalars(ts.box, tp, tp.cheb, f64)
    out, part = hp.ucgld_pair_reference(
        scal, cl.z0, cl.L, ipack, cols, coef, mx=cl.mx, my=cl.my,
        degree=tp.cheb.degree, observe=True, want_scores=True)
    assert out.dtype == f64
    ref = tpu.compute(ts, tnb.build_nsq(ts.x, ts.box,
                                        tnb.make_spec(N, [L] * 3, rc, 0.4)),
                      tp)
    f = out[cl.atom_slot][:, :3]
    scale = float(ref.f.abs().max())
    np.testing.assert_allclose(_np(f), _np(ref.f), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(0.5 * float(part[:, 0].sum()), float(ref.pe),
                               rtol=1e-6)


def test_wrapper_dispatch_and_launch_counts(flagship_like):
    ts, tp, cl = flagship_like[4:]
    before = dict(hp.ucgld_pair.launches)
    args, kw = hp.kernel_inputs(ts, cl, tp, tp.cheb, True, True)
    out, part = hp.ucgld_pair(*args, **kw)
    # CPU tensors run the twin: no kernel launch is counted
    assert hp.ucgld_pair.launches == before
    assert out.shape == (cl.n_slots, 8) and part.shape == (cl.n_slots, 8)
    # rows of invalid i-slots are zero
    assert float(out[args[3][:, 5] < 0.5].abs().max()) == 0.0
    meta = [a.to("meta") if a is not None else None for a in args]
    with pytest.raises(ValueError):
        hp.ucgld_pair(*meta, **kw)
    with pytest.raises(ValueError):
        hp.variant(observe=True, want_scores=False)


def test_kernel_selection_gates(rng, flagship_like):
    _, _, rc, _, ts, tp, _ = flagship_like
    assert hp.supports(tp)
    assert select_pair_kernel(tp, ts, rc, 0.4) is None           # no CUDA
    assert select_pair_kernel(tp, ts, rc, 0.4, force=False) is None
    fn, spec, p2 = select_pair_kernel(tp, ts, rc, 0.4, force=True)
    assert fn is hp.compute_style and p2.cheb is not None
    assert isinstance(spec, tcp.ColumnSpec)
    js64, jp64, _ = system(rng, dtype=jnp.float64)
    ts64, tp64, _ = port(js64, jp64, rc)
    assert select_pair_kernel(tp64, ts64, rc, 0.4, force=True) is None


def test_dform_rows_follow_the_jax_transform():
    """Single-type coefficient rows: [eA eB eC eD fA fB fC fD] with
    A = c00, B = c10 - c00, C = c01 - c00, D = (c11 - c01) - (c10 - c00),
    taken in float64 on the f32 fit and rounded once to f32."""
    _, bank, tp, _ = helpers.build_two_state(dtype=jnp.float32)
    cheb = jcheb.fit_bank(bank)
    tcheb = convert.cheb_from_numpy(convert.as_numpy_dict(cheb), device="cpu")
    ttp = convert.typeparams_from_numpy(convert.as_numpy_dict(tp), device="cpu")
    ce = np.asarray(cheb.coeffs, np.float64)
    i00, i01, i10, i11 = np.asarray(tp.tab4)[1, 1].reshape(-1)
    T = ce.shape[0] // 2
    want = []
    for base in (0, T):
        A = ce[base + i00]
        want += [A, ce[base + i10] - A, ce[base + i01] - A,
                 (ce[base + i11] - ce[base + i01])
                 - (ce[base + i10] - ce[base + i00])]
    coef = hp.kernel_rows(tcheb, ttp, True, True)
    assert coef.shape == (8, cheb.degree)
    np.testing.assert_array_equal(coef.numpy(),
                                  np.asarray(want, np.float32))
    nos = hp.kernel_rows(tcheb, ttp, False, False)
    np.testing.assert_array_equal(nos.numpy(),
                                  coef.numpy()[[1, 3, 4, 5, 6, 7]])


def assert_pair_rows_match_raw(cheb, ids, block):
    """The per-type-pair D-form rows ``block`` (T+1, T+1, 8, degree),
    evaluated by ``hp.series`` at 64 points of u in float64, equal the
    D-form assembled from the raw rows' series (a state pair with table id
    -1 contributes exactly 0), within 1e-12 of the largest raw channel; the
    rows of a pair with type 0 are exactly 0."""
    u = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64)
    ce = cheb.coeffs.double()
    T = ce.shape[0] // 2
    raw = hp.series(ce, u, cheb.degree)
    zero = torch.zeros_like(u)
    t1 = ids.shape[0]
    assert tuple(block.shape) == (t1, t1, 8, cheb.degree)
    for a in range(t1):
        for b in range(t1):
            got = hp.series(block[a, b].double(), u, cheb.degree)
            if a == 0 or b == 0:
                assert max(float(g.abs().max()) for g in got) == 0.0
                continue
            want = []
            for base in (0, T):
                c00, c01, c10, c11 = (raw[base + int(i)] if i >= 0 else zero
                                      for i in ids[a, b])
                want += [c00, c10 - c00, c01 - c00,
                         (c11 - c01) - (c10 - c00)]
            scale = max(float(r.abs().max()) for r in raw)
            for r, (g, w) in enumerate(zip(got, want)):
                err = float((g - w).abs().max())
                assert err <= 1e-12 * scale, (a, b, r, err, scale)


def mixed_rows():
    """chip_smoke.mixed_bethe's 2-type bank: (cheb, ids, block)."""
    import chip_smoke
    from lammps_ucg_dev_tpu_torch.ops import chebtab

    bank, tp = chip_smoke.mixed_bank("cpu")
    cheb = chebtab.fit_bank(bank)
    ids = tp.tab4.reshape(tp.ntypes + 1, tp.ntypes + 1, 4).numpy()
    return cheb, ids, hp.kernel_rows(cheb, tp, True, True, torch.float64)


@pytest.mark.parametrize("case", ["mixed_bethe", "missing_tables"])
def test_pair_rows_match_raw_dform(case):
    cheb, ids, block = mixed_rows()
    if case == "missing_tables":
        # type pair (1, 2) without its 01/11 tables, (2, 1) with none
        ids = ids.copy()
        ids[1, 2, [1, 3]] = -1
        ids[2, 1] = -1
        block = torch.as_tensor(
            hp.dform_block(cheb.coeffs.double().numpy(), ids))
        assert float(block[2, 1].abs().max()) == 0.0
        eA, eB, eC, eD = block[1, 2, :4]
        assert torch.equal(eC, -eA) and torch.equal(eD, -eB)
    assert_pair_rows_match_raw(cheb, ids, block)
    with pytest.raises(ValueError):         # 4 actual types: no room
        hp.dform_block(cheb.coeffs.double().numpy(),
                       np.zeros((5, 5, 4), np.int64))
