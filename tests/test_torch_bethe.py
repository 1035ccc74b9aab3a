"""``pair_style table_ucg_bethe`` in the port against the JAX package, at
n=512 (384 for the clamp case), with inputs from numpy seeds.  No
interpret-mode Pallas call: the JAX side is its XLA pair path.

* the reference path ``models/pair_bethe.compute`` against the JAX
  ``pair_bethe.compute`` in float64, bethe/mf × pseudo/SCE on a one-type and
  a mixed (plain + UCG) system: 1e-10 of each field's scale;
* ``bethe_pij`` and ``bethe_log_ratio`` elementwise (1e-12);
* the three prior modes, with the JAX package's noise draws injected;
* K2's plain twin (``ops/hopper_bethe.bethe_pair_reference``, what the
  wrapper runs on CPU tensors) in float32 against the JAX XLA path in
  float32, at the JAX package's own kernel-vs-XLA tolerances
  (tests/test_pallas_pair.py): f 5e-5·max|f|, pe 3e-5 relative, scores
  3e-5 (1e-4 for SCE), virial 3e-5 relative + 1e-2 absolute; and at the f32
  clamp boundary of -J/kT = 40 against float64 (f 5e-5·max|f|, pe 5e-5,
  scores 2e-3, as there);
* the fast variant against the full one, the selection gates, and
  ``fix ucgstate mc`` against JAX's ``post_force`` with JAX's uniforms
  injected, in both compat settings (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.models import pair_bethe as jpb
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu_torch import convert, flagship
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs
from lammps_ucg_dev_tpu_torch.models import pair_bethe as tpb
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import cuda_lib
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from test_torch_core import one_torch_thread  # noqa: F401

N = 512
KT = 0.8
METHODS = [(m, p) for m in ("bethe", "mf") for p in (True, False)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def system(kind, dtype, method="bethe", pseudo=True, seed=7):
    """A Bethe system in both packages: the config-3 lattice positions of
    ``flagship.bethe_arrays``, random assigned priors (ucgl != ucgp) and
    states; ``mixed`` = plain type 1 + 2-state type 2."""
    rng = np.random.default_rng(seed)
    a = flagship.bethe_arrays(N, seed)
    L = a["L"]
    build = helpers.build_two_state if kind == "two_state" \
        else helpers.build_mixed
    _, bank, tp, rc = build(dtype=dtype)
    typ = (np.ones(N, np.int32) if kind == "two_state"
           else rng.integers(1, 3, N).astype(np.int32))
    js = JSimState.create(
        x=a["x"], typ=typ, ucgl=rng.uniform(0.05, 0.95, N),
        ucgp=rng.uniform(0.05, 0.95, N), ucgstate=rng.integers(0, 2, N),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=dtype), dtype=dtype)
    jp = jpb.make_params(bank, tp, KT, method=method, pseudo=pseudo,
                         dtype=dtype)
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp_ = convert.bethe_params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    return js, jp, ts, tp_, rc, L


@pytest.fixture
def one_thread():
    """One torch thread for the float64 comparisons.  Torch splits an
    elementwise kernel across threads in chunks whose ends take its scalar
    path, and exp/expm1 differ in the last bit between its vector and
    scalar paths; near the cutoff J -> 0, where such a bit can move a pair
    across the closed form's |expm1(-J/kT)| < 1e-6 switch and its force by
    ~1e-10 of the scale.  With one thread the result is repeatable (and
    agrees with the JAX package to ~2e-15)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nsq_lists(js, ts, rc, L):
    jspec = jnb.make_spec(N, [L] * 3, rc, 0.4, method="nsq")
    tspec = tnb.make_spec(N, [L] * 3, rc, 0.4)
    return (jnb.build_nsq(js.x, js.box, jspec),
            tnb.build_nsq(ts.x, ts.box, tspec))


def assert_fout(t, j, f_tol, pe_tol, s_tol, v_rtol=None, v_atol=None):
    jf = _np(j.f)
    scale = float(np.abs(jf).max())
    np.testing.assert_allclose(_np(t.f), jf, rtol=0, atol=f_tol * scale)
    np.testing.assert_allclose(float(t.pe), float(j.pe), rtol=pe_tol)
    np.testing.assert_allclose(_np(t.scores), _np(j.scores), rtol=0,
                               atol=s_tol)
    if v_rtol is not None:
        np.testing.assert_allclose(_np(t.virial), _np(j.virial), rtol=v_rtol,
                                   atol=v_atol)


@pytest.mark.parametrize("kind", ["two_state", "mixed"])
@pytest.mark.parametrize("method,pseudo", METHODS)
def test_reference_path_matches_jax_float64(one_thread, kind, method,
                                            pseudo):
    js, jp, ts, tp, rc, L = system(kind, jnp.float64, method, pseudo)
    jnbr, tnbr = nsq_lists(js, ts, rc, L)
    jout = jpb.compute(js, jnbr, jp)
    tout = tpb.compute(ts, tnbr, tp)
    s_scale = float(np.abs(_np(jout.scores)).max())
    v_scale = float(np.abs(_np(jout.virial)).max())
    assert_fout(tout, jout, 1e-10, 1e-10, 1e-10 * s_scale, 0,
                1e-10 * v_scale)
    assert float(tout.ucgforce.abs().max()) == 0.0
    assert int(tout.oob_low) == int(jout.oob_low) == 0


def test_bethe_pij_and_log_ratio_elementwise(rng):
    m = 4000
    u4 = rng.normal(0, 1.5, (m, 2, 2))
    u4[:200, 1, 1] -= 800.0                   # past the -700 kT guard
    u4[200:400] = 0.3                         # J = 0: the |a| < eps branch
    pi1 = rng.uniform(0.0, 1.0, m)
    pj1 = rng.uniform(0.0, 1.0, m)
    pj1[:50] = 0.0                            # plain partner
    J = u4[:, 1, 1] + u4[:, 0, 0] - u4[:, 0, 1] - u4[:, 1, 0]
    for method in ("bethe", "mf"):
        jp4 = jpb.bethe_pij(jnp.asarray(u4), jnp.asarray(pi1),
                            jnp.asarray(pj1), KT, method)
        tp4 = tpb.bethe_pij(torch.as_tensor(u4), torch.as_tensor(pi1),
                            torch.as_tensor(pj1), KT, method)
        np.testing.assert_allclose(_np(tp4), _np(jp4), rtol=0, atol=1e-12)
        jlr = jpb.bethe_log_ratio(jnp.asarray(J), jnp.asarray(pi1),
                                  jnp.asarray(pj1), KT, method)
        tlr = tpb.bethe_log_ratio(torch.as_tensor(J), torch.as_tensor(pi1),
                                  torch.as_tensor(pj1), KT, method)
        np.testing.assert_allclose(_np(tlr), _np(jlr), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", tpb.PRIOR_MODES)
def test_prior_modes_match_jax(one_thread, mode):
    """Half the atoms at the ucgp = -1 sentinel; the noise mode gets the JAX
    package's own draws (fold_in(key, 0x5EED)) as its input."""
    js, jp, ts, tp, rc, L = system("mixed", jnp.float64)
    sentinel = np.arange(N) % 2 == 0
    ucgp = np.where(sentinel, -1.0, np.asarray(js.ucgp))
    js = dataclasses.replace(js, ucgp=jnp.asarray(ucgp))
    ts = dataclasses.replace(ts, ucgp=torch.as_tensor(ucgp))
    jp = dataclasses.replace(jp, prior_mode=mode,
                             noise_level=jnp.asarray(0.2))
    tp = dataclasses.replace(tp, prior_mode=mode,
                             noise_level=torch.tensor(0.2, dtype=torch.float64))
    u = None
    if mode == "chemical_potential_noise":
        u = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(js.key, 0x5EED), (N,), dtype=jnp.float64)))
        with pytest.raises(ValueError):
            tpb._priors(ts, tp)
    for jv, tv in zip(jpb._priors(js, jp), tpb._priors(ts, tp, u)):
        np.testing.assert_allclose(_np(tv), _np(jv), rtol=0, atol=1e-15)
    jnbr, tnbr = nsq_lists(js, ts, rc, L)
    s_scale = float(np.abs(_np(jpb.compute(js, jnbr, jp).scores)).max())
    assert_fout(tpb.compute(ts, tnbr, tp, u), jpb.compute(js, jnbr, jp),
                1e-10, 1e-10, 1e-10 * s_scale)


def twin_path(ts, tp, rc):
    sel = select_pair_kernel(tp, ts, rc, 0.4, force=True)
    assert sel is not None and sel[0] is hb.compute_style_bethe
    _, spec, tp = sel
    return tp, tcp.build(ts.x, ts.box, spec)


@pytest.mark.parametrize("kind", ["two_state", "mixed"])
@pytest.mark.parametrize("method,pseudo", METHODS)
def test_k2_twin_matches_jax_xla_float32(kind, method, pseudo):
    js, jp, ts, tp, rc, L = system(kind, jnp.float32, method, pseudo)
    jnbr, _ = nsq_lists(js, ts, rc, L)
    jout = jpb.compute(js, jnbr, jp)
    tp, cl = twin_path(ts, tp, rc)
    before = dict(hb.bethe_pair.launches)
    tout = hb.compute_bethe(ts, cl, tp, tp.cheb)
    assert hb.bethe_pair.launches == before        # CPU tensors: the twin
    assert_fout(tout, jout, 5e-5, 3e-5, 3e-5 if pseudo else 1e-4, 3e-5,
                1e-2)
    assert int(tout.oob_low) == 0


def test_k2_twin_at_f32_clamp_boundary():
    """The f32 clamp of -J/kT at 40 (the reference clamps at -700 in f64):
    a deep-J system whose pair distances put -J/kT on both sides of 40,
    K2's twin in f32 against the JAX XLA path in f64."""
    eps = (0.5, 0.2, 0.2, -20.0)
    rng = np.random.default_rng(12345)
    n, L = 384, 9.0
    x = helpers.random_fluid(rng, n, L, min_sep=0.55)
    arrays = dict(x=x, typ=np.ones(n, np.int32), ucgl=rng.uniform(0.2, 0.8, n),
                  ucgp=rng.uniform(0.1, 0.9, n), ucgstate=rng.integers(0, 2, n))
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d ** 2).sum(-1) + np.eye(n) * 1e9)
    mjkt = 19.9 * (1.0 + np.cos(np.pi * np.minimum(r, 2.5) / 2.5)) / KT
    assert np.any((r < 2.5) & (mjkt > 41.0)), "no pair past the clamp"
    assert np.any((r < 2.5) & (mjkt > 35.0) & (mjkt < 40.0))

    def jax_side(dtype):
        _, bank, tp, rc = helpers.build_two_state(eps=eps, dtype=dtype)
        js = JSimState.create(box=JBox.create([0, 0, 0], [L] * 3,
                                              dtype=dtype),
                              dtype=dtype, **arrays)
        return js, jpb.make_params(bank, tp, KT, dtype=dtype), rc

    js64, jp64, rc = jax_side(jnp.float64)
    js32, jp32, _ = jax_side(jnp.float32)
    spec = jnb.make_spec(n, [L] * 3, rc, 0.4, method="nsq")
    jout = jpb.compute(js64, jnb.build_nsq(js64.x, js64.box, spec), jp64)
    ts = convert.state_from_numpy(convert.as_numpy_dict(js32), device="cpu")
    tp = convert.bethe_params_from_numpy(convert.as_numpy_dict(jp32), device="cpu")
    tp, cl = twin_path(ts, tp, rc)
    tout = hb.compute_bethe(ts, cl, tp, tp.cheb)
    assert bool(torch.isfinite(tout.f).all())
    assert_fout(tout, jout, 5e-5, 5e-5, 2e-3)


def test_k2_fast_variant_matches_full():
    _, _, ts, tp, rc, _ = system("mixed", jnp.float32, "bethe", False)
    tp, cl = twin_path(ts, tp, rc)
    full = hb.compute_style_bethe(ts, cl, tp)
    fast = hb.compute_style_bethe.fast_variant(ts, cl, tp)
    scale = float(full.f.abs().max())
    np.testing.assert_allclose(_np(fast.f), _np(full.f), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(_np(fast.scores), _np(full.scores), rtol=0,
                               atol=1e-5)
    assert float(fast.pe) == 0.0 and float(fast.virial.abs().max()) == 0.0
    assert not hasattr(hb.compute_style_bethe, "fast_variant_noscores")


def test_k2_wrapper_and_selection_gates():
    js, jp, ts, tp, rc, L = system("two_state", jnp.float32)
    assert hb.supports_bethe(tp)
    assert not hb.supports_bethe(convert.params_from_numpy(
        convert.as_numpy_dict(jpu.UCGLDParams(bank=jp.bank, tp=jp.tp,
                                              kT=jp.kT)), device="cpu"))
    assert hb.ucg_mask(tp.tp) == 0b10
    assert select_pair_kernel(tp, ts, rc, 0.4) is None          # no CUDA
    assert select_pair_kernel(tp, ts, rc, 0.4, force=False) is None
    _, _, ts64, tp64, _, _ = system("two_state", jnp.float64)
    assert select_pair_kernel(tp64, ts64, rc, 0.4, force=True) is None
    tp, cl = twin_path(ts, tp, rc)
    args, kw = hb.kernel_inputs(ts, cl, tp, tp.cheb, True)
    assert args[5].shape[0] == 8                                # D-form rows
    assert float(args[0][6]) == pytest.approx(KT)
    out, part = hb.bethe_pair(*args, **kw)
    assert out.shape == part.shape == (cl.n_slots, 8)
    assert float(out[:, 3].abs().max()) == 0.0                  # no λ-force
    assert float(out[args[3][:, 5] < 0.5].abs().max()) == 0.0
    meta = [a.to("meta") if a is not None else None for a in args]
    with pytest.raises(ValueError):
        hb.bethe_pair(*meta, **kw)


@pytest.mark.parametrize("compat", [False, True])
def test_ucgstate_mc_matches_jax(rng, compat):
    n = 400
    js = JSimState.create(
        x=rng.uniform(0, 5, (n, 3)), typ=rng.integers(1, 3, n),
        ucgl=rng.uniform(0, 1, n), ucgstate=rng.integers(0, 2, n),
        ucgp=rng.uniform(0, 1, n), tag=rng.permutation(n) + 1,
        box=JBox.create([0, 0, 0], [5.0] * 3, dtype=jnp.float64),
        dtype=jnp.float64)
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    scores = rng.normal(0, 2.0, (n, 2))
    is_ucg = rng.integers(0, 2, n).astype(bool)
    key = jax.random.PRNGKey(3)
    jcfg = jfs.UCGStateCfg(mode="mc", mc_rate=0.5, seed=9,
                           compat_reference_mc=compat)
    u = np.array(jax.random.uniform(jax.random.fold_in(key, jcfg.seed),
                                      (n,), dtype=jnp.float64))
    jout = jfs.post_force(key, js, jnp.asarray(scores), jnp.asarray(is_ucg),
                          jcfg)
    tout = tfs.post_force(ts, torch.as_tensor(scores),
                          torch.as_tensor(is_ucg),
                          tfs.UCGStateCfg(mode="mc", mc_rate=0.5,
                                          compat_reference_mc=compat),
                          torch.as_tensor(u))
    for name in ("ucgp", "ucgl"):
        np.testing.assert_allclose(_np(getattr(tout, name)),
                                   _np(getattr(jout, name)), rtol=0,
                                   atol=1e-15)
    np.testing.assert_array_equal(_np(tout.ucgstate), _np(jout.ucgstate))
    flipped = _np(tout.ucgstate) != _np(ts.ucgstate)
    assert 0 < flipped.sum() < n


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    k1 = cuda_lib.build_key("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    k2 = cuda_lib.build_key("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert len({k1, k2, cuda_lib.build_key("k")}) == 3


def test_builders_default_to_cuda():
    """No ``device`` argument builds on the card, and raises without one."""
    for build in (flagship.build_sim, flagship.build_bethe_sim):
        if torch.cuda.is_available():
            assert build(n=4096).state.x.is_cuda
        else:
            with pytest.raises(RuntimeError):
                build(n=512)
