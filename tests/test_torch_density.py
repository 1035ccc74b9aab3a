"""The density-CV styles in the port against the JAX package, at n=512 (40
for the gradient check), with inputs from numpy seeds.  No interpret-mode
Pallas call: the JAX side is its XLA pair path.

* the reference paths ``models/pair_bethe_density.compute`` (P3, both
  ``backforce_derivative`` and both ``pair_cv`` modes, with and without
  entropy) and ``models/pair_rleucg.compute`` (P4, feedback always/never ×
  ``conservative_sign``) against the JAX ``compute`` in float64 under one
  torch thread: 1e-10 of each field's scale;
* ``density.*`` elementwise (1e-13: the two libraries' tanh differ in
  the last bits),
  ``substate_probs`` on a 3-state type, the builders' density fields,
  ``tabSS`` and ``cutsq`` (exact);
* P4's F = −∇E by ``torch.autograd`` of ``potential_energy``, at the JAX
  package's own tolerance (atol 2e-3, rtol 1e-3);
* the twins of K3–K6, through ``compute_density`` and ``compute_rleucg`` on
  CPU tensors in float32, against the JAX XLA paths in float32 at the JAX
  package's kernel-vs-XLA gates (tests/test_pallas_pair.py:317-327,
  :384-392): f 1e-4·max|f|, pe 3e-5 relative, scores and ucgp 5e-5,
  virial rtol 1e-4 + atol 1e-2, oob exact; the fast variants against the
  full ones (2e-5·max|f|) and ``ucgp is None`` on the score-free one;
* the selection gates and the convert functions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.io.state_settings import parse_state_settings as jparse
from lammps_ucg_dev_tpu.io.table_io import RawTable as JRawTable
from lammps_ucg_dev_tpu.models import density as jden
from lammps_ucg_dev_tpu.models import pair_bethe_density as jpd
from lammps_ucg_dev_tpu.models import pair_rleucg as jpr
from lammps_ucg_dev_tpu.models.typemap import RLEUCGBuilder as JRLEUCGBuilder
from lammps_ucg_dev_tpu.models.typemap import (
    TablePairBuilder as JTablePairBuilder)
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu_torch import convert, flagship
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.models import density as tden
from lammps_ucg_dev_tpu_torch.models import pair_bethe_density as tpd
from lammps_ucg_dev_tpu_torch.models import pair_rleucg as tpr
from lammps_ucg_dev_tpu_torch.models.typemap import RLEUCGBuilder
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from test_torch_core import one_torch_thread  # noqa: F401

N = 512
KT = 0.8
RC = flagship.RC
P3_NOENT = flagship.DENSITY_SETTINGS.replace("density entropy",
                                             "density no_entropy")
P4_PAIRS = ((1, 1, 1.0), (1, 2, 0.7), (1, 3, 0.8), (2, 2, 0.4), (2, 3, 0.5),
            (3, 3, 0.9))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jtab(e):
    return JRawTable(**dataclasses.asdict(flagship.soft_table(e, 2000)))


def jax_p3_bank(settings, dtype):
    st = jparse(settings, "bethe_density")
    b = JTablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 1, 1, [(_jtab(1.0), RC)])
    b.pair_coeff(1, 2, 1, 2, [(_jtab(e), RC) for e in (0.8, 0.5)])
    b.pair_coeff(2, 2, 2, 2, [(_jtab(e), RC) for e in (0.9, 0.55, 0.55, 0.3)])
    return b.build(dtype=dtype)


def jax_p4_builder():
    st = jparse(flagship.RLEUCG_SETTINGS, "rleucg")
    b = JRLEUCGBuilder("linear", 1200, st)
    for i, j, e in P4_PAIRS:
        b.pair_coeff(i, j, _jtab(e), RC)
    return st, b


def system(style, dtype, settings=flagship.DENSITY_SETTINGS, seed=7, **kw):
    """The config-4 (``p3``) or config-5 (``p4``) positions and types of
    ``flagship`` in both packages, with random discrete states and λ."""
    rng = np.random.default_rng(seed)
    if style == "p3":
        a = flagship.density_arrays(N)
        bank, tp = jax_p3_bank(settings, dtype)
        jp = jpd.make_params(bank, tp, KT, dtype=dtype, **kw)
        tp_ = convert.bethe_density_params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    else:
        a = flagship.rleucg_arrays(N)
        st, b = jax_p4_builder()
        jp = jpr.make_params(b, st, KT, dtype=dtype, **kw)
        tp_ = convert.rleucg_params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    L = a["L"]
    js = JSimState.create(
        x=a["x"], typ=a["typ"], ucgl=rng.uniform(0.2, 0.8, N),
        ucgstate=rng.integers(0, 2, N),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=dtype), dtype=dtype)
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    return js, jp, ts, tp_, L


@pytest.fixture
def one_thread():
    """One torch thread for the float64 comparisons (see
    tests/test_torch_bethe.py: the Bethe closed form switches branch at
    |expm1(-J/kT)| < 1e-6, and torch's threaded elementwise kernels may move
    a pair across it by one bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_out(js, jp, L, n=N):
    spec = jnb.make_spec(n, [L] * 3, RC, 0.4, method="nsq")
    mod = jpd if isinstance(jp, jpd.BetheDensityParams) else jpr
    return mod.compute(js, jnb.build_nsq(js.x, js.box, spec), jp)


def port_ref_out(ts, tp, L, n=N):
    nbr = tnb.build_nsq(ts.x, ts.box, tnb.make_spec(n, [L] * 3, RC, 0.4))
    mod = tpd if isinstance(tp, tpd.BetheDensityParams) else tpr
    return mod.compute(ts, nbr, tp)


def assert_fout(t, j, f_tol, pe_tol, s_tol, v_rtol, v_atol, p_tol=None):
    jf = _np(j.f)
    np.testing.assert_allclose(_np(t.f), jf, rtol=0,
                               atol=f_tol * float(np.abs(jf).max()))
    np.testing.assert_allclose(float(t.pe), float(j.pe), rtol=pe_tol)
    np.testing.assert_allclose(_np(t.scores), _np(j.scores), rtol=0,
                               atol=s_tol)
    np.testing.assert_allclose(_np(t.virial), _np(j.virial), rtol=v_rtol,
                               atol=v_atol)
    assert int(t.oob_low) == int(j.oob_low) == 0
    if p_tol is not None:
        np.testing.assert_allclose(_np(t.ucgp), _np(j.ucgp), rtol=0,
                                   atol=p_tol)


@pytest.mark.parametrize("settings", [flagship.DENSITY_SETTINGS, P3_NOENT],
                         ids=["entropy", "no_entropy"])
@pytest.mark.parametrize("pair_cv", tpd.PAIR_CV_MODES)
@pytest.mark.parametrize("bfd", [True, False])
def test_p3_reference_path_matches_jax_float64(one_thread, settings, pair_cv,
                                               bfd):
    js, jp, ts, tp, L = system("p3", jnp.float64, settings,
                               backforce_derivative=bfd, pair_cv=pair_cv)
    j, t = jax_out(js, jp, L), port_ref_out(ts, tp, L)
    s_scale = float(np.abs(_np(j.scores)).max())
    v_scale = float(np.abs(_np(j.virial)).max())
    assert_fout(t, j, 1e-10, 1e-10, 1e-10 * s_scale, 0, 1e-10 * v_scale,
                1e-12)
    assert float(t.ucgforce.abs().max()) == 0.0


@pytest.mark.parametrize("feedback", tpr.FEEDBACK_MODES)
@pytest.mark.parametrize("sign", [True, False])
def test_p4_reference_path_matches_jax_float64(one_thread, feedback, sign):
    js, jp, ts, tp, L = system("p4", jnp.float64, feedback=feedback,
                               conservative_sign=sign)
    j, t = jax_out(js, jp, L), port_ref_out(ts, tp, L)
    v_scale = float(np.abs(_np(j.virial)).max())
    assert_fout(t, j, 1e-10, 1e-10, 0, 0, 1e-10 * v_scale)
    assert t.ucgp is None


def test_density_functions_elementwise(rng):
    r = rng.uniform(0.0, 3.0, 5000)
    R = rng.uniform(0.5, 2.0, 5000)
    for jf, tf in ((jden.proximity, tden.proximity),
                   (jden.proximity_der, tden.proximity_der)):
        np.testing.assert_allclose(
            _np(tf(torch.as_tensor(r), torch.as_tensor(R))),
            np.asarray(jf(jnp.asarray(r), jnp.asarray(R))), rtol=1e-13,
            atol=1e-13)
    rho = rng.uniform(0.0, 12.0, 5000)
    for jv, tv in zip(jden.threshold_prob_and_partial(jnp.asarray(rho), 6.0),
                      tden.threshold_prob_and_partial(torch.as_tensor(rho),
                                                      6.0)):
        np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-13,
                                   atol=1e-13)
    # a plain type's floored radius: w = 0 and |w'| = 0 exactly
    w = tden.proximity(torch.tensor([0.3, 2.4], dtype=torch.float32), 1e-12)
    d = tden.proximity_der(torch.tensor([0.3, 2.4], dtype=torch.float32),
                           1e-12)
    assert float(w.abs().max()) == 0.0 and float(d.abs().max()) == 0.0


def test_substate_probs_three_state():
    """A 3-state actual type (tests/test_pair_density_styles.py:127): the
    explicit p0 from the threshold, the middle state 0, the last implicit."""
    text = "1 3\n3 density no_entropy\n4.0 1.2\n0.1 0.2\n"
    jst = jparse(text, "rleucg")
    jb = JRLEUCGBuilder("linear", 500, jst)
    jb.pair_coeff("*", "*", helpers.make_soft_table(0.5, RC, n=600), RC)
    jp = jpr.make_params(jb, jst, KT, dtype=jnp.float64)
    st = parse_state_settings(text, "rleucg")
    b = RLEUCGBuilder("linear", 500, st)
    b.pair_coeff("*", "*", flagship.soft_table(0.5, 600), RC)
    tp = tpr.make_params(b, st, KT, dtype=torch.float64, device="cpu")
    assert tp.max_states == 3
    typ = np.array([1, 1, 2, 3], np.int32)
    rho = np.array([4.0, 8.0, 3.0, 5.0])
    jv = jpr.substate_probs(jp, jnp.asarray(typ), jnp.asarray(rho))
    tv = tpr.substate_probs(tp, torch.as_tensor(typ), torch.as_tensor(rho))
    for a, b_ in zip(tv, jv):
        np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=0, atol=1e-15)
    probs = _np(tv[0])
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-12)
    np.testing.assert_allclose(probs[:2, 0],
                               0.5 + 0.5 * np.tanh((rho[:2] - 4.0) / 0.4),
                               atol=1e-12)
    assert np.all(probs[:, 1] == 0.0)


def test_builders_match_jax():
    """The port's builders give the JAX package's density fields, tabSS,
    cutsq and tables from the same settings and raw tables."""
    jbank, jtp = jax_p3_bank(flagship.DENSITY_SETTINGS, jnp.float64)
    sim = flagship.build_density_sim(n=N, dtype=torch.float64, kernel=False,
                                     device="cpu")
    tp = sim.pair_params.tp
    for name in ("n_states", "formal", "tab4", "cutsq", "mu", "use_density",
                 "use_entropy", "cv_threshold", "threshold_radius"):
        np.testing.assert_array_equal(_np(getattr(tp, name)),
                                      np.asarray(getattr(jtp, name)), name)
    np.testing.assert_array_equal(_np(sim.pair_params.bank.e),
                                  np.asarray(jbank.e))
    st, jb = jax_p4_builder()
    jbank, jtabSS, jcutsq = jb.build(dtype=jnp.float64)
    rp = flagship.build_rleucg_sim(n=N, dtype=torch.float64, kernel=False,
                                   device="cpu").pair_params
    np.testing.assert_array_equal(_np(rp.tabSS), np.asarray(jtabSS))
    np.testing.assert_array_equal(_np(rp.cutsq), np.asarray(jcutsq))
    np.testing.assert_array_equal(_np(rp.bank.e), np.asarray(jbank.e))
    jp = jpr.make_params(jb, st, KT, dtype=jnp.float64)
    for name in ("n_states", "actual_from_state", "use_entropy", "mu",
                 "cv_threshold", "threshold_radius"):
        np.testing.assert_array_equal(_np(getattr(rp, name)),
                                      np.asarray(getattr(jp, name)), name)


@pytest.mark.parametrize("feedback", tpr.FEEDBACK_MODES)
def test_p4_force_is_minus_grad(rng, feedback):
    """F = −∇E of the explicit mean-field functional by torch.autograd
    (tests/test_pair_density_styles.py:85-109); momentum conserved."""
    st = parse_state_settings(flagship.RLEUCG_SETTINGS, "rleucg")
    b = RLEUCGBuilder("linear", 3000, st)
    for i, j, e in P4_PAIRS:
        b.pair_coeff(i, j, flagship.soft_table(e, 3000), RC)
    params = tpr.make_params(b, st, KT, feedback=feedback,
                             dtype=torch.float64, device="cpu")
    n, L = 40, 7.0
    typ = np.where(rng.uniform(size=n) < 0.7, 1, 3).astype(np.int32)
    x = helpers.random_fluid(rng, n, L)
    from lammps_ucg_dev_tpu_torch.core.state import Box, SimState
    state = SimState.create(x=x, typ=typ, ucgstate=rng.integers(0, 2, n),
                            ucgl=rng.uniform(0.2, 0.8, n),
                            box=Box.create([0, 0, 0], [L] * 3,
                                           dtype=torch.float64),
                            dtype=torch.float64)
    nbr = tnb.build_nsq(state.x, state.box,
                        tnb.make_spec(n, [L] * 3, RC, 0.3))
    out = tpr.compute(state, nbr, params)
    assert int(out.oob_low) == 0 and int(out.oob_high) == 0
    if feedback == "always":
        xg = state.x.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            tpr.potential_energy(xg, state, nbr, params), xg)
        np.testing.assert_allclose(_np(out.f), -_np(grad), atol=2e-3,
                                   rtol=1e-3)
    np.testing.assert_allclose(_np(out.f.sum(0)), np.zeros(3), atol=1e-10)


def twin_path(ts, tp):
    sel = select_pair_kernel(tp, ts, RC, 0.4, force=True)
    assert sel is not None
    fn, spec, tp = sel
    return fn, tp, tcp.build(ts.x, ts.box, spec)


def launches():
    return [dict(f.launches) for f in (hcv.cv_rho, hcv.cv_force,
                                       hd.dbethe_pair, hr.rleucg_pair)]


@pytest.mark.parametrize("kw", [{}, {"backforce_derivative": False},
                                {"method": "mf"}],
                         ids=["default", "w_backforce", "mf"])
def test_k3_path_twins_match_jax_xla_float32(kw):
    js, jp, ts, tp, L = system("p3", jnp.float32, **kw)
    j = jax_out(js, jp, L)
    fn, tp, cl = twin_path(ts, tp)
    assert fn is hd.compute_style_density
    before = launches()
    t = hd.compute_density(ts, cl, tp, tp.cheb)
    assert launches() == before                   # CPU tensors: the twins
    assert_fout(t, j, 1e-4, 3e-5, 5e-5, 1e-4, 1e-2, 5e-5)


@pytest.mark.parametrize("feedback,sign", [("always", True),
                                           ("always", False),
                                           ("never", True)])
def test_k4_path_twins_match_jax_xla_float32(feedback, sign):
    js, jp, ts, tp, L = system("p4", jnp.float32, feedback=feedback,
                               conservative_sign=sign)
    j = jax_out(js, jp, L)
    fn, tp, cl = twin_path(ts, tp)
    assert fn is hr.compute_style_rleucg
    before = launches()
    t = hr.compute_rleucg(ts, cl, tp, tp.cheb)
    assert launches() == before
    assert_fout(t, j, 1e-4, 3e-5, 0, 1e-4, 1e-2)


def test_density_fast_variants_match_full():
    _, _, ts, tp, _ = system("p3", jnp.float32)
    fn, tp, cl = twin_path(ts, tp)
    full = fn(ts, cl, tp)
    fast = fn.fast_variant(ts, cl, tp)
    nos = fn.fast_variant_noscores(ts, cl, tp)
    scale = float(full.f.abs().max())
    for o in (fast, nos):
        np.testing.assert_allclose(_np(o.f), _np(full.f), rtol=0,
                                   atol=2e-5 * scale)
        assert float(o.pe) == 0.0 and float(o.virial.abs().max()) == 0.0
    np.testing.assert_allclose(_np(fast.scores), _np(full.scores), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(fast.ucgp), _np(full.ucgp), rtol=0,
                               atol=1e-6)
    assert nos.ucgp is None and float(nos.scores.abs().max()) == 0.0
    _, _, ts, tp, _ = system("p4", jnp.float32)
    fn, tp, cl = twin_path(ts, tp)
    full, fast = fn(ts, cl, tp), fn.fast_variant(ts, cl, tp)
    np.testing.assert_allclose(_np(fast.f), _np(full.f), rtol=0,
                               atol=2e-5 * float(full.f.abs().max()))
    assert float(fast.pe) == 0.0
    assert not hasattr(fn, "fast_variant_noscores")


def test_k5_twin_plain_rows_are_zero():
    """Plain types carry the floored radius: their ρ is exactly 0, while
    their in-cutoff count is not; a UCG type's ρ is positive."""
    _, _, ts, tp, _ = system("p3", jnp.float32)
    _, tp, cl = twin_path(ts, tp)
    args, kw = hcv.cv_inputs(ts, cl, tp.cv_rad, tp.tp.cutsq[1, 1],
                             tp.bank.innersq[0], None)
    assert kw["pertype"] and args[-1].shape == (3,)
    at = hcv.cv_rho(*args, **kw)[cl.atom_slot]
    plain = ts.typ == 1
    assert float(at[plain, 0].abs().max()) == 0.0
    assert float(at[plain, 1].min()) > 0 and float(at[~plain, 0].min()) > 0
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        hcv.cv_rho(*meta, **kw)


def test_density_selection_gates():
    _, _, ts, tp, _ = system("p3", jnp.float32)
    assert hd.supports_density(tp)
    assert not hd.supports_density(dataclasses.replace(tp,
                                                       pair_cv="reference"))
    assert select_pair_kernel(tp, ts, RC, 0.4) is None          # no CUDA
    assert select_pair_kernel(tp, ts, RC, 0.4, force=False) is None
    assert select_pair_kernel(dataclasses.replace(tp, pair_cv="reference"),
                              ts, RC, 0.4, force=True) is None
    _, _, ts4, tp4, _ = system("p4", jnp.float32)
    assert hr.supports_rleucg(tp4) and not hr.supports_rleucg(tp)
    assert not hd.supports_density(tp4)
    assert not hr.supports_rleucg(dataclasses.replace(tp4, max_states=3))
    _, _, ts64, tp64, _ = system("p4", jnp.float64)
    assert select_pair_kernel(tp64, ts64, RC, 0.4, force=True) is None
    fn, tp4, cl = twin_path(ts4, tp4)
    coef = hr.kernel_rows(tp4.cheb, tp4)
    assert tuple(coef.shape) == (4, 4, 8, tp4.cheb.degree)
    # no substate type 0: its rows are zero; every real pair has a table
    assert float(coef[0].abs().max()) == float(coef[:, 0].abs().max()) == 0
    assert bool((coef[1:, 1:, 4].abs().amax(-1) > 0).all())


@pytest.mark.parametrize("style", ["p3", "p4"])
def test_convert_round_trip(style):
    js, jp, ts, tp, _ = system(style, jnp.float32)
    d = convert.as_numpy_dict(jp)
    back = convert.as_numpy_dict(tp)
    d.pop("cheb"), back.pop("cheb")
    assert back.pop("cv_rad") is None      # set by select_pair_kernel only

    def eq(a, b, path):
        # every field of the port's side; the JAX side has TPU-only extras
        # (TableBank.upacked, UCGTypeParams.pair_pack, ...).  A field the
        # port leaves None for this table style is absent, None or zero
        # filled on the JAX side (e2/f2 off SPLINE; BITMAP's rsq/drsq,
        # which JAX keeps only inside ``packed``)
        if isinstance(b, dict):
            for k in b:
                if b[k] is None and (a.get(k) is None
                                     or not np.any(np.asarray(a[k]))):
                    continue
                eq(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), path)

    eq(d, back, style)


def test_density_builders_default_to_cuda():
    for build in (flagship.build_density_sim, flagship.build_rleucg_sim):
        if torch.cuda.is_available():
            assert build(n=4096).state.x.is_cuda
        else:
            with pytest.raises(RuntimeError):
                build(n=512)


@pytest.mark.parametrize("style", ["p3", "p4"])
def test_density_pair_rows_match_raw_dform(style):
    """K3's and K4's per-type-pair D-form rows (P3's 2 actual types, P4's 3
    substate types) against the D-form of the raw rows, in float64."""
    from lammps_ucg_dev_tpu_torch.ops import chebtab
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from test_torch_hopper_pair import assert_pair_rows_match_raw

    build = (flagship.build_density_sim if style == "p3"
             else flagship.build_rleucg_sim)
    p = build(n=N, kernel=False, device="cpu").pair_params
    cheb = chebtab.fit_bank(p.bank)
    if style == "p3":
        t1 = p.tp.ntypes + 1
        ids = p.tp.tab4.reshape(t1, t1, 4).numpy()
        block = hp.kernel_rows(cheb, p.tp, True, True, torch.float64)
    else:
        t1 = p.tabSS.shape[0]
        ids = p.tabSS.reshape(t1, t1, 4).numpy()
        block = hr.kernel_rows(cheb, p, torch.float64)
    assert t1 == (3 if style == "p3" else 4)
    assert_pair_rows_match_raw(cheb, ids, block)
