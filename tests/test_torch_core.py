"""PyTorch port vs the JAX package: the O(N) pieces of the flagship path —
box, integrators, λ fixes, tables, the Chebyshev fit and the type maps.
Inputs are drawn with numpy from a seed and handed to both packages; float64
parity is held at 1e-12 (both evaluate the same expressions; only
last-bit differences of elementwise math are allowed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core import units as junits
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.fixes import langevin as jfl
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.models import typemap as jtm
from lammps_ucg_dev_tpu.ops import chebtab as jcheb
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.core import units as tunits
from lammps_ucg_dev_tpu_torch.fixes import integrate as tfi
from lammps_ucg_dev_tpu_torch.fixes import langevin as tfl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.models import common as tcommon
from lammps_ucg_dev_tpu_torch.models import typemap as ttm
from lammps_ucg_dev_tpu_torch.ops import chebtab as tcheb

TOL = 1e-12
FIELDS = ("x", "v", "ucgl", "ucgvl", "ucgstate", "ucgp")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops on one thread for the whole module (the port's
    CPU test modules import this fixture).  The test run's workers share
    the CPU; an op split over one thread per core then waits on threads
    that other workers hold, and small-tensor ops slow down by an order of
    magnitude or more (four concurrent runs of test_torch_density_slice.py
    took 748 s with one thread per core and 26 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def states(rng, n=96, L=7.0):
    """The same random state in both packages (float64)."""
    js = JSimState.create(
        x=rng.uniform(-2.0, L + 2.0, (n, 3)), v=rng.normal(0, 1, (n, 3)),
        typ=rng.integers(1, 3, n), ucgl=rng.uniform(0, 1, n),
        ucgstate=rng.integers(0, 2, n), ucgvl=rng.normal(0, 8.0, n),
        ucgml=rng.uniform(1.0, 5.0, n), ucgp=rng.uniform(0, 1, n),
        box=JBox.create([0, 0, 0], [L, L, L], dtype=jnp.float64),
        dtype=jnp.float64)
    return js, convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")


def test_units_tables_equal():
    for name in ("lj", "real", "metal", "si", "cgs"):
        assert (dataclasses.asdict(tunits.get(name))
                == dataclasses.asdict(junits.get(name)))


def test_box_wrap_and_min_image(rng):
    js, ts = states(rng)
    jx, jimg = js.box.wrap(js.x, js.image)
    tx, timg = ts.box.wrap(ts.x, ts.image)
    close(tx, jx)
    np.testing.assert_array_equal(_np(timg), _np(jimg))
    dr = rng.uniform(-10, 10, (200, 3))
    close(ts.box.min_image(torch.as_tensor(dr)),
          js.box.min_image(jnp.asarray(dr)))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kind", ["nve/ucgld", "nve/ucgld/wall/hard"])
def test_integrators_match(rng, kind, grouped):
    js, ts = states(rng)
    n = js.n_atoms
    group = rng.integers(0, 2, n).astype(bool) if grouped else None
    jcfg = jfi.IntegratorCfg(kind, bias_potential=True, group=group)
    tcfg = tfi.IntegratorCfg(kind, bias_potential=True, group=group)
    f = rng.normal(0, 3, (n, 3))
    lf = rng.normal(0, 30, n)
    mass = rng.uniform(0.5, 2.0, n)
    dt = 0.004
    j1 = jfi.initial_integrate(js, jnp.asarray(f), jnp.asarray(lf),
                               jnp.asarray(mass), dt, 1.0, jcfg)
    t1 = tfi.initial_integrate(ts, torch.as_tensor(f), torch.as_tensor(lf),
                               torch.as_tensor(mass), dt, 1.0, tcfg)
    # a strong λ kick so the wall branch reflects at both walls
    j2 = jfi.final_integrate(j1, jnp.asarray(f), jnp.asarray(40 * lf),
                             jnp.asarray(mass), dt, 1.0, jcfg)
    t2 = tfi.final_integrate(t1, torch.as_tensor(f),
                             torch.as_tensor(40 * lf), torch.as_tensor(mass),
                             dt, 1.0, tcfg)
    for a, b in ((t1, j1), (t2, j2)):
        for name in FIELDS:
            close(getattr(a, name), getattr(b, name))


def test_bias_force_and_energy(rng):
    lam = rng.uniform(-0.2, 1.2, 500)
    close(tfi.bias_force(torch.as_tensor(lam), 0.1),
          jfi.bias_force(jnp.asarray(lam), 0.1))
    close(tfi.bias_energy(torch.as_tensor(lam), 0.1),
          jfi.bias_energy(jnp.asarray(lam), 0.1))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("mode", ["default", "ld"])
def test_ucgstate_modes_match(rng, mode, grouped):
    js, ts = states(rng)
    n = js.n_atoms
    group = rng.integers(0, 2, n).astype(bool) if grouped else None
    scores = rng.normal(0, 20, (n, 2))
    scores[:3] = [[800.0, -5.0], [-900.0, 1.0], [3.0, 750.0]]   # exp clamps
    is_ucg = rng.integers(0, 2, n).astype(bool)
    jout = jfs.post_force(jax.random.PRNGKey(0), js, jnp.asarray(scores),
                          jnp.asarray(is_ucg),
                          jfs.UCGStateCfg(mode=mode, group=group))
    tout = tfs.post_force(ts, torch.as_tensor(scores),
                          torch.as_tensor(is_ucg),
                          tfs.UCGStateCfg(mode=mode, group=group))
    for name in ("ucgp", "ucgstate", "ucgl"):
        close(getattr(tout, name), getattr(jout, name))


def test_ucgstate_mc_not_ported(rng):
    """mc is ported with its uniforms as an input (tests/test_torch_bethe.py
    holds it against JAX): without them it raises, as does an unknown
    mode."""
    _, ts = states(rng)
    with pytest.raises(ValueError):
        tfs.post_force(ts, torch.zeros((ts.n_atoms, 2), dtype=torch.float64),
                       torch.ones(ts.n_atoms, dtype=torch.bool),
                       tfs.UCGStateCfg(mode="mc"))
    with pytest.raises(ValueError):
        tfs.UCGStateCfg(mode="gibbs")


def test_lambda_temperature(rng):
    js, ts = states(rng)
    for u in ("lj", "real"):
        close(tfl.lambda_temperature(ts, tunits.get(u)),
              jfl.lambda_temperature(js, junits.get(u)))


@pytest.mark.parametrize("window,step", [((0, 100), 37), ((0, 0), 5),
                                         ((10, 20), 25), ((3, 1003), 3)])
def test_t_target_ramp_in_float32(window, step):
    jcfg = jfl.LangevinCfg(t_start=0.8, t_stop=1.7, t_period=0.5)
    tcfg = tfl.LangevinCfg(t_start=0.8, t_stop=1.7, t_period=0.5)
    want = float(jfl.t_target(jcfg, jnp.asarray(step, jnp.int32),
                              jnp.asarray(window[0], jnp.int32),
                              jnp.asarray(window[1], jnp.int32)))
    assert tfl.t_target(tcfg, step, *window) == want


@pytest.mark.parametrize("grouped", [False, True])
def test_langevin_post_force_with_injected_noise(rng, grouped):
    """The JAX package draws threefry uniforms by tag; the port cannot
    reproduce those bits, so the test hands the same draws to both."""
    js, ts = states(rng)
    perm = rng.permutation(js.n_atoms)              # tags out of row order
    js = js.permute(jnp.asarray(perm))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    group = (rng.integers(0, 2, js.n_atoms).astype(bool) if grouped
             else None)
    jcfg = jfl.LangevinCfg(t_start=0.8, t_stop=1.2, t_period=0.5, group=group)
    tcfg = tfl.LangevinCfg(t_start=0.8, t_stop=1.2, t_period=0.5, group=group)
    key = jax.random.PRNGKey(7)
    tT = jfl.t_target(jcfg, jnp.asarray(13, jnp.int32),
                      jnp.asarray(0, jnp.int32), jnp.asarray(40, jnp.int32))
    for u in ("lj", "real"):
        jout = jfl.post_force(key, js, tT, 0.004, junits.get(u), jcfg)
        un = np.array(jax.random.uniform(key, (js.rng_n,),
                                         dtype=jnp.float64))
        tout = tfl.post_force(torch.as_tensor(un), ts,
                              tfl.t_target(tcfg, 13, 0, 40), 0.004,
                              tunits.get(u), tcfg)
        close(tout, jout)


def test_softmax_posterior_matches(rng):
    from lammps_ucg_dev_tpu.models import common as jcommon

    s = rng.normal(0, 50, (300, 2))
    u = rng.integers(0, 2, 300).astype(bool)
    close(tcommon.softmax_posterior(torch.as_tensor(s), torch.as_tensor(u)),
          jcommon.softmax_posterior(jnp.asarray(s), jnp.asarray(u)))


def _both_builders(kind, dtype_j, dtype_t):
    settings = (helpers.TWO_STATE_SETTINGS if kind == "two_state"
                else helpers.MIXED_SETTINGS)
    if kind == "two_state":
        _, jbank, jtp, rc = helpers.build_two_state(dtype=dtype_j)
        entries = [[(helpers.make_soft_table(e, rc), rc)
                    for e in (1.0, 0.6, 0.6, 0.25)]]
        coeffs = [(1, 1, 2, 2)]
    else:
        _, jbank, jtp, rc = helpers.build_mixed(dtype=dtype_j)
        coeffs = [(1, 1, 1, 1), (1, 2, 1, 2), (2, 2, 2, 2)]
        entries = [[(helpers.make_soft_table(1.0, rc), rc)],
                   [(helpers.make_soft_table(e, rc), rc) for e in (0.8, 0.5)],
                   [(helpers.make_soft_table(e, rc), rc)
                    for e in (0.9, 0.55, 0.55, 0.3)]]
    tb = ttm.TablePairBuilder("linear", 1200,
                              parse_state_settings(settings, "ucgld"))
    for (i, j, ni, nj), ent in zip(coeffs, entries):
        tb.pair_coeff(i, j, ni, nj, ent)
    tbank, ttp = tb.build(dtype=dtype_t, device="cpu")
    return (jbank, jtp), (tbank, ttp)


@pytest.mark.parametrize("kind", ["two_state", "mixed"])
def test_typemap_and_bank_build_identically(kind):
    (jbank, jtp), (tbank, ttp) = _both_builders(kind, jnp.float64,
                                                torch.float64)
    for name in ("n_states", "formal", "mu", "mu_diff", "tab4", "cutsq"):
        np.testing.assert_array_equal(_np(getattr(ttp, name)),
                                      _np(getattr(jtp, name)), err_msg=name)
    for name in ("innersq", "invdelta", "delta", "cutsq", "e", "f", "de",
                 "df"):
        np.testing.assert_array_equal(_np(getattr(tbank, name)),
                                      _np(getattr(jbank, name)), err_msg=name)
    assert tbank.uniform == jbank.uniform and tbank.nbins == jbank.nbins
    assert isinstance(jtp, jtm.UCGTypeParams)


def test_linear_interp_matches(rng):
    (jbank, jtp), (tbank, _) = _both_builders("mixed", jnp.float64,
                                              torch.float64)
    t = rng.integers(0, jbank.n_tables, (400, 2, 2))
    rsq = rng.uniform(-0.5, 7.0, (400, 1, 1)) * np.ones((1, 2, 2))
    jout = jbank.interp(jnp.asarray(t), jnp.asarray(rsq))
    tout = tbank.interp(torch.as_tensor(t), torch.as_tensor(rsq))
    for a, b in zip(tout, jout):
        close(a, b)


@pytest.mark.parametrize("kind", ["two_state", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fit_bank_bit_identical(kind, dtype):
    (jbank, _), (tbank, _) = _both_builders(kind, getattr(jnp, dtype),
                                            getattr(torch, dtype))
    jc = jcheb.fit_bank(jbank, dtype=getattr(jnp, dtype))
    tc = tcheb.fit_bank(tbank, dtype=getattr(torch, dtype))
    assert tc.degree == jc.degree
    for name in ("coeffs", "lo", "hi", "max_abs_err", "max_rel_err"):
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)), err_msg=name)


def test_convert_params_match_port_build():
    (jbank, jtp), (tbank, ttp) = _both_builders("mixed", jnp.float64,
                                                torch.float64)
    from lammps_ucg_dev_tpu.models import pair_ucgld as jpu

    jp = jpu.UCGLDParams(bank=jbank, tp=jtp, kT=jnp.asarray(0.8),
                         cheb=jcheb.fit_bank(jbank, dtype=jnp.float64))
    tp = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    for name in ("e", "f", "de", "df", "innersq", "invdelta"):
        np.testing.assert_array_equal(_np(getattr(tp.bank, name)),
                                      _np(getattr(tbank, name)))
    np.testing.assert_array_equal(_np(tp.tp.tab4), _np(ttp.tab4))
    np.testing.assert_array_equal(_np(tp.cheb.coeffs), _np(jp.cheb.coeffs))
    assert float(tp.kT) == 0.8 and tp.cheb.degree == jp.cheb.degree


def test_non_linear_tables_not_ported():
    """Every table style builds as in the JAX package (the full parity is
    tests/test_torch_table.py); what neither package ports is a
    BITMAP-spaced table FILE, which raises in both."""
    from lammps_ucg_dev_tpu.io import table_io as jtio
    from lammps_ucg_dev_tpu.ops.table import build_table as jbuild
    from lammps_ucg_dev_tpu_torch.io import table_io as ttio
    from lammps_ucg_dev_tpu_torch.ops.table import build_table

    tb = helpers.make_soft_table(1.0, 2.5)
    for style, length in (("spline", 1000), ("lookup", 1000), ("bitmap", 12)):
        np.testing.assert_array_equal(build_table(tb, style, length, 2.5).e,
                                      jbuild(tb, style, length, 2.5).e)
    for build, io in ((build_table, ttio), (jbuild, jtio)):
        bmp = io.RawTable(r=tb.r, e=tb.e, f=tb.f, rflag=io.BMP)
        with pytest.raises(NotImplementedError):
            build(bmp, "bitmap", 12, 2.5)


def _builder_calls():
    """The four public builders of tensors, each called with no device:
    {name: call}."""
    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.models import pair_rleucg
    from lammps_ucg_dev_tpu_torch.ops.table import TableBank

    def pair_builder():
        b = ttm.TablePairBuilder("linear", 1000, parse_state_settings(
            flagship.TWO_STATE_SETTINGS, "ucgld"))
        b.pair_coeff(1, 1, 2, 2, [(flagship.soft_table(e, 1200), flagship.RC)
                                  for e in flagship.EPS])
        return b

    def rleucg_builder():
        st = parse_state_settings(flagship.RLEUCG_SETTINGS, "rleucg")
        b = ttm.RLEUCGBuilder("linear", 1000, st)
        b.pair_coeff("*", "*", flagship.soft_table(0.5, 1200), flagship.RC)
        return b, st

    return {
        "TableBank.from_built": lambda: TableBank.from_built(
            pair_builder().tables, "linear"),
        "TablePairBuilder.build": lambda: pair_builder().build(),
        "RLEUCGBuilder.build": lambda: rleucg_builder()[0].build(),
        "pair_rleucg.make_params": lambda: pair_rleucg.make_params(
            *rleucg_builder(), 0.8),
    }


@pytest.mark.parametrize("name", ["TableBank.from_built",
                                  "TablePairBuilder.build",
                                  "RLEUCGBuilder.build",
                                  "pair_rleucg.make_params"])
def test_builders_default_to_the_card(name):
    """Like the flagship builders and the converters, these four build on
    the card unless told device="cpu", and raise where there is none."""
    call = _builder_calls()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        return
    out = call()
    first = out[0] if isinstance(out, tuple) else out
    tensor = first.e if hasattr(first, "e") else first.kT
    assert tensor.is_cuda
