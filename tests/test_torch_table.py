"""PyTorch port vs the JAX package: the LOOKUP, LINEAR, SPLINE and BITMAP
tables (``ops/table.py``), their Chebyshev fit (``ops/chebtab.py``) and the
four UCG pair styles' reference paths on banks of every style, in float64
on the CPU; then the kernel path, forced onto the wrappers' plain twins in
float32, with SPLINE and BITMAP banks against the reference path.

* ``build_table``: every style's binned arrays equal bit for bit (the same
  numpy arithmetic); ``init_bitmap``'s tuples and BITMAP's bin edges too.
* ``TableBank.interp``: in range, below the inner cutoff and beyond the
  cut, within 1e-12, with equal out-of-table flags; ``uniform`` only for
  LINEAR.
* ``fit_bank``: SPLINE's and BITMAP's coefficients bit for bit; LOOKUP not
  fittable.
* ``convert.bank_from_numpy`` of the JAX bank equals the port's own build.
* The reference pair paths of ``table_ucgld``, ``table_ucg_bethe``,
  ``table_ucg_bethe_density`` and ``table_rleucg_interface`` (each deck
  writer's system, built by the JAX runner and converted) against the JAX
  package's XLA paths within 1e-10.
* The kernel path (``select_pair_kernel(force=True)``) with SPLINE and
  BITMAP banks against the float32 reference path at the JAX package's
  kernel-vs-XLA gates, scaled by ``max(3e-5, 5 × fit error) / 3e-5``
  (``tests/test_pallas_pair.py:160``).

The JAX side runs eagerly, never interpret-mode Pallas.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.compat.script import ScriptRunner as JRunner
from lammps_ucg_dev_tpu.io import table_io as jtio
from lammps_ucg_dev_tpu.ops import chebtab as jcheb
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.ops import table as jtab
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
from lammps_ucg_dev_tpu_torch.io import table_io as ttio
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.models import registry
from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu_torch.ops import chebtab as tcheb
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.ops import table as ttab
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.tools import make_deck as tmd
from test_torch_core import one_torch_thread  # noqa: F401

STYLES = ("lookup", "linear", "spline", "bitmap")
LENGTH = {"lookup": 800, "linear": 800, "spline": 800, "bitmap": 12}
FIELDS = ("e", "f", "de", "df", "e2", "f2", "rsq", "drsq")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def raw_tables(fprime: bool = False):
    """(JAX RawTable, port RawTable) of the soft table, optionally with
    the file's FPRIME end slopes."""
    j = helpers.make_soft_table(1.0, 2.5)
    kw = dict(r=j.r, e=j.e, f=j.f, rflag=j.rflag, rlo=j.rlo, rhi=j.rhi)
    if fprime:
        kw.update(fpflag=1, fplo=-0.02, fphi=0.01)
    return jtio.RawTable(**kw), ttio.RawTable(**kw)


def rsq_raw():
    """RSQ-spaced raw tables whose r values LINEAR uses verbatim."""
    n, rlo, rhi = 100, 0.9, 2.5
    r = np.sqrt(rlo**2 + (rhi**2 - rlo**2) * np.arange(n) / (n - 1))
    e = 1.0 + np.cos(np.pi * r / rhi)
    f = np.pi / rhi * np.sin(np.pi * r / rhi)
    kw = dict(r=r, e=e, f=f, rflag=jtio.RSQ, rlo=rlo, rhi=rhi)
    return jtio.RawTable(**kw), ttio.RawTable(**kw), n


@pytest.mark.parametrize("case", ["plain", "fprime", "cut2.2", "rsq_match"])
@pytest.mark.parametrize("style", STYLES)
def test_build_table_matches_jax(style, case):
    length, cut = LENGTH[style], 2.5
    if case == "rsq_match":
        jr, tr, n = rsq_raw()
        length = 12 if style == "bitmap" else n
    else:
        jr, tr = raw_tables(fprime=case == "fprime")
        cut = 2.2 if case == "cut2.2" else cut
    jb = jtab.build_table(jr, style, length, cut)
    tb = ttab.build_table(tr, style, length, cut)
    for k in ("cut", "innersq", "delta", "invdelta", "deltasq6", "nmask",
              "nshiftbits"):
        assert getattr(tb, k) == getattr(jb, k), k
    for k in FIELDS:
        a, b = getattr(jb, k), getattr(tb, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_table_errors_match_jax():
    jr, tr = raw_tables()
    for style, length, cut in (("linear", 800, 3.0), ("bitmap", 40, 2.5),
                               ("cubic", 800, 2.5)):
        with pytest.raises(ValueError) as je:
            jtab.build_table(jr, style, length, cut)
        with pytest.raises(ValueError) as te:
            ttab.build_table(tr, style, length, cut)
        assert str(te.value) == str(je.value)
    for mod, io in ((jtab, jtio), (ttab, ttio)):
        bmp = io.RawTable(r=jr.r, e=jr.e, f=jr.f, rflag=io.BMP)
        with pytest.raises(NotImplementedError):
            mod.build_table(bmp, "bitmap", 12, 2.5)


@pytest.mark.parametrize("inner,outer,bits", [
    (1e-3, 2.5, 12), (0.5, 2.5, 10), (0.9, 3.0, 14), (1.0, 9.0, 8)])
def test_init_bitmap_matches_jax(inner, outer, bits):
    assert ttab.init_bitmap(inner, outer, bits) == \
        jtab.init_bitmap(inner, outer, bits)
    for x in (inner * inner, outer * outer, 1.0, 6.25):
        assert ttab._f32_bits(x) == jtab._f32_bits(x)
        assert ttab._bits_f32(ttab._f32_bits(x)) == \
            jtab._bits_f32(jtab._f32_bits(x))


def test_bitmap_bin_edges_match_jax():
    """The BITMAP bin edges (rsq), widths and the cut² closure of the
    largest-r bin equal the JAX package's; each edge sits at the bit
    pattern its index names."""
    jr, tr = raw_tables()
    for bits in (10, 12, 14):
        jb = jtab.build_table(jr, "bitmap", bits, 2.5)
        tb = ttab.build_table(tr, "bitmap", bits, 2.5)
        np.testing.assert_array_equal(tb.rsq, jb.rsq)
        np.testing.assert_array_equal(tb.drsq, jb.drsq)
        it = np.right_shift(np.bitwise_and(
            tb.rsq.astype(np.float32).view(np.int32), tb.nmask),
            tb.nshiftbits)
        np.testing.assert_array_equal(it, np.arange(1 << bits))


def banks(style, dtype=jnp.float64):
    """(JAX bank, the port's own bank, the port's bank converted from the
    JAX one) of the two-state soft system."""
    _, jbank, _, _ = helpers.build_two_state(
        tabstyle=style, tablength=LENGTH[style], dtype=dtype)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    b = TablePairBuilder(style, LENGTH[style], parse_state_settings(
        helpers.TWO_STATE_SETTINGS, "ucgld"))
    raws = [helpers.make_soft_table(eps, 2.5)
            for eps in (1.0, 0.6, 0.6, 0.25)]
    b.pair_coeff(1, 1, 2, 2, [(ttio.RawTable(
        r=j.r, e=j.e, f=j.f, rflag=j.rflag, rlo=j.rlo, rhi=j.rhi), 2.5)
        for j in raws])
    tbank, _ = b.build(dtype=tdt, device="cpu")
    conv = convert.bank_from_numpy(convert.as_numpy_dict(jbank),
                                   device="cpu")
    return jbank, tbank, conv


@pytest.mark.parametrize("style", STYLES)
def test_bank_from_numpy_matches_port_build(style):
    _, tbank, conv = banks(style)
    assert conv.style == tbank.style == style
    assert conv.nbins == tbank.nbins and conv.uniform == tbank.uniform
    assert tbank.uniform == (style == "linear")
    for k in ("innersq", "invdelta", "delta", "cutsq", "deltasq6", "e", "f",
              "de", "df", "e2", "f2", "rsq", "drsq", "nmask", "nshiftbits"):
        a, b = getattr(conv, k), getattr(tbank, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("style", STYLES)
def test_interp_matches_jax(style, dtype):
    """Each style's interpolant at rsq in range, below the inner cutoff
    and beyond the cut (BITMAP narrows rsq to float32 in either dtype)."""
    jbank, _, tbank = banks(style, dtype)
    rng = np.random.default_rng(7)
    inn, cutsq = float(jbank.innersq[0]), float(jbank.cutsq[0])
    rsq = np.concatenate([rng.uniform(inn, cutsq, 600),
                          rng.uniform(0.0, inn, 50), [0.0, inn, cutsq],
                          rng.uniform(cutsq, 2 * cutsq, 50)])
    t = rng.integers(0, 4, rsq.shape)
    jo = jbank.interp(jnp.asarray(t, jnp.int32), jnp.asarray(rsq, dtype))
    to = tbank.interp(torch.as_tensor(t),
                      torch.as_tensor(rsq, dtype=tbank.e.dtype))
    tol = 1e-12 if dtype == jnp.float64 else 1e-6
    for name, a, b in zip(("e", "fp"), jo[:2], to[:2]):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=tol, atol=tol,
                                   err_msg=name)
    for name, a, b in zip(("oob_low", "oob_high"), jo[2:], to[2:]):
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)
    assert bool(to[2].any()) and (bool(to[3].any()) == (style != "bitmap"))


@pytest.mark.parametrize("style", STYLES)
def test_fit_bank_matches_jax(style):
    """The Chebyshev fit of each style's interpolant, bit for bit; LOOKUP
    is not fittable in either package."""
    jbank, _, tbank = banks(style)
    assert tcheb.fittable(tbank) == jcheb.fittable(jbank) == (
        style != "lookup")
    if style == "lookup":
        with pytest.raises(ValueError):
            tcheb.fit_bank(tbank)
        return
    jf = jcheb.fit_bank(jbank, dtype=jnp.float64)
    tf = tcheb.fit_bank(tbank, dtype=torch.float64)
    assert tf.degree == jf.degree
    for k in ("coeffs", "lo", "hi", "max_abs_err", "max_rel_err"):
        np.testing.assert_array_equal(_np(getattr(tf, k)),
                                      np.asarray(getattr(jf, k)), err_msg=k)
    assert float(tf.max_rel_err.max()) < 1e-5


# ---- the four pair styles' reference paths on every table style --------

DECKS = {"ucgld": tmd.write_ucgld_deck, "bethe": tmd.write_bethe_deck,
         "bethe_density": tmd.write_bethe_density_deck,
         "rleucg": tmd.write_rleucg_deck}
CONVERT = {"UCGLDParams": convert.params_from_numpy,
           "BetheParams": convert.bethe_params_from_numpy,
           "BetheDensityParams": convert.bethe_density_params_from_numpy,
           "RLEUCGParams": convert.rleucg_params_from_numpy}


def deck_commands(tmp_path, deck, tabstyle, n=256):
    path = DECKS[deck](str(tmp_path), nsteps=0, tabstyle=tabstyle,
                  tablength=LENGTH[tabstyle], n=n)
    return [s.strip() for s in open(path).read().splitlines()
            if s.split("#")[0].strip() and not s.startswith("run")]


@pytest.mark.parametrize("tabstyle", ["lookup", "spline", "bitmap"])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_reference_pair_path_matches_jax(tmp_path, deck, tabstyle):
    """The JAX runner builds the deck's pair style on a bank of
    ``tabstyle``; the port computes with the converted params and state on
    its nsq list, against the JAX XLA path on the JAX list."""
    jr = JRunner(workdir=str(tmp_path), dtype=jnp.float64,
                 log_callback=lambda m: None)
    for line in deck_commands(tmp_path, deck, tabstyle):
        jr.command(line)
    jcompute, jp, cutoff = jr._build_pair(0.8)
    assert jp.bank.style == tabstyle and not jp.bank.uniform
    tp = CONVERT[type(jp).__name__](convert.as_numpy_dict(jp), device="cpu")
    ts = convert.state_from_numpy(convert.as_numpy_dict(jr.state),
                                  device="cpu")
    n = ts.n_atoms
    L = np.asarray(jr.state.box.lengths)
    jspec = jnb.make_spec(n, L, cutoff, 0.4, method="nsq")
    tspec = tnb.make_spec(n, L, cutoff, 0.4, method="nsq")
    jout = jcompute(jr.state, jnb.build_nsq(jr.state.x, jr.state.box, jspec),
                    jp)
    tcompute, _ = registry.pair_style(jr.pair.style)
    tout = tcompute(ts, tnb.build_nsq(ts.x, ts.box, tspec), tp)
    for name in ("f", "ucgforce", "scores", "virial", "ucgp"):
        a, b = getattr(jout, name), getattr(tout, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                       atol=1e-10, err_msg=name)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=1e-10)
    for name in ("oob_low", "oob_high"):
        assert int(getattr(tout, name)) == int(getattr(jout, name)), name


# the JAX package's kernel-vs-XLA gates at tol = 3e-5 (test_pallas_pair.py):
# each field's gate, relative to max|f| for f, relative for pe, absolute
# for the rest
GATES = {"ucgld": dict(f=3e-5, pe=3e-5, ucgforce=6e-5, scores=9e-4),
         "bethe": dict(f=5e-5, pe=3e-5, scores=1e-4),
         "bethe_density": dict(f=1e-4, pe=3e-5, scores=5e-5, ucgp=5e-5),
         "rleucg": dict(f=1e-4, pe=3e-5)}
ENTRIES = {"ucgld": "compute_style", "bethe": "compute_style_bethe",
           "bethe_density": "compute_style_density",
           "rleucg": "compute_style_rleucg"}


@pytest.mark.parametrize("tabstyle", ["spline", "bitmap"])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_forced_kernel_path_matches_reference(tmp_path, deck, tabstyle):
    """SPLINE and BITMAP banks ride the kernels through their Chebyshev
    fit: the kernel path selected with ``force=True`` (on the CPU its
    wrappers run their plain twins) against the float32 reference path on
    the same state, at ``max(3e-5, 5 × fit error)``'s gates."""
    tr = ScriptRunner(workdir=str(tmp_path), dtype=torch.float32,
                      device="cpu", log_callback=lambda m: None)
    # 512 beads: the column list needs 3 columns of rc + skin a side
    for line in deck_commands(tmp_path, deck, tabstyle, n=512):
        tr.command(line)
    compute, params, cutoff = tr._build_pair(0.8)
    state = dataclasses.replace(tr.state, x=tr.state.box.wrap(tr.state.x))
    sel = select_pair_kernel(params, state, cutoff, 0.4, force=True)
    assert sel is not None and sel[0].__name__ == ENTRIES[deck]
    fn, spec, kparams = sel
    fit_err = float(kparams.cheb.max_rel_err.max())
    scale = max(3e-5, 5.0 * fit_err) / 3e-5
    out_k = fn(state, colpack.build(state.x, state.box, spec), kparams)
    nspec = tnb.make_spec(state.n_atoms, state.box.lengths.numpy(), cutoff,
                          0.4, method="nsq")
    out_r = compute(state, tnb.build_nsq(state.x, state.box, nspec), params)
    for name, gate in GATES[deck].items():
        if name == "pe":
            err = abs(float(out_k.pe) - float(out_r.pe)) / abs(
                float(out_r.pe))
        else:
            diff = (getattr(out_k, name).double()
                    - getattr(out_r, name).double()).abs().max()
            err = float(diff)
            if name == "f":
                err /= float(out_r.f.abs().max())
        assert err <= gate * scale, (name, err, gate * scale, fit_err)
    assert int(out_k.oob_low) == int(out_r.oob_low) == 0
