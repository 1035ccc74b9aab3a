"""PyTorch port vs the JAX package: restricted-triclinic boxes and the
driver's ``sort_atoms`` and ``check_safety`` switches, on the CPU.

* ``Box.min_image`` against the JAX package's (bit for bit in float64) and
  against an explicit 27-image search; ``wrap``'s round trip and
  fractional range.
* The nsq list and ``pair_ucgld.compute`` on a tilted box against the JAX
  package's within 1e-10.
* The tilt through data files and restarts, written by one package and
  read by both.
* The cell list, the column list and the kernel selection refuse a tilted
  box, as in the JAX package.
* ``sort_atoms``: cell-ordered rows against unsorted ones over 20 steps by
  tag (the JAX package's ``test_sorted_atoms_match_unsorted`` setup, n 512,
  with its Langevin thermostat), and the sorted NVE trajectory against the
  JAX package's sorted one; ``check_safety=False`` gives the same bits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.fixes import langevin as jfl
from lammps_ucg_dev_tpu.fixes import ucgstate as jfs
from lammps_ucg_dev_tpu.io import data as jdio
from lammps_ucg_dev_tpu.io import restart as jrst
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu.runtime.sim import Simulation as JSimulation
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.core.state import Box, System
from lammps_ucg_dev_tpu_torch.fixes import integrate as tfi
from lammps_ucg_dev_tpu_torch.fixes import langevin as tfl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs
from lammps_ucg_dev_tpu_torch.io import data as tdio
from lammps_ucg_dev_tpu_torch.io import restart as trst
from lammps_ucg_dev_tpu_torch.models import pair_ucgld as tpu
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.runtime.sim import SimConfig, Simulation
from test_torch_core import one_torch_thread  # noqa: F401

TILT = (1.5, -1.0, 0.8)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def boxes(L=9.0, tilt=TILT, periodic=(True, True, True)):
    return (JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64, tilt=tilt,
                        periodic=periodic),
            Box.create([0, 0, 0], [L] * 3, dtype=torch.float64, tilt=tilt,
                       periodic=periodic))


def brute_min_image(dr, H):
    """Explicit minimum over the 27 neighboring images."""
    shifts = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64)
    cand = dr[:, None, :] - shifts[None, :, :] @ H.T
    pick = np.argmin(np.sum(cand**2, axis=-1), axis=1)
    return cand[np.arange(len(dr)), pick]


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (True, False, True)])
def test_min_image_matches_jax_and_27_images(periodic):
    jbox, tbox = boxes(periodic=periodic)
    assert tbox.is_triclinic and jbox.is_triclinic
    dr = np.random.default_rng(3).uniform(-12, 12, (500, 3))
    got = _np(tbox.min_image(torch.as_tensor(dr)))
    np.testing.assert_array_equal(got, np.asarray(
        jbox.min_image(jnp.asarray(dr))))
    if all(periodic):
        want = brute_min_image(dr, np.asarray(jbox.h_matrix))
        r_got = np.linalg.norm(got, axis=1)
        r_want = np.linalg.norm(want, axis=1)
        close = r_want < 3.5        # the neighbor-list regime
        np.testing.assert_allclose(r_got[close], r_want[close], atol=1e-12)


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (False, True, True)])
def test_wrap_roundtrip_and_fractional_range(periodic):
    jbox, tbox = boxes(periodic=periodic)
    H = np.asarray(jbox.h_matrix)
    rng = np.random.default_rng(4)
    x = rng.uniform(-15, 25, (300, 3))
    image = rng.integers(-2, 3, (300, 3)).astype(np.int32)
    xw, im = tbox.wrap(torch.as_tensor(x), torch.as_tensor(image))
    jxw, jim = jbox.wrap(jnp.asarray(x), jnp.asarray(image))
    np.testing.assert_allclose(_np(xw), np.asarray(jxw), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_np(im), np.asarray(jim))
    s = np.linalg.solve(H, (_np(xw) - _np(tbox.lo)).T).T
    per = np.asarray(periodic)
    assert s[:, per].min() > -1e-12 and s[:, per].max() < 1 + 1e-12
    # unwrap identity: x = x_w + H @ (image change)
    np.testing.assert_allclose(_np(xw) + (_np(im) - image) @ H.T, x,
                               atol=1e-9)
    np.testing.assert_array_equal(_np(tbox.wrap(torch.as_tensor(x))),
                                  _np(xw))


def tilted_systems(n=96, L=9.5, tilt=(1.2, -0.9, 0.7), seed=5):
    """(JAX state, params, port state, params) of the two-state fluid in a
    tilted box, atoms uniform in fractional coordinates."""
    _, bank, tp, rc = helpers.build_two_state(dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    jbox = JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64, tilt=tilt)
    x = rng.uniform(0, 1, (n, 3)) @ np.asarray(jbox.h_matrix).T
    js = JSimState.create(
        x=x, v=rng.normal(0, 0.5, (n, 3)), typ=np.ones(n, np.int32),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        box=jbox, dtype=jnp.float64)
    jp = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp_ = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    return js, jp, ts, tp_, rc


def test_state_from_numpy_keeps_the_tilt():
    js, _, ts, _, _ = tilted_systems(n=8)
    assert ts.box.is_triclinic
    np.testing.assert_array_equal(_np(ts.box.tilt), np.asarray(js.box.tilt))


def test_tilted_nsq_pair_path_matches_jax():
    js, jp, ts, tp_, rc = tilted_systems()
    n, L = ts.n_atoms, [9.5] * 3
    jspec = jnb.make_spec(n, L, rc, 0.4, method="nsq")
    tspec = tnb.make_spec(n, L, rc, 0.4, method="nsq")
    jl = jnb.build_nsq(js.x, js.box, jspec)
    tl = tnb.build_nsq(ts.x, ts.box, tspec)
    np.testing.assert_array_equal(_np(tl.idx), np.asarray(jl.idx))
    jout = jpu.compute(js, jl, jp)
    tout = tpu.compute(ts, tl, tp_)
    for name in ("f", "ucgforce", "scores", "virial"):
        np.testing.assert_allclose(_np(getattr(tout, name)),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=1e-10)
    assert int(tout.oob_low) == int(jout.oob_low)


def test_tilted_box_refused_off_the_nsq_path():
    _, _, ts, tp_, rc = tilted_systems(n=512, L=12.0)
    spec = tnb.make_spec(512, [12.0] * 3, rc, 0.4, method="cell")
    with pytest.raises(ValueError, match="orthogonal"):
        tnb.build(ts.x, ts.box, spec)
    with pytest.raises(ValueError):
        colpack.build(ts.x.float(), dataclasses.replace(
            ts.box, lo=ts.box.lo.float(), hi=ts.box.hi.float(),
            tilt=ts.box.tilt.float()), colpack.measure_spec(
                np.mod(_np(ts.x), 12.0), np.full(3, 12.0), rc, 0.4))
    f32 = dataclasses.replace(ts, x=ts.x.float())
    assert select_pair_kernel(tp_, f32, rc, 0.4, force=True) is None


def test_data_file_tilt_roundtrip(tmp_path):
    """Each package writes the ``xy xz yz`` line; both read both files."""
    js, _, ts, _, _ = tilted_systems(n=16)
    jdio.write_data(str(tmp_path / "j.data"), js,
                    JSystem(n_atoms=16, ntypes=1, masses=np.ones(2)))
    tdio.write_data(str(tmp_path / "t.data"), ts,
                    System(n_atoms=16, ntypes=1, masses=np.ones(2)))
    assert (tmp_path / "j.data").read_text().splitlines()[1:] == \
        (tmp_path / "t.data").read_text().splitlines()[1:]
    for name in ("j.data", "t.data"):
        for read in (jdio.read_data, tdio.read_data):
            df = read(str(tmp_path / name), atom_style="ucg")
            np.testing.assert_array_equal(df.box_tilt, _np(ts.box.tilt))
            np.testing.assert_allclose(df.x, _np(ts.x), atol=1e-12)


def test_restart_tilt_roundtrip(tmp_path):
    """A JAX restart's tilt reads bit for bit, and the port's restart
    carries its tilt back to the JAX package."""
    js, _, ts, _, _ = tilted_systems(n=16)
    jrst.write_restart(str(tmp_path / "j.npz"), js)
    st, _ = trst.read_restart(str(tmp_path / "j.npz"), dtype=torch.float64,
                              device="cpu")
    assert st.box.is_triclinic
    np.testing.assert_array_equal(_np(st.box.tilt), np.asarray(js.box.tilt))
    np.testing.assert_array_equal(_np(st.x), np.asarray(js.x))
    trst.write_restart(str(tmp_path / "t.npz"), ts)
    back, _ = jrst.read_restart(str(tmp_path / "t.npz"), dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(back.box.tilt),
                                  _np(ts.box.tilt))
    orth = dataclasses.replace(ts, box=dataclasses.replace(ts.box,
                                                           tilt=None))
    trst.write_restart(str(tmp_path / "o.npz"), orth)
    assert trst.read_restart(str(tmp_path / "o.npz"), dtype=torch.float64,
                             device="cpu")[0].box.tilt is None


# ---- sort_atoms and check_safety ---------------------------------------

def sort_systems(nve: bool, n=512, L=12.0):
    """The JAX package's ``test_sorted_atoms_match_unsorted`` system (n 512
    in a 12³ box, cell lists, reneigh 5, dt 0.002, ucgstate ld) in both
    packages, rebuilding every block (``neigh_modify check no``: within 20
    steps no atom moves skin/2, so a checked list would never rebuild and
    never sort); ``nve`` drops its Langevin fix.  Returns a builder of
    (JAX Simulation, port Simulation) for a given ``sort_atoms``."""
    rng = np.random.default_rng(12345)
    _, bank, tp, rc = helpers.build_two_state(dtype=jnp.float64)
    x = helpers.random_fluid(rng, n, L)
    js = JSimState.create(
        x=x, v=rng.normal(0, 0.5, (n, 3)), typ=np.ones(n, np.int32),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        ucgvl=rng.normal(0, 0.2, n), ucgml=np.full(n, 2.0),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64),
        dtype=jnp.float64)
    jp = jpu.UCGLDParams(bank=bank, tp=tp, kT=jnp.asarray(0.8))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp_ = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    masses = np.array([0.0, 1.0])

    def build(sort_atoms, check_safety=True):
        jcfg = JSimConfig(
            dt=0.002, units="lj", integrator=jfi.IntegratorCfg("nve/ucgld"),
            langevin=None if nve else jfl.LangevinCfg(0.8, 0.8, 0.5),
            ucgstate=jfs.UCGStateCfg(mode="ld"), reneigh_every=5,
            reneigh_check=False, sort_atoms=sort_atoms)
        tcfg = SimConfig(
            dt=0.002, units="lj", integrator=tfi.IntegratorCfg("nve/ucgld"),
            langevin=None if nve else tfl.LangevinCfg(0.8, 0.8, 0.5),
            ucgstate=tfs.UCGStateCfg(mode="ld"), reneigh_every=5,
            reneigh_check=False, sort_atoms=sort_atoms,
            check_safety=check_safety)
        jsim = JSimulation(
            JSystem(n_atoms=n, ntypes=1, masses=masses), js, jpu.compute, jp,
            jnb.make_spec(n, [L] * 3, rc, 0.4, method="cell"), jcfg)
        tsim = Simulation(
            System(n_atoms=n, ntypes=1, masses=masses), ts, tpu.compute,
            tp_, tnb.make_spec(n, [L] * 3, rc, 0.4, method="cell"), tcfg)
        return jsim, tsim

    return build


def by_tag(state, field):
    return _np(getattr(state, field))[np.argsort(_np(state.tag))]


@pytest.fixture(scope="module")
def sorted_nve():
    build = sort_systems(nve=True)
    (jsim, tsim), (_, plain) = build(True), build(False)
    for s in (jsim, tsim, plain):
        s.run(20)
    return jsim, tsim, plain


def test_sort_atoms_reorders_rows(sorted_nve):
    _, tsim, plain = sorted_nve
    assert not np.array_equal(_np(tsim.state.tag), _np(plain.state.tag))
    # the rows in the cell order of the last rebuild's positions
    cid, _ = tnb.cell_index(tsim._nbr.x0, tsim.state.box,
                            np.asarray(tsim.nbr_spec.cells_per_side))
    assert bool((cid[1:] >= cid[:-1]).all())
    np.testing.assert_array_equal(np.sort(_np(tsim.state.tag)),
                                  np.arange(1, 513))


def test_sorted_nve_matches_jax_and_unsorted(sorted_nve):
    """The sorted NVE trajectory, by tag, against the JAX package's sorted
    one and the port's unsorted one (summation order differs)."""
    jsim, tsim, plain = sorted_nve
    for f in ("x", "v", "ucgl", "ucgvl", "ucgp"):
        want = by_tag(jsim.state, f)
        np.testing.assert_allclose(by_tag(tsim.state, f), want, rtol=0,
                                   atol=1e-9, err_msg=f)
        np.testing.assert_allclose(by_tag(plain.state, f), want, rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_allclose(tsim.thermo()["etotal"],
                               jsim.thermo()["etotal"], rtol=1e-10)


def test_sorted_atoms_match_unsorted():
    """The JAX package's test, Langevin on: the tag-keyed draws make the
    sorted rows the same trajectory, to 1e-12 by tag."""
    build = sort_systems(nve=False)
    (_, tsim), (_, plain) = build(True), build(False)
    tsim.run(20)
    plain.run(20)
    for f in ("x", "ucgl", "v", "ucgvl"):
        np.testing.assert_allclose(by_tag(tsim.state, f),
                                   by_tag(plain.state, f), rtol=0,
                                   atol=1e-12, err_msg=f)


def test_check_safety_off_same_trajectory():
    build = sort_systems(nve=False, n=256, L=9.5)
    (_, a), (_, b) = build(False), build(False, check_safety=False)
    a.run(20)
    b.run(10)
    b.run_fused(2)
    for f in ("x", "v", "ucgl", "ucgvl", "ucgp"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    tiny = dataclasses.replace(b.nbr_spec, capacity=4)
    b.nbr_spec = tiny
    b._nbr = None
    b.run(5)                    # an overflowed list goes unread
    a.nbr_spec = tiny
    a._nbr = None
    with pytest.raises(RuntimeError, match="capacity"):
        a.run(5)
