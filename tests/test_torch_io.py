"""The port's I/O layer against the JAX package on the CPU: data files,
dumps, restarts, ``Pair::single`` and the deck writers.

* ``read_data``/``write_data`` in both directions, every field bit for bit,
  on the ucg, full, molecular and atomic layouts with image flags and the
  four topology sections, and the ``data_atom_post`` clamps; the files the
  two packages write from the same state are the same bytes.
* Dumps of the same state from both packages, byte for byte, through the
  native writer and the pure-Python one, with a ``thresh`` filter;
  ``read_dump`` and ``apply_snapshot`` against the JAX package's.
* Restarts written by each package and read by the other: every field but
  the random state bit for bit, the settings and ``extra_`` entries too.
* ``pair_single.single``/``single_mixed`` at 1e-12 in float64.
* The seven deck writers of ``examples/make_deck.py`` against the port's
  ``tools/make_deck.py``: every file the same bytes.
"""

import dataclasses
import filecmp
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.io import data as jdio
from lammps_ucg_dev_tpu.io import dump as jdmp
from lammps_ucg_dev_tpu.io import restart as jrst
from lammps_ucg_dev_tpu.runtime import native as jnative
from lammps_ucg_dev_tpu_torch.core.state import Box, SimState, System
from lammps_ucg_dev_tpu_torch.io import data as dio
from lammps_ucg_dev_tpu_torch.io import dump as dmp
from lammps_ucg_dev_tpu_torch.io import restart as rst
from lammps_ucg_dev_tpu_torch.runtime import native
from lammps_ucg_dev_tpu_torch.tools import make_deck as tmd
from test_torch_core import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import make_deck as jmd  # noqa: E402

FLOAT_FIELDS = ("x", "v", "q", "ucgl", "ucgvl", "ucgml", "ucgp")
INT_FIELDS = ("tag", "typ", "mol", "ucgstate", "image")
DF_FIELDS = ("n_atoms", "n_types", "box_lo", "box_hi", "box_tilt", "masses",
             "ids", "mol", "typ", "q", "x", "image", "v", "ucgstate", "ucgl",
             "ucgml", "ucgvl", "bonds", "angles", "dihedrals", "impropers")
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def arrays(seed=3, n=24, L=9.0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.uniform(0, L, (n, 3)), v=rng.normal(0, 1, (n, 3)),
        typ=rng.integers(1, 3, n), mol=rng.integers(1, 5, n),
        q=rng.normal(0, 0.1, n), ucgstate=rng.integers(0, 2, n),
        ucgl=rng.uniform(0, 1, n), ucgvl=rng.normal(0, 1, n),
        ucgml=rng.uniform(1, 3, n), ucgp=rng.uniform(0, 1, n),
        image=rng.integers(-2, 3, (n, 3)), L=L)


def both_states(a, dtype=torch.float64):
    """The same state in both packages."""
    kw = {k: a[k] for k in ("x", "v", "typ", "mol", "q", "ucgstate", "ucgl",
                            "ucgvl", "ucgml", "ucgp")}
    L = a["L"]
    js = JSimState.create(**kw, box=JBox.create([0, 0, 0], [L] * 3,
                                                dtype=JDT[dtype]),
                          dtype=JDT[dtype])
    js = dataclasses.replace(js, image=jnp.asarray(a["image"], jnp.int32))
    ts = SimState.create(**kw, box=Box.create([0, 0, 0], [L] * 3,
                                              dtype=dtype, device="cpu"),
                         dtype=dtype, device="cpu")
    ts = dataclasses.replace(ts, image=torch.as_tensor(a["image"],
                                                       dtype=torch.int32))
    return js, ts


def assert_states_equal(js, ts):
    for f in FLOAT_FIELDS + INT_FIELDS:
        a, b = np.asarray(getattr(js, f)), _np(getattr(ts, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(js.step) == int(ts.step)
    np.testing.assert_array_equal(np.asarray(js.box.lo), _np(ts.box.lo))
    np.testing.assert_array_equal(np.asarray(js.box.hi), _np(ts.box.hi))
    assert tuple(js.box.periodic) == tuple(ts.box.periodic)


def assert_datafiles_equal(a, b):
    for f in DF_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f)


# ---- data files ---------------------------------------------------------

HEADER = """{title}

6 atoms
3 bonds
2 angles
1 dihedrals
1 impropers
2 atom types
1 bond types
1 angle types
1 dihedral types
1 improper types

-1.5 7.5 xlo xhi
0 8 ylo yhi
0.25 9.0 zlo zhi

Masses

1 1.0
2 2.5

"""
TOPOLOGY = """
Bonds

1 1 1 2
2 1 2 3
3 1 4 5

Angles

1 1 1 2 3
2 1 4 5 6

Dihedrals

1 1 1 2 3 4

Impropers

1 1 3 4 5 6
"""
# one row per atom in each layout; λ and the state outside their clamps,
# rows out of id order, some with image flags
ATOMS = {
    "ucg": ["3 1 2 0.1 1.0 2.0 3.0 5 1.7 2.0 1 0 -1",
            "1 1 1 -0.2 0.5 0.5 0.5 0 0.25 5.0",
            "2 1 1 0.0 1.5 1.5 1.5 -3 -0.5 2.0 0 2 0",
            "6 2 2 0.3 4.0 4.0 4.0 1 0.75 3.0",
            "4 2 1 0.0 2.5 3.5 4.5 0 0.5 1.0 -1 -1 -1",
            "5 2 2 0.0 3.0 2.0 1.0 1 0.9 4.0"],
    "full": ["3 1 2 0.1 1.0 2.0 3.0 1 0 -1", "1 1 1 -0.2 0.5 0.5 0.5",
             "2 1 1 0.0 1.5 1.5 1.5 0 2 0", "6 2 2 0.3 4.0 4.0 4.0",
             "4 2 1 0.0 2.5 3.5 4.5 -1 -1 -1", "5 2 2 0.0 3.0 2.0 1.0"],
    "molecular": ["3 1 2 1.0 2.0 3.0 1 0 -1", "1 1 1 0.5 0.5 0.5",
                  "2 1 1 1.5 1.5 1.5 0 2 0", "6 2 2 4.0 4.0 4.0",
                  "4 2 1 2.5 3.5 4.5 -1 -1 -1", "5 2 2 3.0 2.0 1.0"],
    "atomic": ["3 2 1.0 2.0 3.0 1 0 -1", "1 1 0.5 0.5 0.5",
               "2 1 1.5 1.5 1.5 0 2 0", "6 2 4.0 4.0 4.0",
               "4 1 2.5 3.5 4.5 -1 -1 -1", "5 2 3.0 2.0 1.0"],
}
VELOCITIES = ["2 0.1 0.2 0.3 0.5", "1 -0.1 0.0 0.1 -0.25", "3 1.0 1.0 1.0",
              "5 0.0 0.0 0.0 1.5", "4 0.5 -0.5 0.25 0.0", "6 0 0 0 2.0"]


def data_text(layout: str) -> str:
    return (HEADER.format(title=f"{layout} layout")
            + f"Atoms # {layout}\n\n" + "\n".join(ATOMS[layout]) + "\n"
            + "\nVelocities\n\n" + "\n".join(VELOCITIES) + "\n" + TOPOLOGY)


@pytest.mark.parametrize("native_parser", [True, False])
@pytest.mark.parametrize("layout", ["ucg", "full", "molecular", "atomic"])
def test_read_data_matches_jax(tmp_path, monkeypatch, layout, native_parser):
    if not native_parser:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    p = tmp_path / "in.data"
    p.write_text(data_text(layout))
    jdf = jdio.read_data(str(p), atom_style=layout)
    tdf = dio.read_data(str(p), atom_style=layout)
    assert_datafiles_equal(jdf, tdf)
    # the data_atom_post clamps (atom_vec_ucg.cpp:145-170)
    assert tdf.ucgl.min() >= 0.0 and tdf.ucgl.max() <= 1.0
    assert set(np.unique(tdf.ucgstate)) <= {0, 1}
    if layout == "ucg":
        np.testing.assert_array_equal(tdf.ucgstate[:3], [0, 0, 1])
        np.testing.assert_array_equal(tdf.ucgl[:3], [0.25, 0.0, 1.0])
        np.testing.assert_array_equal(tdf.image[2], [1, 0, -1])
        assert tdf.bonds.shape == (3, 4) and tdf.impropers.shape == (1, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_write_data_across_packages(tmp_path, dtype):
    """The same state written by each package: the same bytes, and each
    package's reader gets every field of the other's file."""
    p = tmp_path / "in.data"
    p.write_text(data_text("ucg"))
    topo = dio.read_data(str(p))
    js, ts = both_states(arrays(n=6), dtype)
    masses = np.array([0.0, 1.0, 2.5])
    jdio.write_data(str(tmp_path / "j.data"), js,
                    JSystem(n_atoms=6, ntypes=2, masses=masses),
                    topology=jdio.read_data(str(p)))
    dio.write_data(str(tmp_path / "t.data"), ts,
                   System(n_atoms=6, ntypes=2, masses=masses),
                   topology=topo)
    assert filecmp.cmp(tmp_path / "j.data", tmp_path / "t.data",
                       shallow=False)
    assert_datafiles_equal(jdio.read_data(str(tmp_path / "t.data")),
                           dio.read_data(str(tmp_path / "j.data")))


# ---- dumps ---------------------------------------------------------------

COLUMNS = ("id", "mol", "type", "q", "x", "y", "z", "vx", "vy", "vz", "ix",
           "iy", "iz", "ucgstate", "ucgl", "ucgp", "ucgvl", "ucgml")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("writer", ["native", "python"])
def test_dump_bytes_match_jax(tmp_path, monkeypatch, writer, dtype):
    if writer == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None    # g++ builds it here
    js, ts = both_states(arrays(), dtype)
    for name, (state, mod) in {"j": (js, jdmp), "t": (ts, dmp)}.items():
        w = mod.DumpWriter(str(tmp_path / f"{name}.lammpstrj"),
                           columns=COLUMNS)
        w.write(state, step=0)
        w.write(state, step=10)
        wt = mod.DumpWriter(str(tmp_path / f"{name}_thresh.lammpstrj"),
                            columns=("id", "ucgp", "ucgstate"))
        wt.modify_thresh("ucgp", ">", 0.5)
        wt.modify_thresh("ucgstate", "==", 1)
        wt.write(state, step=5)
    for f in ("", "_thresh"):
        assert filecmp.cmp(tmp_path / f"j{f}.lammpstrj",
                           tmp_path / f"t{f}.lammpstrj", shallow=False), f
    assert w.frames == 2 and w.native_frames == (2 if writer == "native"
                                                 else 0)
    keep = (_np(ts.ucgp) > 0.5) & (_np(ts.ucgstate) == 1)
    assert dmp.read_dump(str(tmp_path / "t_thresh.lammpstrj"))[0].n_atoms \
        == int(keep.sum())


def test_read_dump_and_apply_snapshot_match_jax(tmp_path):
    js, ts = both_states(arrays(), torch.float32)
    path = str(tmp_path / "traj.lammpstrj")
    w = dmp.DumpWriter(path, columns=("id", "type", "x", "y", "z", "vx",
                                      "ucgstate", "ucgl", "ucgp"))
    w.write(ts, step=5)
    w.write(ts, step=15)
    jsn, tsn = jdmp.read_dump(path), dmp.read_dump(path)
    assert [s.step for s in tsn] == [5, 15]
    for a, b in zip(jsn, tsn):
        assert (a.step, a.n_atoms) == (b.step, b.n_atoms)
        np.testing.assert_array_equal(a.box_lo, b.box_lo)
        assert a.fields.keys() == b.fields.keys()
        for k in a.fields:
            np.testing.assert_array_equal(a.fields[k], b.fields[k])
    jb, tb = both_states(arrays(seed=99), torch.float32)
    fields = ("x", "y", "z", "vx", "ucgstate", "ucgl", "ucgp", "type")
    assert_states_equal(jdmp.apply_snapshot(jb, jsn[1], fields=fields),
                        dmp.apply_snapshot(tb, tsn[1], fields=fields))


# ---- restarts ------------------------------------------------------------

SETTINGS = {"units": "lj", "masses": np.array([0.0, 1.0, 2.5]),
            "pair_style": "table_ucgld", "tabstyle": "linear",
            "tablength": 800}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restarts_cross_packages(tmp_path, dtype):
    js, ts = both_states(arrays(), dtype)
    js = dataclasses.replace(js, step=jnp.asarray(40, jnp.int32))
    ts = dataclasses.replace(ts, step=40)
    stats = np.arange(7.0)
    jrst.write_restart(str(tmp_path / "j.npz"), js,
                       extra={"cswitch_stats": stats}, settings=SETTINGS)
    rst.write_restart(str(tmp_path / "t.npz"), ts,
                      extra={"cswitch_stats": torch.as_tensor(stats)},
                      settings=SETTINGS)
    jt = np.load(tmp_path / "j.npz")
    tt = np.load(tmp_path / "t.npz")
    assert sorted(jt.files) == sorted(tt.files)
    for k in jt.files:
        assert jt[k].dtype == tt[k].dtype and jt[k].shape == tt[k].shape, k
        if k != "key":                      # the random state (F1)
            np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)
    # each package reads the other's file
    t_from_j, extra, settings = rst.read_restart_all(
        str(tmp_path / "j.npz"), dtype=dtype, device="cpu")
    j_from_t, jextra, jsettings = jrst.read_restart_all(
        str(tmp_path / "t.npz"), dtype=JDT[dtype])
    assert_states_equal(js, t_from_j)
    assert_states_equal(j_from_t, ts)
    for e in (extra, jextra):
        np.testing.assert_array_equal(e["cswitch_stats"], stats)
    for s in (settings, jsettings, rst.read_restart_settings(
            str(tmp_path / "j.npz"))):
        assert s["pair_style"] == "table_ucgld" and s["tablength"] == 800
        np.testing.assert_array_equal(s["masses"], SETTINGS["masses"])
    np.testing.assert_array_equal(np.asarray(j_from_t.key), rst.jax_key(0))


# ---- Pair::single --------------------------------------------------------

def test_pair_single_matches_jax():
    from lammps_ucg_dev_tpu.io.state_settings import \
        parse_state_settings as jparse
    from lammps_ucg_dev_tpu.models import pair_single as jps
    from lammps_ucg_dev_tpu.models.typemap import TablePairBuilder as JTPB
    from lammps_ucg_dev_tpu_torch.io.state_settings import \
        parse_state_settings
    from lammps_ucg_dev_tpu_torch.models import pair_single as tps
    from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder

    text = "2 3 2\n1 1\n2 2\n2 3\n0.0 0.4\n"
    tabs = {(1, 1): [1.0], (1, 2): [0.8, 0.5], (2, 2): [0.9, 0.55, 0.55, 0.3]}

    def build(builder, parse, soft_table, **kw):
        b = builder("linear", 900, parse(text, "ucgld"))
        for (i, j), eps in tabs.items():
            ns = {1: 1, 2: 2}
            b.pair_coeff(i, j, ns[i], ns[j],
                         [(soft_table(e, 2.5), 2.5) for e in eps])
        return b.build(**kw)

    jbank, jtp = build(JTPB, jparse, jmd.soft_table, dtype=jnp.float64)
    tbank, ttp = build(TablePairBuilder, parse_state_settings,
                       tmd.soft_table, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    n = 400
    it, jt = rng.integers(1, 3, n), rng.integers(1, 3, n)
    rsq = rng.uniform(1e-4, 6.5, n)          # beyond the cut too
    li, lj = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    jsingle, jmixed = jax.jit(jps.single), jax.jit(jps.single_mixed)
    for jout, tout in (
            (jsingle(jbank, jtp, it, jt, rsq, 0.5),
             tps.single(tbank, ttp, it, jt, rsq, 0.5)),
            (jmixed(jbank, jtp, it, jt, rsq, li, lj),
             tps.single_mixed(tbank, ttp, it, jt, rsq, li, lj))):
        for a, b in zip(jout, tout):
            a, b = np.asarray(a), _np(b)
            if a.dtype == bool:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


# ---- the deck writers ------------------------------------------------------

WRITERS = {
    "write_ucgld_deck": dict(n=100, nsteps=20, tablength=800),
    "write_bethe_deck": dict(n=64),
    "write_bethe_density_deck": dict(n=64),
    "write_rleucg_deck": dict(n=64),
    "write_molecular_switch_deck": dict(nmol=20),
    "write_molecular_ucgld_deck": dict(nmol=20),
    "write_molecular_tetramer_deck": dict(nmol=12),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_deck_writers_write_the_same_bytes(tmp_path, name):
    pj = getattr(jmd, name)(str(tmp_path / "j"), **WRITERS[name])
    pt = getattr(tmd, name)(str(tmp_path / "t"), **WRITERS[name])
    assert os.path.basename(pj) == os.path.basename(pt)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "j", tmp_path / "t", files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files) >= 4
