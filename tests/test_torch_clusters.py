"""The cluster-list path of the port (``ops/clusters.py`` and K8's wrapper
``ops/hopper_cluster.py``) against the JAX package's round-1 cluster lists
and cluster-list kernel (``attic/clusters.py``, ``attic/pallas_ucgld.py``),
on the flagship fluid of ``__graft_entry__._build_sim`` at 512 beads.

* ``clusters.build`` gives the attic's ``jcl``, ``atom_slot`` and
  ``slot_atom`` exactly, in float64;
* K8's plain twin (what the wrapper runs on CPU tensors), on the attic's
  list carried across by ``convert``, against the Pallas kernel in interpret
  mode, both in float32: every ForceOut field within 2e-5 of its largest
  magnitude (pe and the virial relative to theirs), the inner-cutoff count
  exactly.  Both evaluate the same Chebyshev series by Clenshaw and differ
  only in summation order;
* the whole slice: ``build_cluster_sim(device="cpu")`` in float32,
  NVE, 2 blocks x 5 steps, against the JAX run on its XLA path in float64,
  at the tolerances of tests/test_torch_slice.py (5e-5 on the state, 1e-5
  relative on thermo: the Chebyshev fit error plus f32 rounding).

The attic modules are loaded by path.  ``attic/pallas_ucgld.py`` imports
its cluster lists as ``lammps_ucg_dev_tpu.ops.clusters``; that alias is
made for the load only and removed before any test runs, since other
test files share the worker process."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_sim
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.ops import chebtab as jcheb
from lammps_ucg_dev_tpu_torch import convert, flagship
from lammps_ucg_dev_tpu_torch.core.state import Box
from lammps_ucg_dev_tpu_torch.ops import clusters as tcl
from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc
from test_torch_core import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N, NSTEPS, EVERY = 512, 10, 5
FIELDS = ("x", "v", "ucgl", "ucgvl", "ucgp")


def _load(mp, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    mp.setitem(sys.modules, name, mod)      # dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def attic():
    """(clusters, pallas_ucgld) of the attic, loaded by path."""
    with pytest.MonkeyPatch.context() as mp:
        cl = _load(mp, "attic_clusters", ROOT / "attic" / "clusters.py")
        mp.setitem(sys.modules, "lammps_ucg_dev_tpu.ops.clusters", cl)
        pk = _load(mp, "attic_pallas_ucgld",
                   ROOT / "attic" / "pallas_ucgld.py")
    assert "lammps_ucg_dev_tpu.ops.clusters" not in sys.modules
    return cl, pk


@pytest.fixture(scope="module")
def flagship32():
    """The JAX flagship system in float32 and the port's copy of it."""
    sim = _build_sim(n=N)
    js, jp = sim.state, sim.pair_params
    assert js.x.dtype == jnp.float32
    cheb = jcheb.fit_bank(jp.bank)
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    tp = convert.params_from_numpy(convert.as_numpy_dict(jp), device="cpu")
    tcheb = convert.cheb_from_numpy(convert.as_numpy_dict(cheb), device="cpu")
    return js, jp, cheb, ts, tp, tcheb


@pytest.fixture(scope="module")
def attic_list(attic, flagship32):
    """The attic's cluster list of the flagship positions, built in
    float64: (x, L, spec, list).  Its index arrays also serve the float32
    kernel comparison (the positions are float32 values, so both
    precisions bin them alike)."""
    acl, _ = attic
    js = flagship32[0]
    L = float(js.box.lengths[0])
    x = np.asarray(js.x, np.float64)
    spec = acl.make_spec(N, [L] * 3, flagship.RC, 0.4)
    jl = acl.build(jnp.asarray(x), JBox.create([0, 0, 0], [L] * 3,
                                               dtype=jnp.float64), spec)
    return x, L, spec, jl


def test_build_matches_attic_float64(attic, attic_list):
    acl, _ = attic
    x, L, spec, jl = attic_list
    tspec = tcl.make_spec(N, [L] * 3, flagship.RC, 0.4)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    assert spec.cells_per_side == (3, 3, 3) and spec.kc == 128
    tbox = Box.create([0, 0, 0], [L] * 3, dtype=torch.float64, device="cpu")
    tl = tcl.build(torch.as_tensor(x), tbox, tspec)
    for name in ("jcl", "atom_slot", "slot_atom"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)),
                                      err_msg=name)
    assert int(tl.max_occupancy) == int(jl.max_occupancy)
    assert bool(tl.overflow) == bool(jl.overflow) is False
    assert tl.n_clusters == jl.n_clusters == 189
    np.testing.assert_array_equal(
        tcl.sort_order(torch.as_tensor(x), tbox, tspec).numpy(),
        np.asarray(acl.sort_order(jnp.asarray(x), JBox.create(
            [0, 0, 0], [L] * 3, dtype=jnp.float64), spec)))
    # the atom list it expands into holds every pair of the attic's
    tn, jn = tcl.as_neighbor_list(tl, N), acl.as_neighbor_list(jl, N)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    # the cell capacity and KC both raise the flag
    for kw in ({"cell_capacity": 16}, {"kc": 16}):
        small = tcl.make_spec(N, [L] * 3, flagship.RC, 0.4, **kw)
        assert bool(tcl.build(torch.as_tensor(x), tbox, small).overflow)


def test_k8_walk_inputs_match_attic_list(attic_list):
    """K8's host-side inputs: ``occupied``, the i-clusters whose slots hold
    atoms (its grid), and rows whose real entries come first (its walk
    stops at the first pad).  The port's build, at the attic's KC and at a
    KC that holds the whole stencil (where the attic masks rows in place
    and the port compacts them), and the list ``convert`` carries across."""
    x, L, spec, jl = attic_list
    jcl, slot_atom = np.asarray(jl.jcl), np.asarray(jl.slot_atom)
    n_icl = jcl.shape[0]
    occupied = np.flatnonzero((slot_atom < N).reshape(n_icl, 8).any(1))
    real = jcl < n_icl
    assert not np.any(~real[:, :-1] & real[:, 1:])    # no entry after a pad
    np.testing.assert_array_equal(np.flatnonzero(real[:, 0]), occupied)
    tbox = Box.create([0, 0, 0], [L] * 3, dtype=torch.float64, device="cpu")
    tspec = tcl.make_spec(N, [L] * 3, flagship.RC, 0.4)
    width = 27 * tspec.clusters_per_cell
    wide = dataclasses.replace(tspec, kc=-(-(width + 1) // 16) * 16)
    for sp in (tspec, wide):
        tl = tcl.build(torch.as_tensor(x), tbox, sp)
        assert tl.occupied.dtype == torch.int32
        np.testing.assert_array_equal(tl.occupied.numpy(), occupied)
        np.testing.assert_array_equal(tl.jcl[:, :spec.kc].numpy(), jcl)
        assert bool((tl.jcl[:, spec.kc:] == n_icl).all())
    # an attic row masked in place: its pads spread between its entries
    d = convert.as_numpy_dict(jl)
    spread = np.full((n_icl, 2 * spec.kc), n_icl, dtype=jcl.dtype)
    spread[:, 1::2] = jcl
    tl = convert.cluster_list_from_numpy(dict(d, jcl=spread), device="cpu")
    np.testing.assert_array_equal(tl.jcl[:, :spec.kc].numpy(), jcl)
    np.testing.assert_array_equal(tl.occupied.numpy(), occupied)


def test_k8_twin_matches_attic_kernel_interpret(attic, flagship32,
                                                attic_list):
    _, apk = attic
    js, jp, cheb, ts, tp, tcheb = flagship32
    assert float(jnp.max(cheb.max_rel_err)) < 1e-4
    jl = attic_list[3]
    assert not bool(jl.overflow)
    jout = apk.compute(js, jl, jp, cheb, interpret=True)
    tl = convert.cluster_list_from_numpy(convert.as_numpy_dict(jl),
                                         device="cpu")
    assert hc.supports(tp)
    before = dict(hc.ucgld_cluster.launches)
    tout = hc.compute(ts, tl, tp, tcheb)
    assert hc.ucgld_cluster.launches == before       # CPU tensors: the twin
    for name in ("f", "ucgforce", "scores"):
        a, b = np.asarray(getattr(tout, name)), np.asarray(getattr(jout, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-5 * float(np.abs(b).max()),
                                   err_msg=name)
    np.testing.assert_allclose(float(tout.pe), float(jout.pe), rtol=2e-5)
    vj = np.asarray(jout.virial)
    np.testing.assert_allclose(tout.virial.numpy(), vj, rtol=0,
                               atol=2e-5 * float(np.abs(vj).max()))
    assert int(tout.oob_low) == int(jout.oob_low) == 0


@pytest.fixture(scope="module")
def jax_run():
    sim = _build_sim(n=N, dtype=jnp.float64, pallas=False)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    sim.run(NSTEPS, thermo_every=EVERY)
    return ({f: np.asarray(sim.property_atom(f)) for f in FIELDS},
            sim.thermo_rows)


def test_cluster_slice_twin_float32(jax_run):
    ref, ref_rows = jax_run
    before = dict(hc.ucgld_cluster.launches)
    sim = flagship.build_cluster_sim(n=N, device="cpu", reneigh_every=EVERY)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    assert isinstance(sim.nbr_spec, tcl.ClusterSpec)
    sim.run(NSTEPS, thermo_every=EVERY)
    assert hc.ucgld_cluster.launches == before       # CPU tensors: the twin
    for f in FIELDS:
        np.testing.assert_allclose(sim.property_atom(f), ref[f], rtol=0,
                                   atol=5e-5, err_msg=f)
    rows = sim.thermo_rows
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ("temp", "pe", "ke", "ke_lambda", "lambda_temp", "etotal",
                  "press"):
            np.testing.assert_allclose(r[k], q[k], rtol=1e-5, err_msg=k)
        assert r["oob_low"] == q["oob_low"] == 0
    assert sim.dangerous_builds == 0


def test_build_cluster_sim_gates():
    with pytest.raises(ValueError):
        flagship.build_cluster_sim(n=N, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):                            # 2 cells a side
        flagship.build_cluster_sim(n=128, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            flagship.build_cluster_sim(n=N)
        with pytest.raises(RuntimeError):
            convert.cluster_list_from_numpy({})
