"""The spatial slab and pencil drivers (``parallel/spatial.py``) over
``torch.distributed`` with gloo ranks on the CPU (``parallel/launch.py``,
the legs of ``tools/spatial_check.py``), float64 on the reference path.

* the spec builders against the JAX package's on the same positions (the
  capacities, and the column spec's grid and periodicity), and their
  errors;
* ``colpack.build(valid=)`` + ``restrict_i`` on a slab's virtual box (not
  periodic in x) against JAX ``colpack.build`` bit for bit;
* the four styles' kernel paths (the K1–K6 twins with the stencil's
  periodic flags off) on a halo'd virtual box against the reference path
  on the same rows, and against the kernel path on the periodic box;
* three gloo ranks against the port's single-device ``Simulation``: two
  blocks of the four styles with Langevin on (the tag-keyed draws give
  every atom the same noise on every rank), the reference path at 1e-10
  (the JAX package's own gate, ``tests/test_spatial.py``), the column path
  (the twins, float32) at the JAX package's kernel gates (x 1e-4, v 1e-5,
  λ 1e-6, ucgp 1e-5, pe 1e-5 relative); thermo rows the same way;
* three ranks against the JAX ``SpatialSimulation`` on 3 virtual CPU
  devices under NVE (F1: the packages draw different noise) for UCG-LD and
  P3, at 1e-9;
* a 3×3 pencil grid (9 ranks): the four styles on the reference path at
  1e-10 and P4 on the column path (neither x nor y periodic) against one
  device;
* a fluid streaming at +10 in x that migrates hundreds of atoms in 8
  blocks (tags stay a permutation, trajectory at 1e-10), a halo capacity that
  overflows (every rank raises), and a ``processors 3 1 1`` deck against
  the same deck on one process;
* the drivers' refusals (a contact cutoff past the halo, r-RESPA without
  bonded terms, ``extra_post_force``).

Topology, r-RESPA, ``fix cluster_switch`` and the atom decomposition on
ranks: ``test_torch_spatial_topology.py``.

Each group of ranks runs under its own join limit (300 s, a guard
against a hung rank: under ``pytest -n 6`` the groups share the CPU with
other files' ranks); the references on one process run meanwhile in the
test process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_sim
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.core.state import System as JSystem
from lammps_ucg_dev_tpu.fixes import integrate as jfi
from lammps_ucg_dev_tpu.models import pair_bethe_density as jpd
from lammps_ucg_dev_tpu.ops import colpack as jcp
from lammps_ucg_dev_tpu.parallel import spatial as jsp
from lammps_ucg_dev_tpu.runtime.sim import SimConfig as JSimConfig
from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
from lammps_ucg_dev_tpu_torch.core.state import Box
from lammps_ucg_dev_tpu_torch.models import pair_bethe, pair_bethe_density
from lammps_ucg_dev_tpu_torch.models import pair_rleucg, pair_ucgld
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.parallel import launch
from lammps_ucg_dev_tpu_torch.parallel import spatial as tsp
from lammps_ucg_dev_tpu_torch.tools import make_deck as tmd
from lammps_ucg_dev_tpu_torch.tools import spatial_check as sc
from test_torch_core import one_torch_thread  # noqa: F401
from test_torch_density import jax_p3_bank

N, EVERY, STEPS = 2048, 2, 4
STYLES = ("ucgld", "bethe", "p3", "p4")
JOIN_S = 300.0
RC, SKIN = flagship.RC, 0.4
COL_TOL = {"x": 1e-4, "v": 1e-5, "ucgl": 1e-6, "ucgp": 1e-5}
ROW_KEYS = ("temp", "pe", "ke", "ke_lambda", "lambda_temp", "etotal",
            "press")


def run_job(style, kernel, **kw):
    return dict(kind="run", style=style, n=N, reneigh=EVERY, steps=STEPS,
                thermo_every=EVERY, arrays=True, kernel=kernel,
                dtype="float32" if kernel else "float64", **kw)


def single(job):
    """One device's run of a ``run`` job: (arrays, thermo rows)."""
    sim = sc.build(job, "cpu")
    sim.run(job["steps"], thermo_every=job["thermo_every"])
    return sc.arrays_of(sim.state, sim._fcarry), sim.thermo_rows


def jax_spatial(style):
    """The JAX ``SpatialSimulation`` on 3 slabs of 3 virtual CPU devices,
    NVE, from the port builders' arrays: gathered fields in tag order."""
    dt = jnp.float64
    if style == "ucgld":
        js = _build_sim(n=N, dtype=dt, reneigh_every=EVERY, pallas=False)
        system, state, compute, params = (js.system, js.state,
                                          js.pair_compute, js.pair_params)
        cfg = dataclasses.replace(js.cfg, langevin=None)
        L = float(state.box.lengths[0])
    else:
        a = flagship.density_arrays(N)
        bank, tp = jax_p3_bank(flagship.DENSITY_SETTINGS, dt)
        params = jpd.make_params(bank, tp, flagship.DECK_T, dtype=dt)
        compute, L = jpd.compute, a["L"]
        state = JSimState.create(
            x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
            ucgstate=a["ucgstate"], ucgml=a["ucgml"],
            box=JBox.create([0, 0, 0], [L] * 3, dtype=dt), dtype=dt)
        system = JSystem(n_atoms=N, ntypes=2, masses=np.array([0.0, 1, 1]))
        cfg = JSimConfig(dt=0.002, units="lj",
                         integrator=jfi.IntegratorCfg("nve/ucgld"),
                         reneigh_every=EVERY)
    slab = jsp.make_slab_spec(N, [L] * 3, RC, SKIN, 3,
                              x=np.asarray(state.x))
    sim = jsp.SpatialSimulation(system, state, compute, params, slab, cfg)
    sim.run(STEPS)
    st, _ = sim.gather()
    return {f: np.asarray(getattr(st, f))
            for f in ("x", "v", "ucgl", "ucgvl", "ucgp")}


def deck(tmp, ranks: int) -> str:
    path = tmd.write_ucgld_deck(str(tmp), n=N, nsteps=STEPS,
                                thermo_every=EVERY, tablength=800)
    if ranks > 1:
        text = open(path).read()
        with open(path, "w") as fh:
            fh.write(f"processors {ranks} 1 1\n" + text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned leg and its references: the slab ranks (two groups
    of three, reference and column paths) and the 3×3 pencil grid while
    this process runs the references."""
    tmp = tmp_path_factory.mktemp("spatial")
    ref_jobs = [run_job(s, False) for s in STYLES]
    col_jobs = [run_job(s, True) for s in STYLES]
    nve = [run_job(s, False, nve=True) for s in ("ucgld", "p3")]
    stress = dict(kind="stress", n=N, blocks=8, dims=(3, 1))
    a1 = launch.start(sc.run_jobs, 3,
                      [dict(j, dims=(3, 1)) for j in ref_jobs + nve]
                      + [stress], device="cpu", timeout=JOIN_S)
    sdeck = deck(tmp / "ranks", 3)
    # the second group also runs the slowest references, one a rank
    aside = [("p3", col_jobs[2], 1), ("p4", col_jobs[3], 2),
             ("stress", stress, 0)]
    a2 = launch.start(sc.run_jobs, 3,
                      [dict(j, dims=(3, 1)) for j in col_jobs]
                      + [dict(kind="overflow", n=N, dtype="float64",
                              dims=(3, 1)),
                         dict(kind="deck", path=sdeck,
                              workdir=str(tmp / "ranks"), dims=(3, 1))]
                      + [dict(kind="single", job=j, rank=r, dims=(3, 1))
                         for _, j, r in aside],
                      device="cpu", timeout=JOIN_S)
    # the pencil grid starts beside them: the CPU is shared, not idle
    b = launch.start(sc.run_jobs, 9,
                     [dict(run_job(st, False), dims=(3, 3)) for st in STYLES]
                     + [dict(run_job("p4", True), dims=(3, 3))],
                     device="cpu", timeout=JOIN_S)
    out = {"single": {}, "jax": {}}
    for job in ref_jobs + col_jobs[:2]:
        out["single"][job["style"], job["kernel"]] = single(job)
    for style in ("ucgld", "p3"):
        out["jax"][style] = jax_spatial(style)
    r = ScriptRunner(workdir=str(tmp / "one"), dtype=torch.float32,
                     device="cpu", log_callback=lambda m: None)
    r.run_file(deck(tmp / "one", 1))
    out["deck_single"] = r.thermo_rows
    res1, res2 = a1.join(), a2.join()
    out["slab_ref"] = dict(zip(STYLES, res1[0][:4]))
    out["nve"] = dict(zip(("ucgld", "p3"), res1[0][4:6]))
    out["stress"] = [r[6] for r in res1]
    out["slab_col"] = dict(zip(STYLES, res2[0][:4]))
    out["overflow"] = [r[4] for r in res2]
    out["deck"] = res2[0][5]
    for k, (name, _, rank) in enumerate(aside):
        got = res2[rank][6 + k]
        if name == "stress":
            out["stress_single"] = got["arrays"]
        else:
            out["single"][name, True] = (got["arrays"], got["rows"])
    res = b.join()[0]
    out["pencil_ref"] = dict(zip(STYLES, res[:4]))
    out["pencil_col"] = res[4]
    return out


def near(got, ref, tol, box_L=None):
    for f, t in tol.items():
        a, b = np.asarray(got[f], np.float64), np.asarray(ref[f], np.float64)
        d = a - b
        if f == "x":
            d -= box_L * np.round(d / box_L)     # the spatial driver wraps
        assert np.abs(d).max() <= t, (f, float(np.abs(d).max()))


def box_L(style):
    return {"ucgld": (N / 0.6) ** (1 / 3),
            "bethe": flagship.bethe_arrays(N)["L"],
            "p3": flagship.density_arrays(N)["L"],
            "p4": flagship.rleucg_arrays(N)["L"]}[style]


def rows_near(rows, ref_rows, rtol):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in ROW_KEYS:
            np.testing.assert_allclose(r[k], q[k], rtol=rtol, atol=1e-12,
                                       err_msg=k)
        assert (r["oob_low"], r["oob_high"]) == (q["oob_low"], q["oob_high"])


# ---- the spec builders and the local list ---------------------------------

def flagship_x():
    sim = flagship.build_sim(n=N, dtype=torch.float64, device="cpu",
                             kernel=False)
    L = float(sim.state.box.lengths[0])
    return np.mod(sim.state.x.numpy(), L), L


CAPS = ("n_devices", "n_dev_y", "cap_local", "cap_halo", "cap_mig",
        "cap_halo_y", "cap_mig_y")


@pytest.mark.parametrize("kind", ["slab", "column_slab", "pencil",
                                  "column_pencil"])
def test_spec_builders_match_jax(kind):
    x, L = flagship_x()
    args = (N, [L] * 3, RC, SKIN) + ((3,) if "slab" in kind else (3, 3))
    t = getattr(tsp, f"make_{kind}_spec")(*args, x=x)
    j = getattr(jsp, f"make_{kind}_spec")(*args, x=x)
    assert {c: getattr(t, c) for c in CAPS} == {c: getattr(j, c)
                                                for c in CAPS}
    if kind.startswith("column"):
        assert (t.nbr.mx, t.nbr.my, t.nbr.periodic_x, t.nbr.periodic_y) == (
            j.nbr.mx, j.nbr.my, j.nbr.periodic_x, j.nbr.periodic_y)
        assert t.nbr.periodic_y == (kind == "column_slab")
        # the same capacity, up to the JAX rounding to whole kernel programs
        assert t.nbr.cz <= j.nbr.cz < t.nbr.cz + 8 * j.nbr.G
    else:
        assert t.nbr.method == "cell"
        assert t.nbr.capacity == j.nbr.capacity


def test_spec_errors_match_jax():
    for mod in (tsp, jsp):
        with pytest.raises(ValueError, match="slab width"):
            mod.make_slab_spec(512, [8.0, 8.0, 8.0], 2.5, 0.4, 8)
        with pytest.raises(ValueError, match=">= 3 slabs"):
            mod.make_slab_spec(512, [30.0] * 3, 2.5, 0.4, 2)
        with pytest.raises(ValueError, match="pencil widths"):
            mod.make_pencil_spec(512, [30.0, 8.0, 8.0], 2.5, 0.4, 3, 3)


def test_stencil_matches_jax():
    for px in (True, False):
        for py in (True, False):
            t = tcp.stencil(5, 4, px, py)[0]
            np.testing.assert_array_equal(t, jcp._stencil(5, 4, px, py))


def test_build_valid_restrict_matches_jax():
    """Slab 1 of 3 in its virtual frame, with 24 padding rows and the
    owned atoms marked: the port's build and restrict against JAX's, on the
    JAX spec."""
    x, L = flagship_x()
    rc = RC + SKIN
    eps, w = 1e-3 * rc, L / 3
    Lxv = w + 2 * rc + 2 * eps
    xg = np.mod(x[:, 0] - (w - rc - eps), L)
    sel = xg < Lxv
    xv = np.stack([xg[sel], x[sel, 1], x[sel, 2]], 1)
    pad = np.tile([[0.5 * Lxv, 0.5 * L, 0.5 * L]], (24, 1))
    xv = np.concatenate([xv, pad])
    valid = np.arange(len(xv)) < sel.sum()
    owned = valid & (xv[:, 0] >= rc + eps) & (xv[:, 0] < rc + eps + w)
    jspec = jcp.measure_spec(xv[valid], [Lxv, L, L], RC, SKIN,
                             periodic_x=False)
    assert jspec.NV > 0
    jbox = JBox.create([0, 0, 0], [Lxv, L, L], periodic=(False, True, True),
                       dtype=jnp.float64)
    jcl = jax.jit(lambda xx, va, ow: jcp.restrict_i(
        jcp.build(xx, jbox, jspec, valid=va), ow))(
            jnp.asarray(xv), jnp.asarray(valid), jnp.asarray(owned))
    tspec = tcp.ColumnSpec(cutoff=RC, skin=SKIN, mx=jspec.mx, my=jspec.my,
                           cz=jspec.cz, gz=jspec.gz, gzt=jspec.gzt,
                           czp=jspec.czp, periodic_x=False)
    tbox = Box.create([0, 0, 0], [Lxv, L, L], periodic=(False, True, True),
                      dtype=torch.float64)
    tcl = tcp.restrict_i(tcp.build(torch.as_tensor(xv), tbox, tspec,
                                   valid=torch.as_tensor(valid)),
                         torch.as_tensor(owned))
    for name in ("slot_atom_ext", "zshift"):
        np.testing.assert_array_equal(getattr(tcl, name).numpy(),
                                      np.asarray(getattr(jcl, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tcl.i_owner.numpy(), np.asarray(jcl.i_valid))
    np.testing.assert_array_equal(tcl.atom_slot.numpy()[valid],
                                  np.asarray(jcl.atom_slot)[valid])
    cpc = tcl.z0.shape[1]
    code = np.asarray(jcl.pk_meta)[:, :cpc * 9].reshape(tcl.z0.shape)
    span = (code >> 12) & 255
    np.testing.assert_array_equal(tcl.L.numpy(), span)
    np.testing.assert_array_equal(np.where(span > 0, tcl.z0.numpy(), 0),
                                  np.where(span > 0, code & 4095, 0))
    assert not bool(tcl.overflow) and not bool(jcl.overflow)
    # the edge columns' outside neighbours hold nothing
    sten = tcp.stencil(tcl.mx, tcl.my, False, True)[0]
    assert (sten < 0).any() and (tcl.L.numpy()[:, :, :][
        np.broadcast_to((sten < 0)[:, None, :], tcl.L.shape)] == 0).all()


# ---- the kernel paths on a halo'd virtual box -------------------------------

REF = {"ucgld": pair_ucgld.compute, "bethe": pair_bethe.compute,
       "p3": pair_bethe_density.compute, "p4": pair_rleucg.compute}
GATES = {"ucgld": {"f": 3e-5, "pe": 1e-5, "ucgforce": 1e-4},
         "bethe": {"f": 5e-5, "pe": 3e-5, "scores": 3e-5},
         "p3": {"f": 1e-4, "pe": 3e-5, "scores": 5e-5, "ucgp": 5e-5},
         "p4": {"f": 1e-4, "pe": 3e-5}}


def unrolled(sim):
    """``sim``'s atoms and the images of those within rc of the x faces
    shifted across them, plus 16 padding rows, in a box not periodic in x:
    (state, virtual box, pair box, valid, owned, owner row of each row)."""
    st = sim.state
    L = st.box.lengths
    x = st.box.wrap(st.x)
    n = st.n_atoms
    rc = RC + SKIN
    lo_img = torch.nonzero(x[:, 0] >= L[0] - rc)[:, 0]
    hi_img = torch.nonzero(x[:, 0] < rc)[:, 0]
    owner = torch.cat([torch.arange(n), lo_img, hi_img,
                       torch.zeros(16, dtype=torch.int64)])
    shift = torch.zeros((len(owner), 3), dtype=x.dtype)
    shift[n:n + len(lo_img), 0] = -L[0]
    shift[n + len(lo_img):n + len(lo_img) + len(hi_img), 0] = L[0]
    xv = x[owner] + shift
    xv[-16:] = 0.5 * L
    valid = torch.arange(len(owner)) < n + len(lo_img) + len(hi_img)
    owned = torch.arange(len(owner)) < n
    eps = 1e-3 * rc
    Lf = L.double().numpy()
    kw = dict(periodic=(False, True, True), dtype=x.dtype)
    vbox = Box.create([-rc - eps, 0, 0], [Lf[0] + rc + eps, Lf[1], Lf[2]],
                      **kw)
    pbox = Box.create([0, 0, 0], Lf, **kw)
    state = dataclasses.replace(st.permute(owner), x=xv, box=vbox)
    return state, vbox, pbox, valid, owned, owner


@pytest.mark.parametrize("style", STYLES)
def test_kernels_on_virtual_box(style):
    """The style's kernel path (twins, float32) on the unrolled box, the
    stencil's x axis not periodic, ghosts restricted out of the tallies and
    the density styles' ρ and CV weights exchanged from the owners: the
    owned rows against the float32 reference path on the same rows (the
    oracle gates of ``chip_smoke.py``), and against the kernel path on the
    periodic box within 2e-5 of max|f| (f32 sums in another order)."""
    ker = sc.build(dict(style=style, n=N, kernel=True), "cpu")
    ref = sc.build(dict(style=style, n=N, kernel=False), "cpu")
    state, vbox, pbox, valid, owned, owner = unrolled(ker)
    n = ker.state.n_atoms
    lo = vbox.lo.double().numpy()
    spec = tcp.measure_spec((state.x[valid].double().numpy() - lo),
                            vbox.lengths.double().numpy(), RC, SKIN,
                            periodic_x=False)
    cl = tcp.restrict_i(tcp.build(state.x, vbox, spec, valid=valid), owned)
    assert cl.periodic == (False, True)

    def xchg(a):
        return a[owner]

    extra = ({"xchg": xchg}
             if getattr(ker.pair_compute, "supports_halo_xchg", False)
             else {})
    fk = ker.pair_compute(state, cl, ker.pair_params, **extra)
    cspec = tnb.make_spec(len(owner), vbox.lengths.double().numpy(), RC,
                          SKIN, method="cell")
    nbr = tnb.build(state.x, vbox, cspec, valid=valid, i_valid=owned)
    fr = REF[style](dataclasses.replace(state, box=pbox), nbr,
                    ref.pair_params, **extra)
    periodic = sc.build(dict(style=style, n=N, kernel=True), "cpu")
    pstate = dataclasses.replace(periodic.state,
                                 x=periodic.state.box.wrap(periodic.state.x))
    fp = periodic.pair_compute(
        pstate, tcp.build(pstate.x, pstate.box, periodic.nbr_spec),
        periodic.pair_params)
    scale = float(fr.f[:n].abs().max())
    errs = {"f": float((fk.f[:n] - fr.f[:n]).abs().max()) / scale,
            "pe": abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe))}
    for name in ("ucgforce", "scores", "ucgp"):
        if name in GATES[style]:
            errs[name] = float((getattr(fk, name)[:n]
                                - getattr(fr, name)[:n]).abs().max())
    assert all(errs[k] <= g for k, g in GATES[style].items()), errs
    assert float((fk.f[:n] - fp.f).abs().max()) <= 2e-5 * float(
        fp.f.abs().max())
    assert abs(float(fk.pe) - float(fp.pe)) <= 1e-5 * abs(float(fp.pe))
    # ghost and padding rows tally nothing
    assert float(fk.f[n:].abs().max()) == 0.0 or style in ("p3", "p4")


# ---- ranks against one device -------------------------------------------------

@pytest.mark.parametrize("style", STYLES)
def test_slabs_reference_path_match_one_device(runs, style):
    got = runs["slab_ref"][style]
    arrays, rows = runs["single"][style, False]
    near(got["arrays"], arrays,
         {f: 1e-10 for f in ("x", "v", "ucgl", "ucgvl", "ucgp", "f")},
         box_L(style))
    assert (got["arrays"]["ucgstate"] == arrays["ucgstate"]).all()
    rows_near(got["rows"], rows, 1e-10)
    assert got["tags_ok"]


@pytest.mark.parametrize("style", STYLES)
def test_slabs_column_path_match_one_device(runs, style):
    got = runs["slab_col"][style]
    arrays, rows = runs["single"][style, True]
    near(got["arrays"], arrays, COL_TOL, box_L(style))
    assert (got["arrays"]["ucgstate"] == arrays["ucgstate"]).all()
    rows_near(got["rows"], rows, 1e-5)


@pytest.mark.parametrize("style", ["ucgld", "p3"])
def test_slabs_match_jax_spatial(runs, style):
    near(runs["nve"][style]["arrays"], runs["jax"][style],
         {f: 1e-9 for f in ("x", "v", "ucgl", "ucgvl", "ucgp")},
         box_L(style))


@pytest.mark.parametrize("style", STYLES)
def test_pencils_reference_path_match_one_device(runs, style):
    got = runs["pencil_ref"][style]
    arrays, rows = runs["single"][style, False]
    near(got["arrays"], arrays,
         {f: 1e-10 for f in ("x", "v", "ucgl", "ucgvl", "ucgp", "f")},
         box_L(style))
    assert (got["arrays"]["ucgstate"] == arrays["ucgstate"]).all()
    rows_near(got["rows"], rows, 1e-10)
    assert got["tags_ok"]


def test_pencils_column_path_match_one_device(runs):
    """P4's K5, K4 and K6 twins with neither x nor y periodic."""
    col = runs["pencil_col"]
    arrays, rows = runs["single"]["p4", True]
    near(col["arrays"], arrays, COL_TOL, box_L("p4"))
    rows_near(col["rows"], rows, 1e-5)
    assert col["tags_ok"]


def test_migration_stress(runs):
    """Every atom streaming at +10 in x for 8 blocks: hundreds of
    migrations, no atom lost or doubled, the trajectory of one device."""
    got = runs["stress"]
    assert sum(r["nloc"] for r in got) == N
    assert got[0]["tags_ok"] and got[0]["migrations"] > N // 8
    near(got[0]["arrays"], runs["stress_single"],
         {f: 1e-10 for f in ("x", "v", "ucgl", "ucgvl")}, box_L("ucgld"))


def test_halo_overflow_raises_on_every_rank(runs):
    assert all(r["error"] is not None and "spatial capacity" in r["error"]
               for r in runs["overflow"])


def test_processors_deck_matches_one_process(runs):
    got = runs["deck"]
    assert got["spatial"]
    rows_near(got["rows"], runs["deck_single"], 1e-6)


@pytest.mark.parametrize("case", ["contact_cutoff", "respa_unbonded",
                                  "extra_post_force"])
def test_spatial_refusals(case):
    """What the slab and pencil drivers cannot run, they refuse before they
    touch a process group: a cluster_switch contact cutoff past the halo
    width (cross-face contacts would be invisible), r-RESPA without bonded
    terms (JAX's error), and an ``extra_post_force`` that reads the whole
    system."""
    sim = flagship.build_density_sim(n=N, dtype=torch.float64, device="cpu",
                                     kernel=False, cluster_switch=True)
    slab = tsp.spec_for(sim, (3, 1))
    args = (sim.system, sim.state, sim.pair_compute, sim.pair_params, slab)
    params, freq = sim.cswitch
    cfg, kw, match = sim.cfg, {}, None
    if case == "contact_cutoff":
        rc = slab.rc + 0.1
        kw["cluster_switch"] = (dataclasses.replace(
            params, cutsq=torch.tensor(rc * rc, dtype=torch.float64)), freq)
        match = "halo width"
    elif case == "respa_unbonded":
        cfg, match = dataclasses.replace(cfg, respa_inner=2), "bonded terms"
    else:
        kw["extra_post_force"] = lambda s, u, f: (s, u)
        match = "extra_post_force"
    with pytest.raises(ValueError, match=match):
        tsp.SpatialSimulation(*args, cfg, None, **kw)


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the run with its traceback, within the join
    limit, and no rank outlives it."""
    with pytest.raises(RuntimeError, match="unknown job kind"):
        launch.spawn(sc.run_jobs, 3, [dict(kind="nonsense", dims=(3, 1))],
                     device="cpu", timeout=60)
