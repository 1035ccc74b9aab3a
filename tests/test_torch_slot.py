"""The slot-major interior and the driver's remaining options, on the CPU.

* ``colpack.pack_slots`` against ``colpack.pack`` (cols and ipack's valid
  rows bit for bit) on a uniform fluid, a clumped one and a dilute one
  (ρ 0.05), and the ghost rows' index sets against the JAX package's and
  against ``slot_atom_ext``/``zshift``;
* slot-major against atom-ordered interiors through the kernels' twins,
  identical bits after 2 blocks of 4 steps, for every column style (UCG-LD
  under ``ucgstate ld`` and ``default``, Bethe, P3, P4), Langevin noise on;
* which slot entry each style's interior runs (the score-free one only
  where the scores are inert, read from ``cfg`` at each block), and where
  ``Simulation._slot_ok`` is off;
* the velocity Langevin against the JAX package's with its draws injected,
  ``SimConfig.kT``'s fallback, ``reneigh_check``, the per-block flag
  reads, ``extra_post_force``, and ``ForceOut``'s sum and zeros;
* ``pair_ucgld.potential_energy``: its autograd gradients against
  ``pair_ucgld.compute`` (λ, 1e-9) and against the JAX package's
  ``jax.grad`` (x, 1e-9) in float64, f against −∂E/∂x at the JAX test's
  5e-3 (the tables' f column is not the derivative of their e column
  between the bins)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core import units as junits
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.fixes import langevin as jfl
from lammps_ucg_dev_tpu.models import pair_ucgld as jpu
from lammps_ucg_dev_tpu.ops import colpack as jcp
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu_torch import convert, flagship
from lammps_ucg_dev_tpu_torch.core import units as tunits
from lammps_ucg_dev_tpu_torch.core.state import Box, ForceOut
from lammps_ucg_dev_tpu_torch.fixes import langevin as tfl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs
from lammps_ucg_dev_tpu_torch.models import pair_ucgld as tpu
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from lammps_ucg_dev_tpu_torch.runtime.sim import SimConfig, Simulation
from test_torch_core import one_torch_thread, states  # noqa: F401
from test_torch_pair_ucgld import systems

N, EVERY, BLOCKS = 512, 4, 2
RC, SKIN = 2.5, 0.4
FIELDS = ("x", "v", "ucgl", "ucgvl", "ucgp", "ucgstate")
FOUT = ("f", "ucgforce", "scores", "pe", "virial")


# ---- pack_slots ----------------------------------------------------------------

def fluid(kind):
    """(x, L) of one configuration, from a seed."""
    rng = np.random.default_rng(21)
    if kind == "dilute":                       # ρ 0.05: most slots are pads
        n = 400
        L = (n / 0.05) ** (1 / 3)
        return rng.uniform(0, L, (n, 3)), L
    n, L = 512, 9.5
    x = rng.uniform(0, L, (n, 3))
    if kind == "clumped":
        # half the atoms in a slab at z < 1.5: full columns whose top
        # copies land on the real region's pad slots
        x[: n // 2, 2] = rng.uniform(0, 1.5, n // 2)
    return x, L


@pytest.fixture(scope="module", params=["uniform", "clumped", "dilute"])
def column_list(request):
    x, L = fluid(request.param)
    spec = colpack.measure_spec(x, [L] * 3, RC, SKIN)
    box = Box.create([0, 0, 0], [L] * 3)
    xt = torch.as_tensor(x, dtype=torch.float32)
    cl = colpack.build(xt, box, spec)
    assert not bool(cl.overflow)
    return x, L, spec, box, xt, cl


def slot_order(cl, a, pad):
    """``a`` (N, ...) in real-slot order, pad rows ``pad``."""
    n = a.shape[0]
    padded = torch.cat([a, torch.full((1, *a.shape[1:]), pad, dtype=a.dtype)])
    return padded[colpack.slot_atom_real(cl, n)]


def test_pack_slots_matches_pack(column_list):
    _, _, _, box, x, cl = column_list
    n = x.shape[0]
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32)
    state = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32)
    aux = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32)
    typ = torch.as_tensor(rng.integers(1, 4, n), dtype=torch.int32)
    ipack, cols = colpack.pack(cl, box, x, lam, state, aux=aux, typ=typ)
    # the slot state's pads: poisoned x, typ 1 (as Simulation._to_slots)
    s_ipack, s_cols = colpack.pack(
        cl, box, slot_order(cl, x, colpack._PAD_POISON),
        slot_order(cl, lam, 0.0), slot_order(cl, state, 0),
        aux=slot_order(cl, aux, 0.5), typ=slot_order(cl, typ, 1), slot=True)
    assert torch.equal(s_cols, cols)
    assert torch.equal(s_ipack[cl.i_valid], ipack[cl.i_valid])
    assert bool((s_ipack[~cl.i_valid, 5] == 0).all())
    # fed the atom-ordered packing's own rows, pack_slots gives its cols
    assert torch.equal(colpack.pack_slots(cl, box, ipack), cols)
    # ghost-top copies on the real region's pad slots (every fluid here has
    # some: the region keeps >= 8 pad slots past each column's atoms)
    q = cl.tidx % cl.czp
    inside = (cl.tidx < cl.ncol * cl.czp) & (q < cl.gz + cl.cz)
    assert int(inside.sum()) > 0


def test_slot_index_sets(column_list):
    x, L, spec, box, xt, cl = column_list
    n = xt.shape[0]
    ncol, czp, gz, cz = cl.ncol, cl.czp, cl.gz, cl.cz
    sae = cl.slot_atom_ext.reshape(ncol, czp)
    zsh = cl.zshift.reshape(ncol, czp)
    real = sae[:, gz:gz + cz]
    sar = colpack.slot_atom_real(cl, n)
    assert torch.equal(sar, torch.where(cl.i_valid, real.reshape(-1), n))
    assert torch.equal(sar[cl.atom_slot], torch.arange(n))
    assert int((sar < n).sum()) == n
    # bottom rows: a copy (z - Lz) of their source rank, or pads
    src = torch.gather(real, 1, cl.bsrc)
    assert torch.equal(torch.where(cl.bok, src, n), sae[:, :gz])
    assert bool((zsh[:, :gz] == torch.where(cl.bok, -1, 0)).all())
    # top copies: rank t at its flat target, z + Lz; nothing else has +1
    live = cl.tidx < ncol * czp
    t = torch.arange(cl.tidx.shape[1]).expand_as(cl.tidx)
    flat_sae, flat_zsh = cl.slot_atom_ext, cl.zshift
    assert torch.equal(flat_sae[cl.tidx[live]], real[:, :cl.tidx.shape[1]][live])
    assert bool((flat_zsh[cl.tidx[live]] == 1).all())
    assert int((flat_zsh == 1).sum()) == int(live.sum())
    count = cl.i_valid.reshape(ncol, cz).sum(1, keepdim=True)
    assert bool((t < count)[live].all())
    # the JAX package's index sets on the same atoms, at its capacities
    jspec = jcp.measure_spec(x, [L] * 3, RC, SKIN)
    cl = colpack.build(xt, box, colpack.ColumnSpec(
        cutoff=RC, skin=SKIN, mx=jspec.mx, my=jspec.my, cz=jspec.cz,
        gz=jspec.gz, gzt=jspec.gzt, czp=jspec.czp))
    ncol, czp = cl.ncol, cl.czp
    sar = colpack.slot_atom_real(cl, n)
    jcl = jax.jit(lambda xx, b: jcp.build(xx, b, jspec))(
        jnp.asarray(x, jnp.float32), JBox.create([0, 0, 0], [L] * 3))
    np.testing.assert_array_equal(cl.bsrc.numpy(), np.asarray(jcl.bsrc))
    np.testing.assert_array_equal(cl.bok.numpy(), np.asarray(jcl.bok))
    jt = np.asarray(jcl.tidx)
    k = cl.tidx.shape[1]
    np.testing.assert_array_equal(cl.tidx.numpy(), jt[:, :k])
    assert bool(np.all(jt[:, k:] == ncol * czp))
    np.testing.assert_array_equal(sar.numpy(),
                                  np.asarray(jcp.slot_atom_real(jcl, n)))


# ---- slot-major against atom-ordered trajectories ------------------------------

STYLES = {
    "ucgld_ld": (flagship.build_sim, None),
    "ucgld_default": (flagship.build_sim, "default"),
    "bethe": (flagship.build_bethe_sim, None),
    "p3": (flagship.build_density_sim, None),
    "p4": (flagship.build_rleucg_sim, None),
}


@pytest.fixture(scope="module")
def built():
    """One column-path system per style (twins on the CPU), Langevin on."""
    out = {}
    for name, (build, mode) in STYLES.items():
        sim = build(n=N, kernel=True, device="cpu", reneigh_every=EVERY)
        if mode is not None:
            sim.cfg = dataclasses.replace(sim.cfg,
                                          ucgstate=tfs.UCGStateCfg(mode=mode))
        out[name] = sim
    return out


def fresh(sim, seed=0, **kw):
    return Simulation(sim.system, sim.state, sim.pair_compute,
                      sim.pair_params, sim.nbr_spec, sim.cfg, seed=seed, **kw)


def run_blocks(sim):
    sim.run_fused(BLOCKS, run_window=(0, BLOCKS * EVERY))
    return sim


@pytest.fixture(scope="module")
def runs(built):
    """Per style: (slot-major run, atom-ordered run, pack_slots calls, the
    (pair entry, scores_valid) of each block's slot-major interior)."""
    out = {}
    orig = colpack.pack_slots
    for name, sim in built.items():
        calls, entries = [], []

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        slot = fresh(sim)
        assert slot._slot_ok
        interior = slot._slot_interior

        def recorded(state, fcarry, nbr, window, k, slot_fn, scores_valid):
            entries.append((slot_fn, scores_valid))
            return interior(state, fcarry, nbr, window, k, slot_fn,
                            scores_valid)

        slot._slot_interior = recorded
        colpack.pack_slots = counted
        try:
            run_blocks(slot)
        finally:
            colpack.pack_slots = orig
        atom = fresh(sim)
        atom._slot_ok = False
        out[name] = (slot, run_blocks(atom), len(calls), entries)
    return out


@pytest.mark.parametrize("style", list(STYLES))
def test_slot_interior_identical_bits(runs, style):
    slot, atom, calls, _ = runs[style]
    passes = 3 if style in ("p3", "p4") else 1
    assert calls == BLOCKS * (EVERY - 1) * passes
    for f in FIELDS:
        assert torch.equal(getattr(slot.state, f), getattr(atom.state, f)), f
    for f in FOUT:
        assert torch.equal(getattr(slot._fcarry, f),
                           getattr(atom._fcarry, f)), f
    assert slot.state.step == atom.state.step == BLOCKS * EVERY
    assert slot.thermo() == atom.thermo()


@pytest.mark.parametrize("style", list(STYLES))
def test_slot_rows_without_atoms(built, style):
    """On slot-resident state the pair entry's rows of slots without a real
    atom are zero and every row is finite; the state keeps its atom count
    for the tag-keyed draws."""
    sim = fresh(built[style])
    sim.setup((0, EVERY))
    cl = sim._nbr
    ss, sf = sim._to_slots(sim.state, sim._fcarry, cl)
    assert ss.n_atoms == cl.n_slots and ss.rng_n == N
    assert sim._uniforms(ss).shape == (N,)
    assert sim._uniforms(ss, 3).shape == (N, 3)
    pad = ~cl.i_valid
    assert bool((ss.x[pad] == colpack._PAD_POISON).all())
    assert bool((ss.ucgml[pad] == 1).all() and (ss.ucgp[pad] == -1).all())
    assert bool((ss.tag[pad] == 1).all() and (ss.typ[pad] == 1).all())
    fo = sim.pair_compute.slot_fast(ss, cl, sim.pair_params)
    assert fo.f.shape == (cl.n_slots, 3)
    assert bool((fo.f[pad] == 0).all())
    for name in ("f", "ucgforce", "scores"):
        assert bool(torch.isfinite(getattr(fo, name)).all()), name
    # the round trip through slot order keeps every field
    st, fc = sim._from_slots(sim.state, ss, sf, cl)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(sim.state, f)), f
    for f in ("f", "ucgforce", "scores"):
        assert torch.equal(getattr(fc, f), getattr(sim._fcarry, f)), f


SLOT_ENTRY = {   # the interior's pair entry and whether ucgstate updates
    "ucgld_ld": (hp.compute_style_slot_fast_noscores, False),
    "ucgld_default": (hp.compute_style_slot_fast, True),
    "bethe": (hb.compute_style_bethe_slot_fast, True),
    "p3": (hd.compute_style_density_slot_fast_noscores, False),
    "p4": (hr.compute_style_rleucg_slot_fast, True),   # no score-free entry
}


@pytest.mark.parametrize("style", list(STYLES))
def test_slot_interior_entry(runs, style):
    """Every block's slot-major interior runs the style's score-free slot
    entry when the scores are inert and the style has a score-free fast
    variant, else ``slot_fast`` with scores: UCG-LD under ``ucgstate
    default`` runs K1's scored slot variant."""
    slot, _, _, entries = runs[style]
    assert entries == [SLOT_ENTRY[style]] * BLOCKS


def test_scores_inert_follows_cfg(built):
    """A ``cfg`` set on a built Simulation decides the next block's
    interior: the scores stop being inert under ``ucgstate default``."""
    sim = fresh(built["ucgld_ld"])
    assert sim._scores_inert
    sim.cfg = dataclasses.replace(sim.cfg,
                                  ucgstate=tfs.UCGStateCfg(mode="default"))
    assert not sim._scores_inert
    sim.cfg = dataclasses.replace(sim.cfg, ucgstate=None)
    assert sim._scores_inert


def test_k1_slot_entries(built):
    pc = hp.compute_style
    assert pc.slot_fast is hp.compute_style_slot_fast
    assert pc.slot_fast_noscores is hp.compute_style_slot_fast_noscores
    sim = fresh(built["ucgld_ld"])
    sim.setup((0, EVERY))
    cl = sim._nbr
    ss, _ = sim._to_slots(sim.state, sim._fcarry, cl)
    for scores in (True, False):
        a = hp.compute(sim.state, cl, sim.pair_params, sim.pair_params.cheb,
                       observe=False, want_scores=scores)
        b = hp.compute(ss, cl, sim.pair_params, sim.pair_params.cheb,
                       observe=False, want_scores=scores, slot=True)
        for f in ("f", "ucgforce", "scores"):
            assert torch.equal(getattr(b, f)[cl.atom_slot], getattr(a, f))


def test_slot_ok_off():
    ref = flagship.build_sim(n=N, kernel=False, device="cpu")
    assert not ref._slot_ok                         # the reference path
    clus = flagship.build_cluster_sim(n=N, device="cpu")
    assert not clus._slot_ok                        # K8's cluster path
    col = flagship.build_sim(n=N, kernel=True, device="cpu")
    assert col._slot_ok and col._scores_inert
    hook = fresh(col, extra_post_force=lambda s, u, f: (s, u))
    assert not hook._slot_ok and not hook._scores_inert
    # float64 state on the column path
    s64 = dataclasses.replace(
        col.state, x=col.state.x.double(), v=col.state.v.double())
    f64 = Simulation(col.system, s64, col.pair_compute, col.pair_params,
                     col.nbr_spec, col.cfg)
    assert not f64._slot_ok
    # a pair entry without a slot variant
    bare = Simulation(col.system, col.state, hp.compute_style_fast,
                      col.pair_params, col.nbr_spec, col.cfg)
    assert not bare._slot_ok


# ---- the driver's remaining options ------------------------------------------

@pytest.mark.parametrize("grouped", [False, True])
def test_velocity_langevin_with_injected_noise(grouped):
    rng = np.random.default_rng(9)
    js, ts = states(rng)
    perm = rng.permutation(js.n_atoms)               # tags out of row order
    js = js.permute(jnp.asarray(perm))
    ts = convert.state_from_numpy(convert.as_numpy_dict(js), device="cpu")
    group = (rng.integers(0, 2, js.n_atoms).astype(bool) if grouped
             else None)
    mass_np = rng.uniform(0.5, 2.0, js.n_atoms)
    jcfg = jfl.VLangevinCfg(t_start=0.8, t_stop=1.2, damp=0.5, group=group)
    tcfg = tfl.VLangevinCfg(t_start=0.8, t_stop=1.2, damp=0.5, group=group)
    key = jax.random.PRNGKey(5)
    tT = jfl.t_target(jcfg, jnp.asarray(13, jnp.int32),
                      jnp.asarray(0, jnp.int32), jnp.asarray(40, jnp.int32))
    for u in ("lj", "real"):
        jout = jfl.post_force_v(key, js, jnp.asarray(mass_np), tT, 0.004,
                                junits.get(u), jcfg)
        un = np.array(jax.random.uniform(key, (js.rng_n, 3),
                                         dtype=jnp.float64))
        tout = tfl.post_force_v(torch.as_tensor(un), ts,
                                torch.as_tensor(mass_np),
                                tfl.t_target(tcfg, 13, 0, 40), 0.004,
                                tunits.get(u), tcfg)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-12)


def test_kT_falls_back_to_the_velocity_langevin():
    lam = tfl.LangevinCfg(t_start=0.8, t_stop=0.8, t_period=0.5)
    vel = tfl.VLangevinCfg(t_start=1.3, t_stop=1.3, damp=1.0)
    assert SimConfig(dt=0.002).kT == 0.0
    assert SimConfig(dt=0.002, vlangevin=vel).kT == 1.3
    assert SimConfig(dt=0.002, langevin=lam, vlangevin=vel).kT == 0.8
    real = SimConfig(dt=1.0, units="real", vlangevin=vel)
    assert real.kT == tunits.get("real").boltz * 1.3


def test_velocity_langevin_in_the_driver(built):
    """The velocity thermostat's draws come from the driver's generator,
    (rng_n, 3) after the λ-Langevin's, and reach f; in slot order as in
    atom order."""
    base = built["ucgld_ld"]
    cfg = dataclasses.replace(
        base.cfg, vlangevin=tfl.VLangevinCfg(t_start=0.8, t_stop=0.8,
                                             damp=0.3))
    a = Simulation(base.system, base.state, base.pair_compute,
                   base.pair_params, base.nbr_spec, cfg)
    b = Simulation(base.system, base.state, base.pair_compute,
                   base.pair_params, base.nbr_spec, cfg)
    b._slot_ok = False
    plain = fresh(base)
    for s in (a, b, plain):
        run_blocks(s)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert not torch.equal(a.state.v, plain.state.v)


def test_reneigh_check_false_rebuilds_every_block(built):
    for check, want in ((False, 1 + 3), (True, None)):
        sim = fresh(built["ucgld_ld"])
        sim.cfg = dataclasses.replace(sim.cfg, reneigh_check=check)
        count = []
        orig = sim._nbr_build
        sim._nbr_build = lambda st: (count.append(1), orig(st))[1]
        sim.run_fused(3, run_window=(0, 3 * EVERY))
        if want is not None:
            assert len(count) == want
        else:
            assert 1 <= len(count) <= 1 + 3


def test_check_block_reads_the_flags(built):
    """Each block's overflow flag raises and its danger flag is counted;
    the slot-major block returns the flag of its atom-ordered state."""
    sim = fresh(built["ucgld_ld"])
    sim.setup((0, EVERY))
    bad = dataclasses.replace(sim._nbr, overflow=torch.tensor(True))
    with pytest.raises(RuntimeError, match="capacity"):
        sim._check_block(bad, torch.tensor(True))
    sim._check_block(sim._nbr, torch.tensor(True))
    sim._check_block(sim._nbr, torch.tensor(False))
    assert sim.dangerous_builds == 1
    state, _, nbr, danger = sim._block(sim.state, sim._fcarry, (0, EVERY),
                                       EVERY, nbr=sim._nbr)
    assert torch.equal(danger, tnb.displacement_check(
        nbr, state.x, state.box, sim.nbr_spec.skin))


def test_extra_post_force_hook(built):
    """The hook runs once per force pass, between the bias force and
    ``ucgstate``; an identity hook leaves the UCG-LD trajectory's bits as
    they are (the hook turns the score-free, slot-major interior into the
    atom-ordered one with scores, whose forces are the same)."""
    base = built["ucgld_ld"]
    seen = []

    def hook(state, ucgforce, fout):
        seen.append((state.n_atoms, ucgforce.shape, fout.scores.shape))
        return state, ucgforce

    sim = fresh(base, extra_post_force=hook)
    run_blocks(sim)
    assert len(seen) == 1 + BLOCKS * EVERY
    assert all(s == (N, (N,), (N, 2)) for s in seen)
    ref = run_blocks(fresh(base))
    for f in FIELDS:
        assert torch.equal(getattr(sim.state, f), getattr(ref.state, f)), f
    # a hook that changes the λ-force changes λ
    push = fresh(base, extra_post_force=lambda s, u, f: (s, u + 1.0))
    run_blocks(push)
    assert not torch.equal(push.state.ucgl, ref.state.ucgl)


def test_forceout_sum_and_zeros():
    z = ForceOut.zeros(5, dtype=torch.float64)
    assert z.f.shape == (5, 3) and z.scores.shape == (5, 2)
    assert z.pe.shape == () and z.virial.shape == (6,)
    assert z.oob_low is None and z.ucgp is None
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape))

    a = ForceOut(f=t(5, 3), ucgforce=t(5), scores=t(5, 2), pe=t(),
                 virial=t(6), oob_low=torch.tensor(2), ucgp=t(5))
    b = ForceOut(f=t(5, 3), ucgforce=t(5), scores=t(5, 2), pe=t(),
                 virial=t(6), oob_low=torch.tensor(3), oob_high=torch.tensor(1))
    s = a + b
    for f in ("f", "ucgforce", "scores", "pe", "virial"):
        assert torch.equal(getattr(s, f), getattr(a, f) + getattr(b, f))
    assert int(s.oob_low) == 5 and int(s.oob_high) == 1
    assert torch.equal(s.ucgp, a.ucgp)               # b has none
    assert torch.equal((z + a).f, a.f)


# ---- potential_energy by autograd ----------------------------------------------

def test_potential_energy_gradients():
    js, jp, jspec, ts, tp_, tspec = systems(np.random.default_rng(12345),
                                            "two_state")
    jnbr = jnb.build_nsq(js.x, js.box, jspec)
    tnbr = tnb.build_nsq(ts.x, ts.box, tspec)
    out = tpu.compute(ts, tnbr, tp_)
    x = ts.x.clone().requires_grad_(True)
    lam = ts.ucgl.clone().requires_grad_(True)
    e = tpu.potential_energy(x, lam, ts, tnbr, tp_)
    e.backward()
    je = jpu.potential_energy(js.x, js.ucgl, js, jnbr, jp)
    np.testing.assert_allclose(float(e.detach()), float(je), rtol=1e-12)
    is_ucg = (tp_.tp.n_states[ts.typ] > 1).numpy()
    np.testing.assert_allclose(-lam.grad.numpy()[is_ucg],
                               out.ucgforce.numpy()[is_ucg], rtol=0,
                               atol=1e-9)
    jgx = jax.grad(lambda xx: jpu.potential_energy(xx, js.ucgl, js, jnbr,
                                                   jp))(js.x)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(out.f.numpy(), -x.grad.numpy(), atol=5e-3,
                               rtol=5e-3)
