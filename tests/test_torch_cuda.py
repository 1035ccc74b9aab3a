"""K1–K8 on the card: the hand-written CUDA kernels against their plain
PyTorch twins on the same CUDA tensors, and the main paths through them.  Needs an NVIDIA GPU and nvcc; without them
every test here skips.  The file imports nothing of JAX, so it also runs
where JAX is absent (skip the JAX test configuration there):
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.

Tolerance: both sides compute in f32 with the same algorithm and differ
only by FMA contraction and summation order, so every field is held within
2e-5 of its largest magnitude (pe within 2e-5 relative)."""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.core.state import Box, SimState
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.io.table_io import RLINEAR, RawTable
from lammps_ucg_dev_tpu_torch.models import pair_bethe
from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel

pytestmark = pytest.mark.cuda
TOL = 2e-5
VARIANTS = [("full", True, True), ("fast", False, True),
            ("noscores", False, False)]
BETHE_VARIANTS = [(m, p, o) for m in ("bethe", "mf") for p in (True, False)
                  for o in (True, False)]


# 2 actual types: type 1 plain, type 2 UCG with formal types (2, 3)
MIXED_SETTINGS = "2 3 2\n1 1\n2 2\n2 3\n0.0 0.4\n"


def soft_table(eps, rc=2.5, n=1500, rlo=1e-3):
    r = np.linspace(rlo, rc, n)
    return RawTable(r=r, e=eps * (1.0 + np.cos(np.pi * r / rc)),
                    f=eps * np.pi / rc * np.sin(np.pi * r / rc),
                    rflag=RLINEAR, rlo=rlo, rhi=rc)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


def assert_close_fout(fk, ft, fields, observe):
    for name in fields:
        a, b = getattr(fk, name).cpu(), getattr(ft, name).cpu()
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=name)
    if observe:
        np.testing.assert_allclose(float(fk.pe), float(ft.pe), rtol=TOL)
        vs = float(ft.virial.abs().max())
        np.testing.assert_allclose(fk.virial.cpu().numpy(),
                                   ft.virial.cpu().numpy(), rtol=0,
                                   atol=TOL * vs)
        assert int(fk.oob_low) == int(ft.oob_low)


def kernel_vs_twin(state, cl, params, observe, scores):
    args, kw = hp.kernel_inputs(state, cl, params, params.cheb, observe,
                                scores)
    before = hp.ucgld_pair.launches[hp.variant(observe, scores)]
    out_k, part_k = hp.ucgld_pair(*args, **kw)
    assert hp.ucgld_pair.launches[hp.variant(observe, scores)] == before + 1
    out_t, part_t = hp.ucgld_pair_reference(*args, **kw)
    torch.cuda.synchronize()
    fk = hp.force_out(out_k, part_k, state, cl, params, observe, scores)
    ft = hp.force_out(out_t, part_t, state, cl, params, observe, scores)
    assert_close_fout(fk, ft, ("f", "ucgforce", "scores"), observe)


@pytest.mark.parametrize("name,observe,scores", VARIANTS)
def test_k1_matches_twin_on_flagship(device, name, observe, scores):
    sim = flagship.build_sim(n=32768, device=device)
    assert sim.pair_compute is hp.compute_style
    cl = colpack.build(sim.state.x, sim.state.box, sim.nbr_spec)
    kernel_vs_twin(sim.state, cl, sim.pair_params, observe, scores)


def mixed_system(device, n=8192):
    """2 actual types (plain type 1, 2-state type 2), random positions at
    ρ 0.6, assigned priors."""
    rng = np.random.default_rng(5)
    st = parse_state_settings(MIXED_SETTINGS, "ucgld")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 1, 1, [(soft_table(1.0), 2.5)])
    b.pair_coeff(1, 2, 1, 2, [(soft_table(e), 2.5) for e in (0.8, 0.5)])
    b.pair_coeff(2, 2, 2, 2, [(soft_table(e), 2.5)
                              for e in (0.9, 0.55, 0.55, 0.3)])
    bank, tp = b.build(device=device)
    L = (n / 0.6) ** (1 / 3)
    state = SimState.create(
        x=rng.uniform(0, L, (n, 3)), typ=rng.integers(1, 3, n),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        ucgp=rng.uniform(0.1, 0.9, n),
        box=Box.create([0, 0, 0], [L] * 3, device=device), device=device)
    return bank, tp, state


@pytest.mark.parametrize("name,observe,scores", VARIANTS)
def test_k1_matches_twin_multitype(device, name, observe, scores):
    bank, tp, state = mixed_system(device)
    params = UCGLDParams(bank=bank, tp=tp,
                         kT=torch.tensor(0.8, device=device))
    sel = select_pair_kernel(params, state, 2.5, 0.4)
    assert sel is not None
    _, spec, params = sel
    cl = colpack.build(state.x, state.box, spec)
    kernel_vs_twin(state, cl, params, observe, scores)


@pytest.fixture(scope="module")
def flagship_edges(device):
    """{kind: (state, params, cl)} of the 4,096-bead flagship fluid at
    random positions at the tile walk's edges (EDGE_RHO): dilute, where
    most clusters flush fewer than 32 pairs at the end of their walk;
    compressed, where one step's tests append more than 64 hits; clumped,
    with empty spans and clusters that are mostly pads."""
    sim = flagship.build_sim(n=4096, device=device, kernel=False)
    out = {}
    for kind, rho in EDGE_RHO.items():
        rng = np.random.default_rng(21)
        n = sim.state.n_atoms
        L = (n / rho) ** (1 / 3)
        x = rng.uniform(0.0, L, (n, 3))
        if kind == "clumped":
            x[:, 0] *= 0.4
        state = dataclasses.replace(
            sim.state, x=torch.as_tensor(x, dtype=torch.float32,
                                         device=device),
            box=Box.create([0, 0, 0], [L] * 3, device=device))
        sel = select_pair_kernel(sim.pair_params, state, flagship.RC, 0.4)
        assert sel is not None and sel[0] is hp.compute_style
        _, spec, params = sel
        cl = colpack.build(state.x, state.box, spec)
        assert not bool(cl.overflow)
        out[kind] = (state, params, cl)
    return out


@pytest.mark.parametrize("name,observe,scores", VARIANTS)
@pytest.mark.parametrize("kind", ["dilute", "compressed", "clumped"])
def test_k1_matches_twin_at_the_edges(flagship_edges, kind, name, observe,
                                      scores):
    state, params, cl = flagship_edges[kind]
    kernel_vs_twin(state, cl, params, observe, scores)


@pytest.mark.parametrize("name,observe,scores", VARIANTS)
def test_k1_two_launches_bit_identical(flagship_edges, name, observe,
                                       scores):
    """The tile walk sums in queue order, which the inputs fix."""
    state, params, cl = flagship_edges["compressed"]
    args, kw = hp.kernel_inputs(state, cl, params, params.cheb, observe,
                                scores)
    out_a, part_a = hp.ucgld_pair(*args, **kw)
    out_b, part_b = hp.ucgld_pair(*args, **kw)
    assert torch.equal(out_a, out_b)
    if observe:
        assert torch.equal(part_a, part_b)


def test_k1_rejects_wrong_inputs(device):
    sim = flagship.build_sim(n=32768, device=device)
    cl = colpack.build(sim.state.x, sim.state.box, sim.nbr_spec)
    args, kw = hp.kernel_inputs(sim.state, cl, sim.pair_params,
                                sim.pair_params.cheb, True, True)
    bad = list(args)
    bad[3] = args[3].double()                       # ipack in f64
    with pytest.raises(TypeError):
        hp.ucgld_pair(*bad, **kw)
    bad = list(args)
    bad[4] = args[4][:, :, :-1]                     # non-contiguous cols
    with pytest.raises(ValueError):
        hp.ucgld_pair(*bad, **kw)
    with pytest.raises(ValueError):
        hp.ucgld_pair(*args, **dict(kw, degree=40))


def test_flagship_main_path_runs_through_k1(device):
    sim = flagship.build_sim(n=32768, device=device, reneigh_every=10)
    launches = dict(hp.ucgld_pair.launches)
    sim.run_fused(2)
    row = sim.thermo()
    assert hp.ucgld_pair.launches["full"] >= launches["full"] + 3
    assert hp.ucgld_pair.launches["noscores"] >= launches["noscores"] + 18
    assert row["oob_low"] == 0 and np.isfinite(row["etotal"])
    assert dataclasses.is_dataclass(sim.state)


def k2_vs_twin(state, cl, params, observe):
    args, kw = hb.kernel_inputs(state, cl, params, params.cheb, observe)
    before = hb.bethe_pair.launches[hb.variant(observe)]
    out_k, part_k = hb.bethe_pair(*args, **kw)
    assert hb.bethe_pair.launches[hb.variant(observe)] == before + 1
    out_t, part_t = hb.bethe_pair_reference(*args, **kw)
    torch.cuda.synchronize()
    fk = hb.force_out(out_k, part_k, state, cl, params, observe)
    ft = hb.force_out(out_t, part_t, state, cl, params, observe)
    assert_close_fout(fk, ft, ("f", "scores"), observe)


def bethe_with(sim, method, pseudo):
    params = dataclasses.replace(sim.pair_params, method=method,
                                 pseudo=pseudo)
    return params, colpack.build(sim.state.x, sim.state.box, sim.nbr_spec)


@pytest.mark.parametrize("method,pseudo,observe", BETHE_VARIANTS)
def test_k2_matches_twin_on_bethe_system(device, method, pseudo, observe):
    sim = flagship.build_bethe_sim(n=32768, device=device)
    assert sim.pair_compute is hb.compute_style_bethe
    sim.setup((0, 10))          # priors from ucgp, no longer the sentinel
    params, cl = bethe_with(sim, method, pseudo)
    k2_vs_twin(sim.state, cl, params, observe)


TABLE_STYLES = [("spline", 2000), ("bitmap", 12)]


def styled_params(sim, tabstyle, tablength):
    """``sim``'s pair params with a two-state bank of ``tabstyle`` (the
    deck's soft tables), through the kernel selection: (params, list)."""
    b = TablePairBuilder(tabstyle, tablength, parse_state_settings(
        "1 2 2\n1 2\n1 2\n0.0 0.3\n", "ucgld"))
    b.pair_coeff(1, 1, 2, 2, [(soft_table(e, n=2000), 2.5)
                              for e in (1.0, 0.6, 0.6, 0.25)])
    bank, _ = b.build(device=sim.state.device)
    assert bank.style == tabstyle and not bank.uniform
    params = dataclasses.replace(sim.pair_params, bank=bank, cheb=None)
    sel = select_pair_kernel(params, sim.state, 2.5, 0.4)
    assert sel is not None and sel[0] is sim.pair_compute
    _, spec, params = sel
    assert float(params.cheb.max_rel_err.max()) < 1e-4
    return params, colpack.build(sim.state.x, sim.state.box, spec)


@pytest.mark.parametrize("name,observe,scores", VARIANTS)
@pytest.mark.parametrize("tabstyle,tablength", TABLE_STYLES)
def test_k1_matches_twin_with_table_styles(device, tabstyle, tablength, name,
                                           observe, scores):
    """K1 on SPLINE and BITMAP banks (their Chebyshev fits), 32,768
    beads."""
    sim = flagship.build_sim(n=32768, device=device)
    params, cl = styled_params(sim, tabstyle, tablength)
    kernel_vs_twin(sim.state, cl, params, observe, scores)


@pytest.mark.parametrize("observe", [True, False])
@pytest.mark.parametrize("tabstyle,tablength", TABLE_STYLES)
def test_k2_matches_twin_with_table_styles(device, tabstyle, tablength,
                                           observe):
    """K2 on SPLINE and BITMAP banks, 32,768 beads, priors from ucgp."""
    sim = flagship.build_bethe_sim(n=32768, device=device)
    sim.setup((0, 10))
    params, cl = styled_params(sim, tabstyle, tablength)
    k2_vs_twin(sim.state, cl, params, observe)


@pytest.mark.parametrize("method,pseudo,observe", BETHE_VARIANTS)
def test_k2_matches_twin_multitype(device, method, pseudo, observe):
    bank, tp, state = mixed_system(device)
    params = pair_bethe.make_params(bank, tp, 0.8, method=method,
                                    pseudo=pseudo)
    sel = select_pair_kernel(params, state, 2.5, 0.4)
    assert sel is not None and sel[0] is hb.compute_style_bethe
    _, spec, params = sel
    k2_vs_twin(state, colpack.build(state.x, state.box, spec), params,
               observe)


def test_k2_rejects_wrong_inputs(device):
    sim = flagship.build_bethe_sim(n=32768, device=device)
    cl = colpack.build(sim.state.x, sim.state.box, sim.nbr_spec)
    args, kw = hb.kernel_inputs(sim.state, cl, sim.pair_params,
                                sim.pair_params.cheb, True)
    bad = list(args)
    bad[3] = args[3].double()                       # ipack in f64
    with pytest.raises(TypeError):
        hb.bethe_pair(*bad, **kw)
    bad = list(args)
    bad[5] = args[5][:6]                            # 6 rows: not D-form 8
    with pytest.raises(ValueError):
        hb.bethe_pair(*bad, **kw)
    with pytest.raises(ValueError):
        hb.bethe_pair(*args, **dict(kw, degree=40))


def test_bethe_main_path_runs_through_k2(device):
    sim = flagship.build_bethe_sim(n=32768, device=device)
    launches = dict(hb.bethe_pair.launches)
    sim.run_fused(2)
    row = sim.thermo()
    assert hb.bethe_pair.launches["full"] >= launches["full"] + 3
    assert hb.bethe_pair.launches["fast"] >= launches["fast"] + 8
    assert row["oob_low"] == 0 and np.isfinite(row["etotal"])
    p = sim.state.ucgp
    assert bool(((p >= 1e-6) & (p <= 1 - 1e-6)).all())


@pytest.fixture(scope="module")
def bethe_edges(device):
    """{(kind, multi): (state, params, cl)} of 4,096 beads at random
    positions at the tile walk's edges (EDGE_RHO): the config-3 Bethe fluid
    after setup (one actual type) and the 2-type mixed system (MULTI)."""
    sim = flagship.build_bethe_sim(n=4096, device=device, kernel=False)
    sim.setup((0, 10))          # priors from ucgp, no longer the sentinel
    bank, tp, mixed = mixed_system(device, n=4096)
    out = {}
    for kind, rho in EDGE_RHO.items():
        for multi, base, params in (
                (False, sim.state, sim.pair_params),
                (True, mixed, pair_bethe.make_params(bank, tp, 0.8))):
            rng = np.random.default_rng(21)
            n = base.n_atoms
            L = (n / rho) ** (1 / 3)
            x = rng.uniform(0.0, L, (n, 3))
            if kind == "clumped":
                x[:, 0] *= 0.4
            state = dataclasses.replace(
                base, x=torch.as_tensor(x, dtype=torch.float32,
                                        device=device),
                box=Box.create([0, 0, 0], [L] * 3, device=device))
            sel = select_pair_kernel(params, state, flagship.RC, 0.4)
            assert sel is not None and sel[0] is hb.compute_style_bethe
            _, spec, kparams = sel
            cl = colpack.build(state.x, state.box, spec)
            assert not bool(cl.overflow)
            out[kind, multi] = (state, kparams, cl)
    return out


@pytest.mark.parametrize("method,pseudo,observe", BETHE_VARIANTS)
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("kind", ["dilute", "compressed", "clumped"])
def test_k2_matches_twin_at_the_edges(bethe_edges, kind, multi, method,
                                      pseudo, observe):
    state, params, cl = bethe_edges[kind, multi]
    params = dataclasses.replace(params, method=method, pseudo=pseudo)
    k2_vs_twin(state, cl, params, observe)


@pytest.mark.parametrize("method,pseudo,observe", BETHE_VARIANTS)
@pytest.mark.parametrize("multi", [False, True])
def test_k2_two_launches_bit_identical(bethe_edges, multi, method, pseudo,
                                       observe):
    """The tile walk sums in queue order, which the inputs fix."""
    state, params, cl = bethe_edges["compressed", multi]
    params = dataclasses.replace(params, method=method, pseudo=pseudo)
    args, kw = hb.kernel_inputs(state, cl, params, params.cheb, observe)
    out_a, part_a = hb.bethe_pair(*args, **kw)
    out_b, part_b = hb.bethe_pair(*args, **kw)
    assert torch.equal(out_a, out_b)
    if observe:
        assert torch.equal(part_a, part_b)


# ---- K3-K6: the density-CV styles ----------------------------------------

DENSITY_VARIANTS = [(m, o, s) for m in ("bethe", "mf")
                    for o, s in ((True, True), (False, True), (False, False))]
CV_VARIANTS = [(g, o) for g in hcv.GFORMS for o in (True, False)]


@pytest.fixture(scope="module")
def density_systems(device):
    """The config-4 (P3) and config-5 (P4) systems at 32,768 beads after
    setup, each with a column list."""
    out = {}
    for name, build in (("p3", flagship.build_density_sim),
                        ("p4", flagship.build_rleucg_sim)):
        sim = build(n=32768, device=device)
        sim.setup((0, 10))
        out[name] = (sim, colpack.build(sim.state.x, sim.state.box,
                                        sim.nbr_spec))
    return out


# the edge cases of the compacting walk (K3, K4) and of the tile walk (K1,
# K6): a dilute system, where most warps flush fewer than 32 pairs at the
# end of their walk; a compressed one, where i-slots hold more than 64
# in-cutoff pairs and the queues wrap many times; a clumped one (every bead
# in 40% of the box in x), with empty spans and i-clusters that are mostly
# pads
EDGE_RHO = {"dilute": 0.05, "compressed": 2.0, "clumped": 0.5}


def random_system(sim, rho, clumped=False):
    """(state, params, cl) of ``sim``'s beads at random positions (seed 21)
    at density ``rho``, every bead in 40% of the box in x when
    ``clumped``."""
    device = sim.state.device
    rng = np.random.default_rng(21)
    n = sim.state.n_atoms
    L = (n / rho) ** (1 / 3)
    x = rng.uniform(0.0, L, (n, 3))
    if clumped:
        x[:, 0] *= 0.4
    state = dataclasses.replace(
        sim.state, x=torch.as_tensor(x, dtype=torch.float32, device=device),
        box=Box.create([0, 0, 0], [L] * 3, device=device))
    sel = select_pair_kernel(sim.pair_params, state, flagship.RC, 0.4)
    assert sel is not None
    _, spec, params = sel
    cl = colpack.build(state.x, state.box, spec)
    assert not bool(cl.overflow)
    return state, params, cl


DENSITY_BUILDERS = {"p3": flagship.build_density_sim,
                    "p4": flagship.build_rleucg_sim}


@pytest.fixture(scope="module")
def edge_systems(device):
    """{(style, kind): (state, params, cl)} of 4,096 beads of the P3 or P4
    system at random positions."""
    out = {}
    for style, build in DENSITY_BUILDERS.items():
        sim = build(n=4096, device=device, kernel=False)
        for kind, rho in EDGE_RHO.items():
            out[style, kind] = random_system(sim, rho, kind == "clumped")
    return out


def system_of(density_systems, edge_systems, style, kind):
    """(state, params, cl) of the deck system or of an edge case."""
    if kind == "deck":
        sim, cl = density_systems[style]
        return sim.state, sim.pair_params, cl
    return edge_systems[style, kind]


@pytest.mark.parametrize("kind", list(EDGE_RHO))
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_edge_systems_reach_the_queue_edges(edge_systems, style, kind):
    state, params, cl = edge_systems[style, kind]
    args, kw = (hd.density_inputs(state, cl, params, params.cheb,
                                  torch.zeros_like(state.ucgl), False, False)
                if style == "p3" else
                hr.rleucg_inputs(state, cl, params, params.cheb,
                                 torch.zeros_like(state.ucgl), False))
    per_slot = torch.zeros(args[3].shape[0], device=state.device)
    for sl, *_, mask in hp.span_pairs(*args[:5], mx=kw["mx"], my=kw["my"],
                                      observe=False):
        per_slot[sl] = mask.sum(-1).reshape(-1).float()
    per_warp = per_slot.reshape(-1, 32).sum(1)
    if kind == "dilute":
        assert float((per_warp < 32).float().mean()) > 0.5
    elif kind == "compressed":
        assert float(per_slot.max()) > 64
    else:
        assert bool((args[3][:, 5] < 0.5).any()) and bool((args[2] == 0).any())
        assert float(per_slot.sum()) > 0


def assert_close(a, b, name):
    scale = max(float(b.abs().max()), 1e-30)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=TOL * scale, err_msg=name)


def cv_inputs_of(state, p, cl, weight):
    cutsq = (p.tp.cutsq if isinstance(p, hd.BetheDensityParams)
             else p.cutsq)[1, 1]
    return hcv.cv_inputs(state, cl, p.cv_rad, cutsq, p.bank.innersq[0],
                         weight)


def cv_args(sim, cl, weight):
    return cv_inputs_of(sim.state, sim.pair_params, cl, weight)


def cv_weight(state):
    return torch.randn(state.n_atoms, generator=torch.Generator(
        device=state.device).manual_seed(3), device=state.device)


PLAIN_TYPE = {"p3": 1, "p4": 3}


def k5_vs_twin(args, kw, plain_type):
    """K5 against its twin: ρ within TOL of its scale, n exact, the rows of
    i-slots without a real atom zero, and exactly zero ρ for a plain type
    (its radius floored at 1e-12)."""
    before = hcv.cv_rho.launches["rho"]
    out_k = hcv.cv_rho(*args, **kw)
    assert hcv.cv_rho.launches["rho"] == before + 1
    out_t = hcv.cv_rho_reference(*args, **kw)
    torch.cuda.synchronize()
    assert_close(out_k[:, 0], out_t[:, 0], "rho")
    assert torch.equal(out_k[:, 1], out_t[:, 1])
    ipack = args[3]
    real = ipack[:, 5] > 0.5
    assert bool((out_k[~real] == 0).all())
    plain = (ipack[:, 7] == plain_type) & real
    assert bool(plain.any())
    assert float(out_k[plain, 0].abs().max()) == 0.0
    assert float(out_k[:, 1].sum()) > 0


@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k5_matches_twin(density_systems, style):
    sim, cl = density_systems[style]
    args, kw = cv_args(sim, cl, None)
    k5_vs_twin(args, kw, PLAIN_TYPE[style])


@pytest.mark.parametrize("kind", list(EDGE_RHO))
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k5_matches_twin_at_the_edges(edge_systems, style, kind):
    state, params, cl = edge_systems[style, kind]
    args, kw = cv_inputs_of(state, params, cl, None)
    k5_vs_twin(args, kw, PLAIN_TYPE[style])


@pytest.mark.parametrize("kind", ["deck", *EDGE_RHO])
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k5_two_launches_bit_identical(density_systems, edge_systems, style,
                                       kind):
    state, params, cl = system_of(density_systems, edge_systems, style, kind)
    args, kw = cv_inputs_of(state, params, cl, None)
    assert torch.equal(hcv.cv_rho(*args, **kw), hcv.cv_rho(*args, **kw))


def test_k5_takes_any_number_of_radii(density_systems):
    """K5 reads only the i-slot's radius, so its table may hold more
    entries than K6's 16: 20 radii, type 1 a plain one."""
    sim, cl = density_systems["p3"]
    args, kw = cv_args(sim, cl, None)
    dev = sim.state.device
    rad = torch.linspace(0.9, 1.4, 20, device=dev)
    rad[1] = hcv.R_FLOOR
    ipack = args[3].clone()
    ipack[:, 7] = (torch.arange(ipack.shape[0], device=dev) % 19 + 1).float()
    args = (*args[:3], ipack, args[4], rad)
    k5_vs_twin(args, dict(kw, pertype=True), 1)


@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k5_cluster_count_not_a_multiple_of_the_block(device, style):
    """4,096 beads at ρ 0.2: 1,134 i-clusters, so the last block of K5's
    grid holds fewer clusters than warps."""
    sim = DENSITY_BUILDERS[style](n=4096, device=device, kernel=False)
    state, params, cl = random_system(sim, 0.2)
    args, kw = cv_inputs_of(state, params, cl, None)
    assert (args[3].shape[0] // 8) % 4 != 0
    k5_vs_twin(args, kw, PLAIN_TYPE[style])


@pytest.mark.parametrize("gform,observe", CV_VARIANTS)
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k6_matches_twin(density_systems, style, gform, observe):
    sim, cl = density_systems[style]
    w = torch.randn(sim.state.n_atoms, generator=torch.Generator(
        device=sim.state.device).manual_seed(3), device=sim.state.device)
    args, kw = cv_args(sim, cl, w)
    key = "full" if observe else "fast"
    before = hcv.cv_force.launches[key]
    out_k, part_k = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    assert hcv.cv_force.launches[key] == before + 1
    out_t, part_t = hcv.cv_force_reference(*args, gform=gform,
                                           observe=observe, **kw)
    torch.cuda.synchronize()
    assert_close(out_k, out_t, "force")
    if observe:
        assert_close(part_k.sum(0), part_t.sum(0), "virial")


@pytest.mark.parametrize("gform,observe", CV_VARIANTS)
@pytest.mark.parametrize("kind", list(EDGE_RHO))
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k6_matches_twin_at_the_edges(edge_systems, style, kind, gform,
                                      observe):
    state, params, cl = edge_systems[style, kind]
    args, kw = cv_inputs_of(state, params, cl, cv_weight(state))
    out_k, part_k = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    out_t, part_t = hcv.cv_force_reference(*args, gform=gform,
                                           observe=observe, **kw)
    torch.cuda.synchronize()
    assert_close(out_k, out_t, "force")
    if observe:
        assert_close(part_k.sum(0), part_t.sum(0), "virial")


@pytest.mark.parametrize("gform,observe", CV_VARIANTS)
@pytest.mark.parametrize("style", ["p3", "p4"])
def test_k6_two_launches_bit_identical(density_systems, style, gform,
                                       observe):
    sim, cl = density_systems[style]
    args, kw = cv_args(sim, cl, cv_weight(sim.state))
    out_a, part_a = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    out_b, part_b = hcv.cv_force(*args, gform=gform, observe=observe, **kw)
    assert torch.equal(out_a, out_b)
    if observe:
        assert torch.equal(part_a, part_b)


@pytest.mark.parametrize("kind", ["deck", *EDGE_RHO])
@pytest.mark.parametrize("method,observe,scores", DENSITY_VARIANTS)
def test_k3_matches_twin(density_systems, edge_systems, method, observe,
                         scores, kind):
    state, params, cl = system_of(density_systems, edge_systems, "p3", kind)
    params = dataclasses.replace(params, method=method)
    pi1 = torch.rand(state.n_atoms, device=state.device)
    pi1 = torch.where(state.typ == 2, pi1, torch.zeros_like(pi1))
    args, kw = hd.density_inputs(state, cl, params, params.cheb, pi1,
                                 observe, scores)
    name = hd.variant(observe, scores)
    before = hd.dbethe_pair.launches[name]
    out_k, part_k = hd.dbethe_pair(*args, **kw)
    assert hd.dbethe_pair.launches[name] == before + 1
    out_t, part_t = hd.dbethe_pair_reference(*args, **kw)
    torch.cuda.synchronize()
    for c in range(8):
        assert_close(out_k[:, c], out_t[:, c], f"column {c}")
    if observe:
        assert_close(part_k.sum(0)[:7], part_t.sum(0)[:7], "pe/virial")
        assert int(part_k[:, 7].sum()) == int(part_t[:, 7].sum())


@pytest.mark.parametrize("kind", ["deck", *EDGE_RHO])
@pytest.mark.parametrize("feedback", [True, False])
@pytest.mark.parametrize("observe", [True, False])
def test_k4_matches_twin(density_systems, edge_systems, observe, feedback,
                         kind):
    state, params, cl = system_of(density_systems, edge_systems, "p4", kind)
    params = dataclasses.replace(
        params, feedback="always" if feedback else "never")
    a1 = torch.rand(state.n_atoms, device=state.device)
    a1 = torch.where(state.typ < 3, a1, torch.zeros_like(a1))
    args, kw = hr.rleucg_inputs(state, cl, params, params.cheb, a1, observe)
    before = hr.rleucg_pair.launches[hr.variant(observe)]
    out_k, part_k = hr.rleucg_pair(*args, **kw)
    assert hr.rleucg_pair.launches[hr.variant(observe)] == before + 1
    out_t, part_t = hr.rleucg_pair_reference(*args, **kw)
    torch.cuda.synchronize()
    for c in range(4):
        assert_close(out_k[:, c], out_t[:, c], f"column {c}")
    assert float(out_k[:, 4:].abs().max()) == 0.0
    if observe:
        assert_close(part_k.sum(0)[:7], part_t.sum(0)[:7], "pe/virial")


def test_density_kernels_reject_wrong_inputs(density_systems):
    sim, cl = density_systems["p3"]
    args, kw = cv_args(sim, cl, None)
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError):
        hcv.cv_rho(*bad, **kw)
    bad = list(args)
    bad[5] = args[5][:1]                           # one radius, per-type
    with pytest.raises(ValueError):
        hcv.cv_rho(*bad, **kw)
    with pytest.raises(ValueError):
        hcv.cv_force(*args, gform="x", observe=False, **kw)
    with pytest.raises(ValueError):                # scal on the host
        hcv.cv_rho(args[0].cpu(), *args[1:], **kw)
    pi1 = torch.zeros(sim.state.n_atoms, device=sim.state.device)
    args, kw = hd.density_inputs(sim.state, cl, sim.pair_params,
                                 sim.pair_params.cheb, pi1, True, True)
    with pytest.raises(ValueError):
        hd.dbethe_pair(*args, **dict(kw, degree=40))
    sim4, cl4 = density_systems["p4"]
    args, kw = hr.rleucg_inputs(sim4.state, cl4, sim4.pair_params,
                                sim4.pair_params.cheb, pi1, True)
    with pytest.raises(ValueError):                # K4 needs the pair rows
        hr.rleucg_pair(*args[:5], args[5][1, 1], **kw)


def test_launchers_refuse_more_types_than_the_rows_hold(density_systems):
    """The rows of at most 3 actual types (4 x 4 ordered pairs, 12 KB)
    fit the shared memory the multi-type kernels stage them in: a 5 x 5
    block is refused by the wrappers of K1–K4 (ValueError) and by the C
    entry points of K1–K4 (cudaErrorInvalidValue, 1)."""
    import ctypes

    sim, cl = density_systems["p3"]
    zeros = torch.zeros(sim.state.n_atoms, device=sim.state.device)
    args, kw = hd.density_inputs(sim.state, cl, sim.pair_params,
                                 sim.pair_params.cheb, zeros, False, False)
    deg, (mx, my) = kw["degree"], (kw["mx"], kw["my"])
    big = torch.zeros((5, 5, 8, deg), device=sim.state.device)
    geo = dict(mx=mx, my=my, degree=deg, observe=False)
    for call in (
            lambda: hd.dbethe_pair(*args[:5], big, ucg_mask=kw["ucg_mask"],
                                   mf=False, want_scores=False, **geo),
            lambda: hr.rleucg_pair(*args[:5], big, feedback=True, **geo),
            lambda: hp.ucgld_pair(*args[:5], big, want_scores=True, **geo),
            lambda: hb.bethe_pair(*args[:5], big, ucg_mask=kw["ucg_mask"],
                                  mf=False, sce=False, **geo)):
        with pytest.raises(ValueError):
            call()
    scal, z0, span_len, ipack, cols = args[:5]
    out = torch.empty((ipack.shape[0], 8), device=ipack.device)
    cz, czp = z0.shape[1] * colpack.CL, cols.shape[2]
    ptrs = [scal.data_ptr(), z0.data_ptr(), span_len.data_ptr(),
            ipack.data_ptr(), cols.data_ptr(), big.data_ptr(),
            out.data_ptr(), None]
    geo_c = [ipack.shape[0], mx, my, cz, czp, deg, 5]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    periodic = 3                     # both axes, after the stream
    assert hd._lib()(*ptrs, *geo_c, 0, hd.STYLE_DBETHE, 0, 0, 0, 0, 1,
                     stream, periodic) == 1
    assert hd._lib()(*ptrs, *geo_c, 0, hd.STYLE_RLEUCG, 0, 1, 0, 1, 1,
                     stream, periodic) == 1
    assert hb._lib()(*ptrs, *geo_c, 0, 0, 0, 0, 1, stream, periodic) == 1
    assert hp._lib()(*ptrs, *geo_c, 0, 1, 1, stream, periodic) == 1


@pytest.mark.parametrize("style", ["p3", "p4"])
def test_density_main_paths_run_through_kernels(device, style):
    build = (flagship.build_density_sim if style == "p3"
             else flagship.build_rleucg_sim)
    sim = build(n=32768, device=device)
    pair = hd.dbethe_pair if style == "p3" else hr.rleucg_pair
    fast = "fast_noscores" if style == "p3" else "fast"
    counters = (hcv.cv_rho, hcv.cv_force, pair)
    before = [dict(c.launches) for c in counters]
    sim.run_fused(2)
    d = [{k: c.launches[k] - b[k] for k in b} for c, b in zip(counters,
                                                               before)]
    assert d[0]["rho"] == 21                       # setup + 2 blocks of 10
    assert d[1]["full"] == d[2]["full"] == 3
    assert d[1]["fast"] == d[2][fast] == 18
    row = sim.thermo()
    assert row["oob_low"] == 0 and np.isfinite(row["etotal"])
    if style == "p3":
        p, typ = sim.state.ucgp, sim.state.typ
        assert bool(((p[typ == 2] >= 1e-6) & (p[typ == 2] <= 1 - 1e-6)).all())


def test_k2_unchanged_by_the_style_template(device):
    """On a one-type system with the same priors in both roles, K3 (on the
    compacting walk) gives K2's forces and pseudolikelihood scores: the
    same closed form and series, summed in the same order per i-slot."""
    sim = flagship.build_bethe_sim(n=32768, device=device)
    sim.setup((0, 10))
    state = dataclasses.replace(sim.state, ucgl=sim.state.ucgp)
    cl = colpack.build(state.x, state.box, sim.nbr_spec)
    params = sim.pair_params
    args, kw = hb.kernel_inputs(state, cl, params, params.cheb, False)
    out2, _ = hb.bethe_pair(*args, **kw)
    dparams = hd.BetheDensityParams(bank=params.bank, tp=params.tp,
                                    kT=params.kT, cheb=params.cheb)
    args3, kw3 = hd.density_inputs(state, cl, dparams, params.cheb,
                                   state.ucgp, False, True)
    assert torch.equal(args3[3], args[3]) and torch.equal(args3[4], args[4])
    out3, _ = hd.dbethe_pair(*args3, **kw3)
    for c in (0, 1, 2, 4, 5):
        assert_close(out3[:, c], out2[:, c], f"column {c}")
    out_t, _ = hb.bethe_pair_reference(*args, **kw)
    assert_close(out2, out_t, "K2 vs twin")


# ---- K7 (ablation microbench) and K8 (cluster lists) ---------------------

@pytest.fixture(scope="module")
def k7_inputs(device):
    from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha

    sim = flagship.build_sim(n=32768, device=device)
    cl = colpack.build(sim.state.x, sim.state.box, sim.nbr_spec)
    args, kw = ha.kernel_inputs(sim.state, cl, sim.pair_params,
                                sim.pair_params.cheb)
    return sim, cl, args, kw


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_k7_matches_twin(k7_inputs, level):
    from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha

    _, _, args, kw = k7_inputs
    before = ha.ucgld_ablation.launches[f"L{level}"]
    out_k = ha.ucgld_ablation(*args, **kw, level=level)
    assert ha.ucgld_ablation.launches[f"L{level}"] == before + 1
    out_t = ha.ablation_reference(*args, **kw, level=level)
    torch.cuda.synchronize()
    for c in range(8):
        a, b = out_k[:, c].cpu().numpy(), out_t[:, c].cpu().numpy()
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale,
                                   err_msg=f"column {c}")


def test_k7_level4_is_k1_noscores(k7_inputs):
    from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha

    sim, cl, args, kw = k7_inputs
    k1_args, k1_kw = hp.kernel_inputs(sim.state, cl, sim.pair_params,
                                      sim.pair_params.cheb, False, False)
    k1, _ = hp.ucgld_pair(*k1_args, **k1_kw)
    l4 = ha.ucgld_ablation(*args, **kw, level=4)
    scale = float(k1.abs().max())
    np.testing.assert_allclose(l4.cpu().numpy(), k1.cpu().numpy(), rtol=0,
                               atol=TOL * scale)
    # one definition of the physics on one walk: bit for bit
    assert torch.equal(l4, k1)


def k8_vs_twin(args, kw, cl):
    """K8 (on the list's occupied i-clusters) against its twin: every out
    column within TOL of its scale, pe, the virial and the inner-cutoff
    count of the summed per-slot rows, and the rows of the i-clusters
    without atoms exactly zero.  Returns the kernel's (out, part)."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    before = hc.ucgld_cluster.launches["full"]
    out_k, part_k = hc.ucgld_cluster(*args, **kw, occupied=cl.occupied)
    assert hc.ucgld_cluster.launches["full"] == before + 1
    out_t, part_t = hc.ucgld_cluster_reference(*args, **kw)
    torch.cuda.synchronize()
    for c in range(8):
        a, b = out_k[:, c].cpu().numpy(), out_t[:, c].cpu().numpy()
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale,
                                   err_msg=f"column {c}")
    tk, tt = part_k.double().sum(0).cpu(), part_t.double().sum(0).cpu()
    np.testing.assert_allclose(float(tk[0]), float(tt[0]), rtol=TOL)
    vs = float(tt[1:7].abs().max())
    np.testing.assert_allclose(tk[1:7].numpy(), tt[1:7].numpy(), rtol=0,
                               atol=TOL * vs)
    assert float(tk[7]) == float(tt[7])
    empty = torch.ones(cl.n_clusters, dtype=torch.bool, device=out_k.device)
    empty[cl.occupied.long()] = False
    for rows in (out_k, part_k):
        assert not bool(rows.reshape(cl.n_clusters, -1)[empty].any())
    return out_k, part_k


def test_k8_matches_twin(device):
    from lammps_ucg_dev_tpu_torch.ops import clusters
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    sim = flagship.build_cluster_sim(n=32768, device=device)
    state, params = sim.state, sim.pair_params
    cl = clusters.build(state.x, state.box, sim.nbr_spec)
    assert not bool(cl.overflow)
    args, kw = hc.kernel_inputs(state, cl, params, params.cheb)
    k8_vs_twin(args, kw, cl)
    bad = list(args)
    bad[1] = args[1].double()                       # apack in f64
    with pytest.raises(TypeError):
        hc.ucgld_cluster(*bad, **kw, occupied=cl.occupied)
    with pytest.raises(ValueError):                 # no occupied list
        hc.ucgld_cluster(*args, **kw)


def test_k8_matches_twin_in_a_box_of_three_cells(device):
    """3 cells a side (512 beads, L 9.49): clusters reach wider than
    0.49 L - rc, where K8 takes the image per pair, not per candidate."""
    sim = flagship.build_cluster_sim(n=512, device=device)
    assert sim.nbr_spec.cells_per_side == (3, 3, 3)
    args, kw, cl = k8_inputs(sim.state, sim.pair_params, sim.nbr_spec)
    k8_vs_twin(args, kw, cl)


@pytest.fixture(scope="module")
def cluster_edges(device):
    """{kind: (state, params, spec)}: 4,096 beads of the flagship fluid at
    random positions at the tile walk's edges (EDGE_RHO), with a cluster
    spec whose cells hold the clump's density when clumped."""
    from lammps_ucg_dev_tpu_torch.ops import clusters

    sim = flagship.build_cluster_sim(n=4096, device=device)
    out = {}
    for kind, rho in EDGE_RHO.items():
        rng = np.random.default_rng(21)
        n = sim.state.n_atoms
        L = (n / rho) ** (1 / 3)
        x = rng.uniform(0.0, L, (n, 3))
        if kind == "clumped":
            x[:, 0] *= 0.4
        state = dataclasses.replace(
            sim.state, x=torch.as_tensor(x, dtype=torch.float32,
                                         device=device),
            box=Box.create([0, 0, 0], [L] * 3, device=device))
        spec = clusters.make_spec(int(n / 0.4) if kind == "clumped" else n,
                                  [L] * 3, flagship.RC, 0.4)
        out[kind] = (state, sim.pair_params, spec)
    return out


def k8_inputs(state, params, spec, **spec_kw):
    """(args, kw, cl) of K8 on a fresh cluster list of ``state``."""
    from lammps_ucg_dev_tpu_torch.ops import clusters
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    cl = clusters.build(state.x, state.box,
                        dataclasses.replace(spec, **spec_kw))
    args, kw = hc.kernel_inputs(state, cl, params, params.cheb)
    return args, kw, cl


@pytest.mark.parametrize("kind", ["dilute", "compressed", "clumped"])
def test_k8_matches_twin_at_the_edges(cluster_edges, kind):
    args, kw, cl = k8_inputs(*cluster_edges[kind])
    assert not bool(cl.overflow)
    k8_vs_twin(args, kw, cl)


def test_k8_rows_of_pads_and_rows_filled_to_kc(cluster_edges):
    """A row that holds only pads (its i-cluster still has atoms) walks
    nothing; a row filled to KC, with no pad to stop at, walks all of it."""
    args, kw, cl = k8_inputs(*cluster_edges["compressed"])
    jcl = args[2].clone()
    first = cl.occupied[:5].long()
    jcl[first] = cl.n_clusters
    out, part = k8_vs_twin((*args[:2], jcl, args[3]), kw, cl)
    assert not bool(out.reshape(cl.n_clusters, -1)[first].any())
    assert not bool(part.reshape(cl.n_clusters, -1)[first].any())
    # a KC of 16 overflows: many rows hold 16 real entries, the first 16
    args, kw, cl = k8_inputs(*cluster_edges["compressed"], kc=16)
    assert bool((cl.jcl < cl.n_clusters).all(1).any())
    k8_vs_twin(args, kw, cl)


def test_k8_two_launches_bit_identical(cluster_edges):
    """Sums in queue order, which the inputs fix."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    args, kw, cl = k8_inputs(*cluster_edges["compressed"])
    out_a, part_a = hc.ucgld_cluster(*args, **kw, occupied=cl.occupied)
    out_b, part_b = hc.ucgld_cluster(*args, **kw, occupied=cl.occupied)
    assert torch.equal(out_a, out_b) and torch.equal(part_a, part_b)


def test_cluster_path_runs_through_k8_and_refuses_unsupported(device):
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    sim = flagship.build_cluster_sim(n=32768, device=device,
                                     reneigh_every=10)
    before = hc.ucgld_cluster.launches["full"]
    sim.run_fused(2)
    assert hc.ucgld_cluster.launches["full"] >= before + 21
    row = sim.thermo()
    assert row["oob_low"] == 0 and np.isfinite(row["etotal"])
    with pytest.raises(ValueError):                 # float64
        flagship.build_cluster_sim(n=32768, device=device,
                                   dtype=torch.float64)
    with pytest.raises(ValueError):                 # 2 cells a side
        flagship.build_cluster_sim(n=128, device=device)


# ---- the slot-major interior on the card ----------------------------------------

SLOT_STYLES = {
    "ucgld_ld": (lambda **kw: flagship.build_sim(reneigh_every=10, **kw),
                 None),
    "ucgld_default": (lambda **kw: flagship.build_sim(reneigh_every=10, **kw),
                      "default"),
    "bethe": (flagship.build_bethe_sim, None),
    "p3": (flagship.build_density_sim, None),
    "p4": (flagship.build_rleucg_sim, None),
}


def launch_counts():
    wrappers = (hp.ucgld_pair, hb.bethe_pair, hd.dbethe_pair, hr.rleucg_pair,
                hcv.cv_rho, hcv.cv_force)
    return [dict(w.launches) for w in wrappers]


@pytest.mark.parametrize("style", list(SLOT_STYLES))
def test_slot_interior_identical_bits_on_the_card(device, style):
    """Two blocks slot-major and atom-ordered from the same state and
    generator seed: the same bits in every dynamic field and in f, the
    λ-force and pe, and the same kernel launches; UCG-LD's interior runs
    K1 without scores under ``ucgstate ld`` and with them under
    ``default``."""
    from lammps_ucg_dev_tpu_torch.fixes import ucgstate as tfs

    build, mode = SLOT_STYLES[style]
    got = []
    for slot in (True, False):
        sim = build(n=8192, device=device)
        if mode is not None:
            sim.cfg = dataclasses.replace(sim.cfg,
                                          ucgstate=tfs.UCGStateCfg(mode=mode))
        assert sim._slot_ok
        sim._slot_ok = slot
        window = (0, 2 * sim.cfg.reneigh_every)
        sim.setup(window)
        before = launch_counts()
        sim.run_fused(2, run_window=window)
        after = launch_counts()
        used = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        st, fo = sim.state, sim._fcarry
        got.append(({f: getattr(st, f) for f in
                     ("x", "v", "ucgl", "ucgvl", "ucgp", "ucgstate")}
                    | {"f": fo.f, "ucgforce": fo.ucgforce, "pe": fo.pe},
                    used))
    (a, la), (b, lb) = got
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert la == lb and any(v for d in la for v in d.values())
    if style.startswith("ucgld"):
        k1 = la[0]
        interior = "noscores" if style == "ucgld_ld" else "fast"
        other = "fast" if style == "ucgld_ld" else "noscores"
        assert k1[interior] > 0 and k1[other] == 0, k1


@pytest.mark.parametrize("kind", ["deck", "dilute", "clumped"])
def test_pack_slots_matches_pack_on_the_card(device, kind):
    """cols and ipack's valid rows bit for bit, on the P3 deck system at
    8,192 beads and at random positions at ρ 0.05 and clumped."""
    rng = np.random.default_rng(8)
    sim = flagship.build_density_sim(n=8192, device=device)
    if kind == "deck":
        state = sim.state
        cl = colpack.build(state.x, state.box, sim.nbr_spec)
    else:
        state, _, cl = random_system(sim, EDGE_RHO[kind], kind == "clumped")
    assert not bool(cl.overflow)
    n = state.n_atoms
    lam = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                          device=device)
    aux = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                          device=device)
    ipack, cols = colpack.pack(cl, state.box, state.x, lam, state.ucgstate,
                               aux=aux, typ=state.typ)
    sar = colpack.slot_atom_real(cl, n)

    def slot(a, pad):
        return torch.cat([a, torch.full((1, *a.shape[1:]), pad,
                                        dtype=a.dtype, device=device)])[sar]

    s_ipack, s_cols = colpack.pack(
        cl, state.box, slot(state.x, colpack._PAD_POISON), slot(lam, 0.0),
        slot(state.ucgstate, 0), aux=slot(aux, 0.5), typ=slot(state.typ, 1),
        slot=True)
    assert torch.equal(s_cols, cols)
    assert torch.equal(s_ipack[cl.i_valid], ipack[cl.i_valid])


# ---- the topology slice on the card ----------------------------------------

@pytest.mark.parametrize("style", ["ucgld", "bethe"])
def test_molecular_kernel_path_matches_the_cpu_twin(device, style):
    """The molecular trimers' setup pass (K1 or K2 over every pair, minus
    ``excl_delta``, plus the bonded terms) on the card against the same
    pass through the kernel's twin on the CPU."""
    kern = hp.ucgld_pair if style == "ucgld" else hb.bethe_pair
    before = sum(kern.launches.values())
    sims = [flagship.build_molecular_sim(nmol=400, device=d, style=style,
                                         kernel=True) for d in (device, "cpu")]
    for s in sims:
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
        assert s._excl_rows_static is not None and not s._slot_ok
    fk, ft = (s.setup((0, 10)) for s in sims)
    assert sum(kern.launches.values()) == before + 1
    assert_close_fout(fk, ft, ("f", "ucgforce", "scores"), True)
    assert int(fk.oob_low) == int(ft.oob_low)


def test_bonded_terms_on_the_card(device):
    """``bonded.compute`` of the tetramer deck (bonds, angles, dihedrals,
    impropers) in float64 on the card against the CPU: the same formulas,
    another scatter order."""
    from lammps_ucg_dev_tpu_torch.models import bonded

    sims = [flagship.build_tetramer_sim(nmol=512, dtype=torch.float64,
                                        kernel=False, device=d)
            for d in (device, "cpu")]
    (fg, pg, vg), (fc, pc, vc) = (bonded.compute(s.state, s.bonded)
                                  for s in sims)
    scale = float(fc.abs().max())
    assert float((fg.cpu() - fc).abs().max()) <= 1e-12 * scale
    assert abs(float(pg) - float(pc)) <= 1e-12 * abs(float(pc))
    assert float((vg.cpu() - vc).abs().max()) <= 1e-12 * float(vc.abs().max())


def test_cluster_switch_event_on_the_card(device):
    """Config 4's event on the column path, on the card and on the CPU,
    with the same draws: the same types and 7-stat vector (labels are
    integers; the contacts come from the same f32 positions)."""
    sims = [flagship.build_density_sim(n=4096, device=d, kernel=True,
                                       cluster_switch=True)
            for d in (device, "cpu")]
    u = torch.rand(4097, generator=torch.Generator().manual_seed(5))
    out = [s._cswitch_event(s.state, s.cswitch_stats, u.to(s.state.device))
           for s in sims]
    (sg, vg, ig), (sc, vc, ic) = out
    assert ig["converged"] and ic["converged"]
    assert ig["sweeps"] == ic["sweeps"]
    assert torch.equal(sg.typ.cpu(), sc.typ)
    assert torch.equal(vg.v.cpu(), vc.v)


# ---- the deck entry point --------------------------------------------------

@pytest.mark.parametrize("deck", ["ucgld", "bethe"])
def test_deck_selects_and_launches_its_kernel(device, tmp_path, deck):
    """A UCG-LD and a Bethe deck at 32,768 beads through ``ScriptRunner``
    on the card: the kernel path is selected (one log line names it) and
    launched, the thermo rows stay finite."""
    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    if deck == "ucgld":
        path = make_deck.write_ucgld_deck(str(tmp_path), n=32768, nsteps=20,
                                          thermo_every=10)
        entry, wrapper, name = hp.compute_style, hp.ucgld_pair, "K1"
    else:
        path = make_deck.write_bethe_deck(str(tmp_path), n=32768, nsteps=20,
                                          thermo_every=10)
        entry, wrapper, name = hb.compute_style_bethe, hb.bethe_pair, "K2"
    logs = []
    r = ScriptRunner(workdir=str(tmp_path), log_callback=logs.append)
    before = sum(wrapper.launches.values())
    r.run_file(path)
    assert r.sim.pair_compute is entry and r.sim._slot_ok
    assert [m for m in logs if m.startswith("pair path:")] == [
        f"pair path: {r.pair_path}"] and name in r.pair_path
    assert sum(wrapper.launches.values()) >= before + 20
    assert r.state.x.is_cuda and len(r.thermo_rows) == 3
    for row in r.thermo_rows:
        assert np.isfinite(row["etotal"]) and row["oob_low"] == 0



def test_density_deck_with_exclusions_raises(device, tmp_path):
    """A config-4 deck with bonds and ``special_bonds lj 0 0 0``, which
    used to raise on the card, runs there on K5 -> K3 -> K6 with the
    density ``excl_delta`` (the specials subtracted pass by pass), and its
    step-0 pe is within 1e-6 of the float64 reference path's on the CPU,
    whose list leaves the specials out."""
    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    path = make_deck.add_bonds(make_deck.write_bethe_density_deck(
        str(tmp_path), n=4096, nsteps=0), nbonds=64)
    before = dict(hd.dbethe_pair.launches)
    r = ScriptRunner(workdir=str(tmp_path), log_callback=lambda m: None)
    r.run_file(path)
    assert r.sim.pair_compute is hd.compute_style_density
    assert r.sim._excl_route == "rows"
    assert r.sim._excl_rows_static is not None
    assert hd.dbethe_pair.launches["full"] > before["full"]
    ref = ScriptRunner(workdir=str(tmp_path), dtype=torch.float64,
                       device="cpu", log_callback=lambda m: None)
    ref.run_file(path)
    assert ref.sim._excl_rows_static is None
    pe_k, pe_r = r.thermo_rows[0]["pe"], ref.thermo_rows[0]["pe"]
    assert abs(pe_k - pe_r) <= 1e-6 * abs(pe_r), (pe_k, pe_r)


def test_native_dump_writer_loads(device, tmp_path):
    from lammps_ucg_dev_tpu_torch.io import dump as dmp
    from lammps_ucg_dev_tpu_torch.runtime import native

    assert native.get_lib() is not None
    sim = flagship.build_sim(n=4096, device=device)
    w = dmp.DumpWriter(str(tmp_path / "t.lammpstrj"))
    assert w.write(sim.state) and w.native_frames == 1
    snap = dmp.read_dump(str(tmp_path / "t.lammpstrj"))[0]
    assert snap.n_atoms == 4096
