"""The port's systems, built from numpy draws so that the JAX package can be
built from the same arrays.

* :func:`build_sim` — the flagship 2-state UCG-LD fluid (port of
  ``__graft_entry__._build_sim``): one actual type with two states at
  ρ = 0.6, ``pair_style table_ucgld`` with cosine-soft LINEAR tables
  (rc = 2.5), ``fix nve/ucgld/wall/hard`` with the bias potential,
  ``fix ucgld/langevin`` and ``fix ucgstate ld``.  The numpy draws are those
  of ``_build_sim``, in the same order (``default_rng(11)``: x, then v,
  ucgl, ucgstate and ucgvl), so both packages start from the identical
  state.
* :func:`build_cluster_sim` — the same fluid on the cluster-list path
  (kernel K8, ``csrc/ucgld_cluster.cu``): the JAX package's round-1
  cluster lists (``attic/clusters.py``) and its cluster-list kernel
  (``attic/pallas_ucgld.py``), full on every step.
* :func:`build_bethe_sim` — the self-consistent Bethe fluid, the config-3
  system of ``examples/make_deck.py:write_bethe_deck`` at its published
  settings: ``pair_style table_ucg_bethe linear 1200 ... method bethe
  pseudo yes prior chemical_potential``, ρ = 0.5, T = 0.8,
  ``fix nve/ucgld``, ``fix ucgld/langevin 0.8 0.8 0.5`` and
  ``fix ucgstate`` in its default mode; its arrays come from
  :func:`bethe_arrays`.
* :func:`build_density_sim` — the config-4 density-CV system of
  ``examples/make_deck.py:write_bethe_density_deck`` at its published
  settings (P3): plain type 1 and the 2-state density-CV type 2 (70%),
  ``table_ucg_bethe_density linear 1200`` over 7 tables, ρ 0.5, T 0.8,
  ``fix nve/ucgld`` and ``ucgld/langevin 0.8 0.8 0.5``, dt 0.002, skin
  0.4, reneighbour every 10; with ``cluster_switch=True`` also the deck's
  ``fix cluster_switch`` (one molecule per bead).  Its arrays come from
  :func:`density_arrays`.
* :func:`build_rleucg_sim` — the config-5 interface system of
  ``write_rleucg_deck`` (P4): substate types 1/2 (one 2-state density
  actual type, 70% drawn as type 1) and 3 (plain),
  ``table_rleucg_interface linear 1200`` over 6 tables, ρ 0.5, T 0.8,
  ``fix nve/ucgld/wall/hard bias_potential 0.1`` and ``ucgld/langevin
  0.8 0.8 0.5``, dt 0.002, skin 0.4, reneighbour every 10.  Its arrays
  come from :func:`rleucg_arrays`.
* :func:`build_molecular_sim` — the molecular UCG-LD deck
  ``write_molecular_ucgld_deck``: bent trimers of one 2-state type with
  harmonic bonds and angles and the 1-2/1-3 special exclusions; its arrays
  come from :func:`molecular_arrays`.  ``style="bethe"`` puts the same
  trimers under config 3's ``table_ucg_bethe``.  :func:`build_respa_sim`
  is the same system under NVE with stiff bonds and two-level r-RESPA (the
  shape of the JAX package's ``tests/test_bonded.py:202``).
* :func:`build_tetramer_sim` — ``write_molecular_tetramer_deck``: chains
  of four with bonds, angles, dihedrals, impropers and 1-2/1-3/1-4
  exclusions (:func:`tetramer_arrays`).
* :func:`build_switch_sim` — ``write_molecular_switch_deck``: linear
  trimers of two plain types under ``fix cluster_switch``, whole molecules
  switching (:func:`switch_arrays`); the reference pair path (K1 takes
  systems with a 2-state type only).

All build on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without CUDA they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import (Box, SimState, System,
                                                resolve_device)
from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as fcs
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.io.table_io import RLINEAR, RawTable
from lammps_ucg_dev_tpu_torch.models import (bonded, pair_bethe,
                                             pair_bethe_density, pair_rleucg,
                                             pair_ucgld)
from lammps_ucg_dev_tpu_torch.models.typemap import (RLEUCGBuilder,
                                                     TablePairBuilder)
from lammps_ucg_dev_tpu_torch.ops import chebtab, clusters, hopper_cluster
from lammps_ucg_dev_tpu_torch.ops import neighbor as nb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.runtime.sim import SimConfig, Simulation

RC = 2.5
TWO_STATE_SETTINGS = "1 2 2\n1 2\n1 2\n0.0 0.3\n"
EPS = (1.0, 0.6, 0.6, 0.25)         # e00, e01, e10, e11
# config 4: plain type 1; type 2 with formal types 2/3, density CV and
# entropy, ρ* 6.0, R 1.5, μ (0.0, 0.2)
DENSITY_SETTINGS = "2 3 2\n1 1\n2 2\n2 3 density entropy\n6.0 1.5\n0.0 0.2\n"
# config 5: actual type 1 = substates 1/2 (density, entropy, ρ* 5.0, R 1.5,
# μ 0.4), actual type 2 = substate 3
RLEUCG_SETTINGS = "2 3\n2 density use_entropy\n5.0 1.5\n0.4\n1 density no_entropy\n"


def soft_table(eps: float, n: int, rlo: float = 1e-3) -> RawTable:
    """Cosine-soft raw table: E = eps (1 + cos(pi r/rc)) on [rlo, rc]."""
    r = np.linspace(rlo, RC, n)
    e = eps * (1 + np.cos(np.pi * r / RC))
    f = eps * np.pi / RC * np.sin(np.pi * r / RC)
    return RawTable(r=r, e=e, f=f, rflag=RLINEAR, rlo=rlo, rhi=RC)


def _pair_path(params, state, n, L, skin, kernel, reference_fn,
               method: str | None = None, capacity: int | None = None):
    """(pair_fn, spec, params): the kernel path when ``select_pair_kernel``
    takes it, else the reference path on an nsq or cell list (``method``;
    None is the JAX package's choice: cell for n > 512 with >= 3 cells a
    side)."""
    sel = select_pair_kernel(params, state, RC, skin, force=kernel)
    if sel is not None:
        return sel
    if n >= 65536 and n % 16384 == 0:
        # bound the reference path's (rows, K, 2, 2) working set
        params = dataclasses.replace(params, chunk=16384)
    return reference_fn, nb.make_spec(n, [L] * 3, RC, skin, method=method,
                                      capacity=capacity), params


def _flagship(n: int, dtype, device, rho: float):
    """(L, state, params) of the flagship fluid from ``default_rng(11)``."""
    rng = np.random.default_rng(11)
    L = (n / rho) ** (1 / 3)
    x = rng.uniform(0, L, (n, 3))

    st = parse_state_settings(TWO_STATE_SETTINGS, "ucgld")
    b = TablePairBuilder("linear", 1000, st)
    b.pair_coeff(1, 1, 2, 2, [(soft_table(e, 1200), RC) for e in EPS])
    bank, tp = b.build(dtype=dtype, device=device)

    state = SimState.create(
        x=x, v=rng.normal(0, 0.9, (n, 3)), typ=np.ones(n, np.int32),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        ucgvl=rng.normal(0, 0.3, n), ucgml=np.full(n, 5.0),
        box=Box.create([0, 0, 0], [L, L, L], dtype=dtype, device=device),
        dtype=dtype, device=device)
    params = pair_ucgld.UCGLDParams(
        bank=bank, tp=tp, kT=torch.tensor(0.8, dtype=dtype, device=device))
    return L, state, params


def _flagship_sim(n, state, pair_fn, params, spec, reneigh_every):
    system = System(n_atoms=n, ntypes=1, masses=np.array([0.0, 1.0]))
    cfg = SimConfig(
        dt=0.004, units="lj",
        integrator=fi.IntegratorCfg("nve/ucgld/wall/hard",
                                    bias_potential=True, barrier=0.1),
        langevin=fl.LangevinCfg(t_start=0.8, t_stop=0.8, t_period=0.5),
        ucgstate=fs.UCGStateCfg(mode="ld"), reneigh_every=reneigh_every)
    return Simulation(system, state, pair_fn, params, spec, cfg)


def build_sim(n: int = 256, dtype=torch.float32, device="cuda",
              reneigh_every: int = 5, kernel: bool | None = None,
              rho: float = 0.6, skin: float = 0.4) -> Simulation:
    """``kernel``: run the pair step through K1 (ops/hopper_pair.py) —
    None = auto (CUDA device, f32, eligible geometry), True = force the
    selection (on CPU tensors the wrapper then runs the kernel's twin),
    False = the reference pair path on an nsq or cell neighbor list."""
    device = resolve_device(device)
    L, state, params = _flagship(n, dtype, device, rho)
    pair_fn, spec, params = _pair_path(params, state, n, L, skin, kernel,
                                       pair_ucgld.compute)
    return _flagship_sim(n, state, pair_fn, params, spec, reneigh_every)


CLUSTER_CHUNK = 32768   # i-clusters per candidate block of a cluster build


def build_cluster_sim(n: int = 512, dtype=torch.float32, device="cuda",
                      reneigh_every: int = 20, rho: float = 0.6,
                      skin: float = 0.4) -> Simulation:
    """The flagship fluid of :func:`build_sim` (the same draws) on K8's
    path: a cell-padded cluster list (ops/clusters.py) rebuilt every
    ``reneigh_every`` steps and the cluster-list kernel
    (ops/hopper_cluster.py), whose one variant is full, on every step.
    On a CUDA device K8 launches; on the CPU its wrapper runs the kernel's
    twin.  Raises (never falls back to K1 or the reference path) when K8
    does not take the system: float64, a bank K8 does not support or the
    Chebyshev fit misses 1e-4, or fewer than 3 cells on a side."""
    device = resolve_device(device)
    if dtype != torch.float32:
        raise ValueError("K8 computes in float32")
    L, state, params = _flagship(n, dtype, device, rho)
    if not hopper_cluster.supports(params):
        raise ValueError("K8 does not support this system")
    cheb = chebtab.fit_bank(params.bank)
    if float(cheb.max_rel_err.max()) >= 1e-4:
        raise ValueError("the Chebyshev fit misses K8's 1e-4 gate")
    spec = clusters.make_spec(n, [L] * 3, RC, skin, chunk=CLUSTER_CHUNK)
    params = dataclasses.replace(params, cheb=cheb)
    return _flagship_sim(n, state, hopper_cluster.compute_style_cluster,
                         params, spec, reneigh_every)


def bethe_arrays(n: int, seed: int = 11) -> dict:
    """The config-3 system's numpy draws (``write_bethe_deck``, ρ 0.5,
    T 0.8): a jittered simple-cubic lattice in a cube of side (n/ρ)^(1/3)
    (``lattice_positions`` with its own ``default_rng(seed)``), wrapped into
    the box; then from ``default_rng(seed)`` λ uniform in [0.3, 0.7] with
    state = (λ > 0.5), and velocities N(0, T) per component with the net
    momentum removed.  λ-mass 5, λ-velocity 0; ucgp stays at the -1
    sentinel."""
    L, x = _lattice(n, seed)
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.3, 0.7, n)
    return {"L": L, "x": x, "v": _velocities(rng, n), "ucgl": lam,
            "ucgstate": (lam > 0.5).astype(np.int32),
            "ucgml": np.full(n, 5.0), "typ": np.ones(n, np.int32)}


DECK_RHO, DECK_T = 0.5, 0.8      # configs 3-5


def lattice_positions(n: int, L: float, jitter: float, seed: int):
    """The decks' ``lattice_positions``: a simple-cubic lattice of
    ceil(n^(1/3))^3 sites truncated to n in a cube of side L, jittered by
    N(0, jitter) draws from its own ``default_rng(seed)``; not wrapped."""
    m = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    return ((grid + 0.5) * (L / m)
            + np.random.default_rng(seed).normal(0, jitter, (n, 3)))


def _lattice(n: int, seed: int):
    """(L, x): :func:`lattice_positions` at ρ 0.5, jitter 0.05, wrapped
    into the box."""
    L = (n / DECK_RHO) ** (1 / 3)
    return L, np.mod(lattice_positions(n, L, 0.05, seed), L)


def _velocities(rng, n: int):
    """N(0, T) per component with the net momentum removed."""
    v = rng.normal(0.0, np.sqrt(DECK_T), (n, 3))
    return v - v.mean(axis=0)


def _deck_arrays(n: int, seed: int, first: int, other: int) -> dict:
    """Configs 4 and 5: the lattice, then from ``default_rng(seed)`` the
    types (``first`` with probability 0.7, else ``other``) as the deck
    draws them, then the velocities; state 0, λ 0.5, λ-mass 5 and one
    molecule per bead as in the decks' data files; ucgp stays at the -1
    sentinel."""
    L, x = _lattice(n, seed)
    rng = np.random.default_rng(seed)
    typ = np.where(rng.uniform(size=n) < 0.7, first, other).astype(np.int32)
    return {"L": L, "x": x, "v": _velocities(rng, n),
            "ucgl": np.full(n, 0.5), "ucgstate": np.zeros(n, np.int32),
            "ucgml": np.full(n, 5.0), "typ": typ,
            "mol": np.arange(1, n + 1, dtype=np.int32)}


def density_arrays(n: int, seed: int = 13) -> dict:
    """The config-4 system's numpy draws (``write_bethe_density_deck``)."""
    return _deck_arrays(n, seed, 2, 1)


def rleucg_arrays(n: int, seed: int = 17) -> dict:
    """The config-5 system's numpy draws (``write_rleucg_deck``)."""
    return _deck_arrays(n, seed, 1, 3)


def _state(a: dict, dtype, device) -> SimState:
    L = a["L"]
    return SimState.create(
        x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
        ucgstate=a["ucgstate"], ucgml=a["ucgml"], mol=a.get("mol"),
        box=Box.create([0, 0, 0], [L, L, L], dtype=dtype, device=device),
        dtype=dtype, device=device)


def build_bethe_sim(n: int = 512, dtype=torch.float32, device="cuda",
                    reneigh_every: int = 5,
                    kernel: bool | None = None) -> Simulation:
    """The config-3 self-consistent Bethe fluid (``method bethe pseudo yes
    prior chemical_potential``, skin 0.4).  ``kernel`` as in
    :func:`build_sim`, selecting K2 (ops/hopper_bethe.py)."""
    device = resolve_device(device)
    a = bethe_arrays(n)
    L = a["L"]
    st = parse_state_settings(TWO_STATE_SETTINGS, "bethe")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 2, 2, [(soft_table(e, 2000), RC) for e in EPS])
    bank, tp = b.build(dtype=dtype, device=device)
    state = _state(a, dtype, device)
    params = pair_bethe.make_params(bank, tp, 0.8,
                                    prior_mode="chemical_potential",
                                    dtype=dtype)
    pair_fn, spec, params = _pair_path(params, state, n, L, 0.4, kernel,
                                       pair_bethe.compute)
    system = System(n_atoms=n, ntypes=1, masses=np.array([0.0, 1.0]))
    cfg = SimConfig(
        dt=0.002, units="lj", integrator=fi.IntegratorCfg("nve/ucgld"),
        langevin=fl.LangevinCfg(t_start=0.8, t_stop=0.8, t_period=0.5),
        ucgstate=fs.UCGStateCfg(mode="default"), reneigh_every=reneigh_every)
    return Simulation(system, state, pair_fn, params, spec, cfg)


def _deck_cfg(integrator: fi.IntegratorCfg,
              reneigh_every: int) -> SimConfig:
    return SimConfig(
        dt=0.002, units="lj", integrator=integrator,
        langevin=fl.LangevinCfg(t_start=DECK_T, t_stop=DECK_T, t_period=0.5),
        reneigh_every=reneigh_every)


DENSITY_SWITCH = dict(contacts=[(2, 2)], atomtypes_on=[2], atomtypes_off=[1],
                      probON=0.5, cutoff=1.3, mol_seed=1, mol_offset=0)
SWITCH_FREQ = 20     # rateFreq of the decks' fix cluster_switch


def build_density_sim(n: int = 512, dtype=torch.float32, device="cuda",
                      reneigh_every: int = 10, kernel: bool | None = None,
                      cluster_switch: bool = False) -> Simulation:
    """The config-4 density-CV system (P3).  ``kernel`` as in
    :func:`build_sim`, selecting K5, K3 and K6 (ops/hopper_density.py).
    ``cluster_switch``: the deck's ``fix cluster_switch 1 0 1.3 16
    rateFreq 20`` (probON 0.5, ON type 2, OFF type 1, contacts (2, 2),
    maxmol n), with ``max_sweeps`` n + 1 as the deck runner passes: a
    label moves one contact a sweep, so that always reaches the fixpoint
    (``make_params``' default 64 is outgrown by a spanning cluster)."""
    device = resolve_device(device)
    a = density_arrays(n)
    st = parse_state_settings(DENSITY_SETTINGS, "bethe_density")
    b = TablePairBuilder("linear", 1200, st)

    def tab(e):
        return (soft_table(e, 2000), RC)

    b.pair_coeff(1, 1, 1, 1, [tab(1.0)])
    b.pair_coeff(1, 2, 1, 2, [tab(0.8), tab(0.5)])
    b.pair_coeff(2, 2, 2, 2, [tab(0.9), tab(0.55), tab(0.55), tab(0.3)])
    bank, tp = b.build(dtype=dtype, device=device)
    state = _state(a, dtype, device)
    params = pair_bethe_density.make_params(bank, tp, DECK_T, dtype=dtype)
    pair_fn, spec, params = _pair_path(params, state, n, a["L"], 0.4, kernel,
                                       pair_bethe_density.compute)
    system = System(n_atoms=n, ntypes=2, masses=np.array([0.0, 1.0, 1.0]))
    cfg = _deck_cfg(fi.IntegratorCfg("nve/ucgld"), reneigh_every)
    cs = None
    if cluster_switch:
        cs = (fcs.make_params(
            ntypes=2, maxmol=n, dtype=dtype, device=device,
            max_sweeps=n + 1, **DENSITY_SWITCH), SWITCH_FREQ)
    return Simulation(system, state, pair_fn, params, spec, cfg,
                      cluster_switch=cs)


def build_rleucg_sim(n: int = 512, dtype=torch.float32, device="cuda",
                     reneigh_every: int = 10,
                     kernel: bool | None = None) -> Simulation:
    """The config-5 RLE-UCG interface system (P4).  ``kernel`` as in
    :func:`build_sim`, selecting K5, K4 and K6 (ops/hopper_rleucg.py)."""
    device = resolve_device(device)
    a = rleucg_arrays(n)
    st = parse_state_settings(RLEUCG_SETTINGS, "rleucg")
    b = RLEUCGBuilder("linear", 1200, st)
    for i, j, e in ((1, 1, 1.0), (1, 2, 0.7), (1, 3, 0.8), (2, 2, 0.4),
                    (2, 3, 0.5), (3, 3, 0.9)):
        b.pair_coeff(i, j, soft_table(e, 2000), RC)
    params = pair_rleucg.make_params(b, st, DECK_T, dtype=dtype,
                                     device=device)
    state = _state(a, dtype, device)
    pair_fn, spec, params = _pair_path(params, state, n, a["L"], 0.4, kernel,
                                       pair_rleucg.compute)
    system = System(n_atoms=n, ntypes=3,
                    masses=np.array([0.0, 1.0, 1.0, 1.0]))
    cfg = _deck_cfg(fi.IntegratorCfg("nve/ucgld/wall/hard",
                                     bias_potential=True, barrier=0.1),
                    reneigh_every)
    return Simulation(system, state, pair_fn, params, spec, cfg)


# ---- molecular systems (atom_style ucg with topology) -----------------------

MOL_RHO = 0.3
BOND = (50.0, 0.9)           # bond_coeff K r0 of the trimer decks
ANGLE = (10.0, 120.0)        # angle_coeff K theta0 of the UCG-LD trimers
TRIMER_COEFFS = dict(bond_coeffs={1: BOND}, angle_coeffs={1: ANGLE})


def _trimer_topology(nmol: int, per: int = 3):
    """Data-file rows of ``nmol`` chains of ``per`` atoms: bonds
    ``id 1 a a+1``, angles ``id 1 a a+1 a+2`` and, for chains of four,
    dihedrals and impropers ``id 1 a a+1 a+2 a+3``, as the decks number
    them."""
    first = per * np.arange(nmol)[:, None] + 1
    b = (first + np.arange(per - 1)).reshape(-1)
    bonds = np.stack([np.arange(1, len(b) + 1), np.ones_like(b), b, b + 1],
                     1)
    a = (first + np.arange(per - 2)).reshape(-1)
    angles = np.stack([np.arange(1, len(a) + 1), np.ones_like(a), a, a + 1,
                       a + 2], 1)
    top = {"bonds": bonds, "angles": angles}
    if per == 4:
        d = first[:, 0]
        top["dihedrals"] = top["impropers"] = np.stack(
            [np.arange(1, nmol + 1), np.ones_like(d), d, d + 1, d + 2, d + 3],
            1)
    return top


def molecular_arrays(nmol: int, seed: int = 31) -> dict:
    """``write_molecular_ucgld_deck``'s draws: bent trimers (bonds 0.9,
    120°) around a lattice of molecule centers (jitter 0.1) at ρ 0.3; from
    ``default_rng(seed)`` the first bond's direction, the bend plane, then λ
    uniform in [0.2, 0.8] with state = (λ > 0.5), then the velocities;
    λ-mass 5."""
    n = 3 * nmol
    L = (n / MOL_RHO) ** (1 / 3)
    rng = np.random.default_rng(seed)
    centers = lattice_positions(nmol, L, 0.1, seed)
    u1 = rng.normal(size=(nmol, 3))
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    p = rng.normal(size=(nmol, 3))
    p -= np.sum(p * u1, axis=1, keepdims=True) * u1
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    th = np.deg2rad(120.0)
    u2 = np.cos(th) * u1 + np.sin(th) * p
    r0 = BOND[1]
    x = np.concatenate([centers + r0 * u1, centers, centers + r0 * u2],
                       axis=1).reshape(-1, 3) % L
    lam = rng.uniform(0.2, 0.8, n)
    return {"L": L, "x": x, "v": _velocities(rng, n), "ucgl": lam,
            "ucgstate": (lam > 0.5).astype(np.int32),
            "ucgml": np.full(n, 5.0), "typ": np.ones(n, np.int32),
            "mol": np.repeat(np.arange(1, nmol + 1, dtype=np.int32), 3),
            **_trimer_topology(nmol)}


def tetramer_arrays(nmol: int, seed: int = 37) -> dict:
    """``write_molecular_tetramer_deck``'s draws: chains of four, steps of
    0.8 in random directions (a step within cos 0.7 of the last redrawn),
    from a lattice of chain starts (jitter 0.1) at ρ 0.2; then λ uniform
    in [0.2, 0.8] with state = (λ > 0.5), then the velocities."""
    n = 4 * nmol
    L = (n / 0.2) ** (1 / 3)
    rng = np.random.default_rng(seed)
    centers = lattice_positions(nmol, L, 0.1, seed)

    def direction():
        step = rng.normal(size=3)
        return step / np.linalg.norm(step)

    xs = []
    for m in range(nmol):
        pts, prev = [centers[m]], None
        for _ in range(3):
            step = direction()
            while prev is not None and abs(step @ prev) > 0.7:
                step = direction()
            pts.append(pts[-1] + 0.8 * step)
            prev = step
        xs.append(np.stack(pts))
    lam = rng.uniform(0.2, 0.8, n)
    return {"L": L, "x": np.concatenate(xs) % L, "v": _velocities(rng, n),
            "ucgl": lam, "ucgstate": (lam > 0.5).astype(np.int32),
            "ucgml": np.full(n, 5.0), "typ": np.ones(n, np.int32),
            "mol": np.repeat(np.arange(1, nmol + 1, dtype=np.int32), 4),
            **_trimer_topology(nmol, 4)}


def switch_arrays(nmol: int, seed: int = 23) -> dict:
    """``write_molecular_switch_deck``'s draws: linear trimers (bonds 0.9)
    around a lattice of centers (jitter 0.1) at ρ 0.1; from
    ``default_rng(seed)`` each molecule's direction, then its type (1 or 2
    with probability 0.5 each), then the velocities; state 0, λ 0.5,
    λ-mass 5."""
    n = 3 * nmol
    L = (n / 0.1) ** (1 / 3)
    rng = np.random.default_rng(seed)
    centers = lattice_positions(nmol, L, 0.1, seed)
    dirs = rng.normal(size=(nmol, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r0 = BOND[1]
    x = np.concatenate([centers - r0 * dirs, centers, centers + r0 * dirs],
                       axis=1).reshape(-1, 3) % L
    typ = np.where(rng.uniform(size=nmol) < 0.5, 1, 2).astype(np.int32)
    return {"L": L, "x": x, "v": _velocities(rng, n),
            "ucgl": np.full(n, 0.5), "ucgstate": np.zeros(n, np.int32),
            "ucgml": np.full(n, 5.0), "typ": np.repeat(typ, 3),
            "mol": np.repeat(np.arange(1, nmol + 1, dtype=np.int32), 3),
            **_trimer_topology(nmol)}


def _ucgld_pair(state, dtype, device, tablength: int = 2000):
    """``table_ucgld linear <tablength>`` on the four 2-state soft tables
    of the molecular decks (μ 0, 0.3; kT 0.8)."""
    st = parse_state_settings(TWO_STATE_SETTINGS, "ucgld")
    b = TablePairBuilder("linear", tablength, st)
    b.pair_coeff(1, 1, 2, 2, [(soft_table(e, 2000), RC) for e in EPS])
    bank, tp = b.build(dtype=dtype, device=device)
    return pair_ucgld.UCGLDParams(
        bank=bank, tp=tp, kT=torch.tensor(DECK_T, dtype=dtype,
                                          device=device))


def build_molecular_sim(nmol: int = 128, dtype=torch.float32,
                        device="cuda", kernel: bool | None = None,
                        style: str = "ucgld",
                        method: str | None = None) -> Simulation:
    """``write_molecular_ucgld_deck`` at its published settings: ``pair_style
    table_ucgld linear 2000``, bonds 50/0.9, angles 10/120°,
    ``special_bonds lj 0 0 0``, skin 0.4, reneighbour every 5, dt 0.002,
    ``nve/ucgld/wall/hard``, ``ucgld/langevin 0.8 0.8 0.5`` and ``ucgstate
    ld``.  ``style="bethe"``: the same trimers under config 3's
    ``table_ucg_bethe`` (bethe, pseudo, prior chemical_potential),
    ``nve/ucgld`` and ``ucgstate`` default.  ``kernel`` as in
    :func:`build_sim` (K1 or K2, with ``excl_delta`` subtracted);
    ``method`` picks the reference path's list."""
    device = resolve_device(device)
    a = molecular_arrays(nmol)
    n, L = 3 * nmol, a["L"]
    state = _state(a, dtype, device)
    if style == "ucgld":
        params, ref = _ucgld_pair(state, dtype, device), pair_ucgld.compute
        integ = fi.IntegratorCfg("nve/ucgld/wall/hard")
        ucgstate = fs.UCGStateCfg(mode="ld")
    elif style == "bethe":
        st = parse_state_settings(TWO_STATE_SETTINGS, "bethe")
        b = TablePairBuilder("linear", 1200, st)
        b.pair_coeff(1, 1, 2, 2, [(soft_table(e, 2000), RC) for e in EPS])
        bank, tp = b.build(dtype=dtype, device=device)
        params = pair_bethe.make_params(bank, tp, DECK_T,
                                        prior_mode="chemical_potential",
                                        dtype=dtype)
        ref = pair_bethe.compute
        integ = fi.IntegratorCfg("nve/ucgld")
        ucgstate = fs.UCGStateCfg(mode="default")
    else:
        raise ValueError(f"unknown molecular pair style {style!r}")
    pair_fn, spec, params = _pair_path(params, state, n, L, 0.4, kernel, ref,
                                       method)
    cfg = SimConfig(
        dt=0.002, units="lj", integrator=integ,
        langevin=fl.LangevinCfg(t_start=DECK_T, t_stop=DECK_T, t_period=0.5),
        ucgstate=ucgstate, reneigh_every=5)
    return _molecular_sim(a, state, pair_fn, params, spec, cfg, dtype,
                          device, TRIMER_COEFFS)


def _molecular_sim(a, state, pair_fn, params, spec, cfg, dtype, device,
                   coeffs: dict, ntypes: int = 1, **kw):
    """Simulation of a molecular system: the bonded terms of ``a``'s
    topology rows with ``coeffs`` (``bonded.make_params``'s ``*_coeffs``
    keywords) and the weight-0 special exclusions (1-2, 1-3 and, with
    dihedrals, 1-4)."""
    n = state.n_atoms
    top = {k: a.get(k) for k in ("bonds", "angles", "dihedrals",
                                 "impropers")}
    bp = bonded.make_params(dtype=dtype, device=device, **top, **coeffs)
    excl = bonded.special_tags(n, top["bonds"], top["angles"],
                               top["dihedrals"])
    system = System(n_atoms=n, ntypes=ntypes,
                    masses=np.array([0.0] + [1.0] * ntypes))
    return Simulation(system, state, pair_fn, params, spec, cfg, bonded=bp,
                      excl_tags=excl, **kw)


def build_respa_sim(nmol: int = 128, dtype=torch.float32, device="cuda",
                    respa_inner: int = 4, dt: float = 0.004,
                    bond_k: float = 400.0,
                    kernel: bool | None = None) -> Simulation:
    """The trimers of :func:`build_molecular_sim` in the shape of the JAX
    package's r-RESPA test (``tests/test_bonded.py:202``): stiff bonds
    (``bond_k``, r0 0.9), angles 10/120°, ``nve/ucgld`` with no thermostat
    and no ``ucgstate``, reneighbour every 5, ``respa_inner`` inner steps
    of dt/respa_inner (1 is plain Verlet)."""
    device = resolve_device(device)
    a = molecular_arrays(nmol)
    n, L = 3 * nmol, a["L"]
    state = _state(a, dtype, device)
    params = _ucgld_pair(state, dtype, device)
    pair_fn, spec, params = _pair_path(params, state, n, L, 0.4, kernel,
                                       pair_ucgld.compute)
    cfg = SimConfig(dt=dt, units="lj",
                    integrator=fi.IntegratorCfg("nve/ucgld"),
                    reneigh_every=5, respa_inner=respa_inner)
    return _molecular_sim(a, state, pair_fn, params, spec, cfg, dtype,
                          device, dict(TRIMER_COEFFS,
                                       bond_coeffs={1: (bond_k, BOND[1])}))


def build_tetramer_sim(nmol: int = 128, dtype=torch.float32, device="cuda",
                       kernel: bool | None = None) -> Simulation:
    """``write_molecular_tetramer_deck`` at its published settings:
    ``table_ucgld linear 2000``, bonds 50/0.8, angles 10/110°, dihedrals
    2.0/1/3, impropers 1.5/35°, ``special_bonds lj 0 0 0`` (1-2, 1-3, 1-4),
    ``neigh_modify one 96``, skin 0.4, dt 0.002, ``nve/ucgld/wall/hard``,
    ``ucgld/langevin 0.8 0.8 0.5`` and ``ucgstate ld``."""
    device = resolve_device(device)
    a = tetramer_arrays(nmol)
    n, L = 4 * nmol, a["L"]
    state = _state(a, dtype, device)
    pair_fn, spec, params = _pair_path(
        _ucgld_pair(state, dtype, device), state, n, L, 0.4, kernel,
        pair_ucgld.compute, capacity=96)
    cfg = SimConfig(
        dt=0.002, units="lj",
        integrator=fi.IntegratorCfg("nve/ucgld/wall/hard"),
        langevin=fl.LangevinCfg(t_start=DECK_T, t_stop=DECK_T, t_period=0.5),
        ucgstate=fs.UCGStateCfg(mode="ld"), reneigh_every=5)
    return _molecular_sim(a, state, pair_fn, params, spec, cfg, dtype,
                          device, dict(bond_coeffs={1: (50.0, 0.8)},
                                       angle_coeffs={1: (10.0, 110.0)},
                                       dihedral_coeffs={1: (2.0, 1, 3)},
                                       improper_coeffs={1: (1.5, 35.0)}))


SWITCH_SETTINGS = "2 2 1\n1 1\n2 1\n0.0\n0.0\n"   # two plain types


def build_switch_sim(nmol: int = 64, dtype=torch.float32, device="cuda",
                     log_dir: str | None = None) -> Simulation:
    """``write_molecular_switch_deck`` at its published settings: two plain
    types under ``table_ucgld linear 1200`` (tables 1.0, 0.6, 0.3), bonds
    50/0.9, angles 10/180°, ``special_bonds lj 0 0 0``, skin 0.4,
    reneighbour every 5, dt 0.002, ``nve/ucgld`` and ``fix cluster_switch
    1 0 1.3 26 rateFreq 20`` (probON 0.5, ON type 2, OFF type 1, contacts
    (2, 2), maxmol nmol).  The reference pair path: K1 takes no system
    without a 2-state type."""
    device = resolve_device(device)
    a = switch_arrays(nmol)
    n, L = 3 * nmol, a["L"]
    state = _state(a, dtype, device)
    st = parse_state_settings(SWITCH_SETTINGS, "ucgld")
    b = TablePairBuilder("linear", 1200, st)
    for i, j, e in ((1, 1, 1.0), (1, 2, 0.6), (2, 2, 0.3)):
        b.pair_coeff(i, j, 1, 1, [(soft_table(e, 2000), RC)])
    bank, tp = b.build(dtype=dtype, device=device)
    params = pair_ucgld.UCGLDParams(
        bank=bank, tp=tp, kT=torch.tensor(0.0, dtype=dtype, device=device))
    spec = nb.make_spec(n, [L] * 3, RC, 0.4)
    cfg = SimConfig(dt=0.002, units="lj",
                    integrator=fi.IntegratorCfg("nve/ucgld"),
                    reneigh_every=5)
    cs = fcs.make_params(ntypes=2, maxmol=nmol, dtype=dtype, device=device,
                         **DENSITY_SWITCH)
    return _molecular_sim(a, state, pair_ucgld.compute, params, spec, cfg,
                          dtype, device, dict(TRIMER_COEFFS, angle_coeffs={
                              1: (10.0, 180.0)}),
                          ntypes=2, cluster_switch=(cs, SWITCH_FREQ),
                          log_dir=log_dir)
