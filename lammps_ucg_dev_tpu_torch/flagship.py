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
  0.4, reneighbour every 10; the deck's ``fix cluster_switch`` is left
  out.  Its arrays come from :func:`density_arrays`.
* :func:`build_rleucg_sim` — the config-5 interface system of
  ``write_rleucg_deck`` (P4): substate types 1/2 (one 2-state density
  actual type, 70% drawn as type 1) and 3 (plain),
  ``table_rleucg_interface linear 1200`` over 6 tables, ρ 0.5, T 0.8,
  ``fix nve/ucgld/wall/hard bias_potential 0.1`` and ``ucgld/langevin
  0.8 0.8 0.5``, dt 0.002, skin 0.4, reneighbour every 10.  Its arrays
  come from :func:`rleucg_arrays`.

All build on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without CUDA they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import (Box, SimState, System,
                                                resolve_device)
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.io.table_io import RLINEAR, RawTable
from lammps_ucg_dev_tpu_torch.models import (pair_bethe, pair_bethe_density,
                                             pair_rleucg, pair_ucgld)
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


def _pair_path(params, state, n, L, skin, kernel, reference_fn):
    """(pair_fn, spec, params): the kernel path when ``select_pair_kernel``
    takes it, else the reference path on an nsq or cell list (the JAX
    package's choice: cell for n > 512 with >= 3 cells a side)."""
    sel = select_pair_kernel(params, state, RC, skin, force=kernel)
    if sel is not None:
        return sel
    if n >= 65536 and n % 16384 == 0:
        # bound the reference path's (rows, K, 2, 2) working set
        params = dataclasses.replace(params, chunk=16384)
    return reference_fn, nb.make_spec(n, [L] * 3, RC, skin), params


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


def _lattice(n: int, seed: int):
    """(L, x): the decks' ``lattice_positions`` — a jittered simple-cubic
    lattice of ceil(n^(1/3))^3 sites truncated to n, in a cube of side
    (n/ρ)^(1/3), with its own ``default_rng(seed)`` — wrapped into the
    box."""
    L = (n / DECK_RHO) ** (1 / 3)
    m = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    jitter = np.random.default_rng(seed).normal(0, 0.05, (n, 3))
    return L, np.mod((grid + 0.5) * (L / m) + jitter, L)


def _velocities(rng, n: int):
    """N(0, T) per component with the net momentum removed."""
    v = rng.normal(0.0, np.sqrt(DECK_T), (n, 3))
    return v - v.mean(axis=0)


def _deck_arrays(n: int, seed: int, first: int, other: int) -> dict:
    """Configs 4 and 5: the lattice, then from ``default_rng(seed)`` the
    types (``first`` with probability 0.7, else ``other``) as the deck
    draws them, then the velocities; state 0, λ 0.5, λ-mass 5 as in the
    decks' data files; ucgp stays at the -1 sentinel."""
    L, x = _lattice(n, seed)
    rng = np.random.default_rng(seed)
    typ = np.where(rng.uniform(size=n) < 0.7, first, other).astype(np.int32)
    return {"L": L, "x": x, "v": _velocities(rng, n),
            "ucgl": np.full(n, 0.5), "ucgstate": np.zeros(n, np.int32),
            "ucgml": np.full(n, 5.0), "typ": typ}


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
        ucgstate=a["ucgstate"], ucgml=a["ucgml"],
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


def build_density_sim(n: int = 512, dtype=torch.float32, device="cuda",
                      reneigh_every: int = 10,
                      kernel: bool | None = None) -> Simulation:
    """The config-4 density-CV system (P3) without ``fix cluster_switch``.
    ``kernel`` as in :func:`build_sim`, selecting K5, K3 and K6
    (ops/hopper_density.py)."""
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
    return Simulation(system, state, pair_fn, params, spec, cfg)


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
