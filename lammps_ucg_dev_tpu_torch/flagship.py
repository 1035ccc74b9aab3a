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
* :func:`build_bethe_sim` — the self-consistent Bethe fluid, the config-3
  system of ``examples/make_deck.py:write_bethe_deck`` at its published
  settings: ``pair_style table_ucg_bethe linear 1200 ... method bethe
  pseudo yes prior chemical_potential``, ρ = 0.5, T = 0.8,
  ``fix nve/ucgld``, ``fix ucgld/langevin 0.8 0.8 0.5`` and
  ``fix ucgstate`` in its default mode; its arrays come from
  :func:`bethe_arrays`.

Both build on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without CUDA they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box, SimState, System
from lammps_ucg_dev_tpu_torch.fixes import integrate as fi
from lammps_ucg_dev_tpu_torch.fixes import langevin as fl
from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs
from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
from lammps_ucg_dev_tpu_torch.io.table_io import RLINEAR, RawTable
from lammps_ucg_dev_tpu_torch.models import pair_bethe, pair_ucgld
from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu_torch.ops import neighbor as nb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.runtime.sim import SimConfig, Simulation

RC = 2.5
TWO_STATE_SETTINGS = "1 2 2\n1 2\n1 2\n0.0 0.3\n"
EPS = (1.0, 0.6, 0.6, 0.25)         # e00, e01, e10, e11


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "system on the CPU")
    return dev


def soft_table(eps: float, n: int, rlo: float = 1e-3) -> RawTable:
    """Cosine-soft raw table: E = eps (1 + cos(pi r/rc)) on [rlo, rc]."""
    r = np.linspace(rlo, RC, n)
    e = eps * (1 + np.cos(np.pi * r / RC))
    f = eps * np.pi / RC * np.sin(np.pi * r / RC)
    return RawTable(r=r, e=e, f=f, rflag=RLINEAR, rlo=rlo, rhi=RC)


def _pair_path(params, state, n, L, skin, kernel, reference_fn):
    """(pair_fn, spec, params): the kernel path when ``select_pair_kernel``
    takes it, else the reference path on an nsq list."""
    sel = select_pair_kernel(params, state, RC, skin, force=kernel)
    if sel is not None:
        return sel
    if n >= 65536 and n % 16384 == 0:
        # bound the reference path's (rows, K, 2, 2) working set
        params = dataclasses.replace(params, chunk=16384)
    return reference_fn, nb.make_spec(n, [L] * 3, RC, skin), params


def build_sim(n: int = 256, dtype=torch.float32, device="cuda",
              reneigh_every: int = 5, kernel: bool | None = None,
              rho: float = 0.6, skin: float = 0.4) -> Simulation:
    """``kernel``: run the pair step through K1 (ops/hopper_pair.py) —
    None = auto (CUDA device, f32, eligible geometry), True = force the
    selection (on CPU tensors the wrapper then runs the kernel's twin),
    False = the reference pair path on an nsq neighbor list."""
    device = _device(device)
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

    pair_fn, spec, params = _pair_path(params, state, n, L, skin, kernel,
                                       pair_ucgld.compute)
    system = System(n_atoms=n, ntypes=1, masses=np.array([0.0, 1.0]))
    cfg = SimConfig(
        dt=0.004, units="lj",
        integrator=fi.IntegratorCfg("nve/ucgld/wall/hard",
                                    bias_potential=True, barrier=0.1),
        langevin=fl.LangevinCfg(t_start=0.8, t_stop=0.8, t_period=0.5),
        ucgstate=fs.UCGStateCfg(mode="ld"), reneigh_every=reneigh_every)
    return Simulation(system, state, pair_fn, params, spec, cfg)


def bethe_arrays(n: int, seed: int = 11) -> dict:
    """The config-3 system's numpy draws (``write_bethe_deck``, ρ 0.5,
    T 0.8): a jittered simple-cubic lattice in a cube of side (n/ρ)^(1/3)
    (``lattice_positions`` with its own ``default_rng(seed)``), wrapped into
    the box; then from ``default_rng(seed)`` λ uniform in [0.3, 0.7] with
    state = (λ > 0.5), and velocities N(0, T) per component with the net
    momentum removed.  λ-mass 5, λ-velocity 0; ucgp stays at the -1
    sentinel."""
    rho, T = 0.5, 0.8
    L = (n / rho) ** (1 / 3)
    m = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    jitter = np.random.default_rng(seed).normal(0, 0.05, (n, 3))
    x = np.mod((grid + 0.5) * (L / m) + jitter, L)
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.3, 0.7, n)
    v = rng.normal(0.0, np.sqrt(T), (n, 3))
    v -= v.mean(axis=0)
    return {"L": L, "x": x, "v": v, "ucgl": lam,
            "ucgstate": (lam > 0.5).astype(np.int32),
            "ucgml": np.full(n, 5.0), "typ": np.ones(n, np.int32)}


def build_bethe_sim(n: int = 512, dtype=torch.float32, device="cuda",
                    reneigh_every: int = 5,
                    kernel: bool | None = None) -> Simulation:
    """The config-3 self-consistent Bethe fluid (``method bethe pseudo yes
    prior chemical_potential``, skin 0.4).  ``kernel`` as in
    :func:`build_sim`, selecting K2 (ops/hopper_bethe.py)."""
    device = _device(device)
    a = bethe_arrays(n)
    L = a["L"]
    st = parse_state_settings(TWO_STATE_SETTINGS, "bethe")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 2, 2, [(soft_table(e, 2000), RC) for e in EPS])
    bank, tp = b.build(dtype=dtype, device=device)
    state = SimState.create(
        x=a["x"], v=a["v"], typ=a["typ"], ucgl=a["ucgl"],
        ucgstate=a["ucgstate"], ucgml=a["ucgml"],
        box=Box.create([0, 0, 0], [L, L, L], dtype=dtype, device=device),
        dtype=dtype, device=device)
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
