"""The flagship system: a 2-state UCG-LD fluid (port of
``__graft_entry__._build_sim``).

One actual type with two states at ρ = 0.6, ``pair_style table_ucgld`` with
cosine-soft LINEAR tables (rc = 2.5), ``fix nve/ucgld/wall/hard`` with the
bias potential, ``fix ucgld/langevin`` and ``fix ucgstate ld``.  The numpy
draws are those of ``_build_sim``, in the same order (``default_rng(11)``: x,
then v, ucgl, ucgstate and ucgvl), so both packages start from the identical
state.
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
from lammps_ucg_dev_tpu_torch.models import pair_ucgld
from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder
from lammps_ucg_dev_tpu_torch.ops import neighbor as nb
from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel
from lammps_ucg_dev_tpu_torch.runtime.sim import SimConfig, Simulation

RC = 2.5


def build_sim(n: int = 256, dtype=torch.float32, device="cpu",
              reneigh_every: int = 5, kernel: bool | None = None,
              rho: float = 0.6, skin: float = 0.4) -> Simulation:
    """``kernel``: run the pair step through K1 (ops/hopper_pair.py) —
    None = auto (CUDA device, f32, eligible geometry), True = force the
    selection (on CPU tensors the wrapper then runs the kernel's twin),
    False = the reference pair path on an nsq neighbor list."""
    rng = np.random.default_rng(11)
    L = (n / rho) ** (1 / 3)
    x = rng.uniform(0, L, (n, 3))

    def tab(eps):
        r = np.linspace(1e-3, RC, 1200)
        e = eps * (1 + np.cos(np.pi * r / RC))
        f = eps * np.pi / RC * np.sin(np.pi * r / RC)
        return RawTable(r=r, e=e, f=f, rflag=RLINEAR, rlo=1e-3, rhi=RC)

    st = parse_state_settings("1 2 2\n1 2\n1 2\n0.0 0.3\n", "ucgld")
    b = TablePairBuilder("linear", 1000, st)
    b.pair_coeff(1, 1, 2, 2, [(tab(1.0), RC), (tab(0.6), RC),
                              (tab(0.6), RC), (tab(0.25), RC)])
    bank, tp = b.build(dtype=dtype, device=device)

    state = SimState.create(
        x=x, v=rng.normal(0, 0.9, (n, 3)), typ=np.ones(n, np.int32),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        ucgvl=rng.normal(0, 0.3, n), ucgml=np.full(n, 5.0),
        box=Box.create([0, 0, 0], [L, L, L], dtype=dtype, device=device),
        dtype=dtype, device=device)
    params = pair_ucgld.UCGLDParams(
        bank=bank, tp=tp, kT=torch.tensor(0.8, dtype=dtype, device=device))

    pair_fn, spec = pair_ucgld.compute, None
    sel = select_pair_kernel(params, state, RC, skin, force=kernel)
    if sel is not None:
        pair_fn, spec, params = sel
    else:
        spec = nb.make_spec(n, [L] * 3, RC, skin)
        if n >= 65536 and n % 16384 == 0:
            # bound the reference path's (rows, K, 2, 2) working set
            params = dataclasses.replace(params, chunk=16384)
    system = System(n_atoms=n, ntypes=1, masses=np.array([0.0, 1.0]))
    cfg = SimConfig(
        dt=0.004, units="lj",
        integrator=fi.IntegratorCfg("nve/ucgld/wall/hard",
                                    bias_potential=True, barrier=0.1),
        langevin=fl.LangevinCfg(t_start=0.8, t_stop=0.8, t_period=0.5),
        ucgstate=fs.UCGStateCfg(mode="ld"), reneigh_every=reneigh_every)
    return Simulation(system, state, pair_fn, params, spec, cfg)
