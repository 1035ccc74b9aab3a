"""The port's ``fix cluster_switch`` (``fixes/cluster_switch.py``) against
the JAX package's, in the cases of the JAX package's
``tests/test_cluster_switch.py``: the same positions, types and molecules,
one contact list (the port's nsq builder's), and the JAX
package's accept draws injected into the port (its generator cannot
reproduce them).  Labels, ``in_cluster``, the molecule states, the new
types, the 7-stat vector and ``converged`` agree bit for bit; so do the
labels where ``max_sweeps`` cuts the propagation short, and the port's
sweep count is the number of sweeps the JAX loop runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.fixes import cluster_switch as jcs
from lammps_ucg_dev_tpu.ops import neighbor as jnb
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.core.state import Box as tBox
from lammps_ucg_dev_tpu_torch.core.state import SimState as tSimState
from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as tcs
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from test_torch_core import one_torch_thread  # noqa: F401

ON, OFF = 1, 2
KEY = jax.random.PRNGKey(0)
# jitted: eager dispatch of the JAX package's while_loop costs seconds a call
jcheck = jax.jit(jcs.check_cluster)
japply = jax.jit(jcs.apply)


def make(positions, types, mols, L=40.0, maxmol=None, probON=1.0,
         cutoff=1.5, mol_seed=1, mol_offset=0, max_sweeps=64):
    """Both packages' (state, contact list, params) of one system."""
    n = len(positions)
    tstate = tSimState.create(
        x=np.asarray(positions, float), typ=np.asarray(types),
        mol=np.asarray(mols), dtype=torch.float64,
        box=tBox.create([0, 0, 0], [L, L, L], dtype=torch.float64))
    # the JAX state field by field from the port's (JSimState.create would
    # compile its fills and clips for each new atom count)
    jstate = JSimState(
        step=jnp.zeros((), jnp.int32), key=KEY,
        box=JBox.create([0, 0, 0], [L, L, L], dtype=jnp.float64),
        **{f: jnp.asarray(getattr(tstate, f).numpy())
           for f in ("x", "v", "tag", "typ", "mol", "q", "image", "ucgstate",
                     "ucgl", "ucgvl", "ucgml", "ucgp")})
    kw = dict(ntypes=2, contacts=[(ON, ON), (ON, OFF), (OFF, OFF)],
              atomtypes_on=[ON], atomtypes_off=[OFF], probON=probON,
              cutoff=cutoff, mol_seed=mol_seed, mol_offset=mol_offset,
              maxmol=maxmol or int(max(mols)), max_sweeps=max_sweeps)
    jp = jcs.make_params(dtype=jnp.float64, **kw)
    tspec = tnb.make_spec(n, [L] * 3, cutoff + 0.5, 0.3, method="nsq")
    tnbr = tnb.build(tstate.x, tstate.box, tspec)
    # the same list on the JAX side (its nsq builder orders rows alike)
    jnbr = jnb.NeighborList(idx=jnp.asarray(tnbr.idx.numpy(), jnp.int32),
                            x0=jstate.x, overflow=jnp.asarray(False),
                            max_occupancy=jnp.asarray(0),
                            capacity=tnbr.capacity)
    tp = tcs.make_params(dtype=torch.float64, device="cpu", **kw)
    return (jstate, jnbr, jp), (tstate, tnbr, tp)


def same(t, j, what=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and np.array_equal(t, j.astype(t.dtype)), \
        (what, t, j)


def check(jax_side, port_side):
    """check_cluster in both packages: every output bit for bit."""
    jout = jcheck(*jax_side)
    tout = tcs.check_cluster(*port_side)
    for name, a, b in zip(("labels", "mol_state", "present", "in_cluster",
                           "n_cluster"), tout, jout):
        same(a, b, name)
    assert tout[5] == bool(jout[5])                 # converged
    return tout, jout


def apply_both(jax_side, port_side, seed, stats=None):
    """One event in both packages with the JAX package's draws for
    ``PRNGKey(seed)``; returns ((state, stats, info) port, JAX)."""
    jstate, jnbr, jp = jax_side
    tstate, tnbr, tp = port_side
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (jp.maxmol + 1,), dtype=jnp.float64)
    jstats = stats[0] if stats else jcs.ClusterSwitchStats.zeros(jnp.float64)
    tstats = (stats[1] if stats
              else tcs.ClusterSwitchStats.zeros(torch.float64))
    jr = japply(key, jstate, jnbr, jp, jstats)
    tr = tcs.apply(torch.tensor(np.asarray(u)), tstate, tnbr, tp, tstats)
    same(tr[0].typ, jr[0].typ, "typ")
    same(tr[1].v, jr[1].v, "stats")
    for name in ("in_cluster", "mol_state", "n_cluster", "accept"):
        same(tr[2][name], jr[2][name], name)
    assert tr[2]["converged"] == bool(jr[2]["converged"])
    return tr, jr


CHAIN = ([[0, 0, 0], [1, 0, 0], [2, 0, 0], [10, 0, 0], [20, 0, 0]],
         [ON, ON, ON, OFF, ON], [1, 2, 3, 4, 5])


def test_cluster_labeling_chain():
    j, t = make(*CHAIN)
    tout, _ = check(j, t)
    assert int(tout[4]) == 3 and tout[5]


@pytest.mark.parametrize("probON", [1.0, 0.0, 0.5])
def test_switch_locks_cluster_and_flips_rest(probON):
    j, t = make(*CHAIN, probON=probON)
    tr, _ = apply_both(j, t, 0)
    assert tr[0].typ[:3].tolist() == [ON, ON, ON]   # the cluster is locked
    if probON == 1.0:
        assert tr[1].v.tolist() == [2, 1, 1, 1, 1, 0, 3]


def test_switch_off_direction():
    j, t = make([[0, 0, 0], [10, 0, 0]], [ON, ON], [1, 2], probON=0.0)
    tr, _ = apply_both(j, t, 1)
    assert tr[0].typ.tolist() == [ON, OFF] and tr[1].v[5] == 1


def test_offset_partner_linking():
    """Seed mol 6 (offset 5: partner 1) touches nothing; its partner is
    preset into the seed cluster; mol 8 (partner 3, absent) stays out."""
    j, t = make([[0, 0, 0], [30, 0, 0], [10, 0, 0]], [ON, ON, ON],
                [1, 6, 8], maxmol=8, mol_seed=6, mol_offset=5, probON=0.0)
    tout, _ = check(j, t)
    inc = tout[3]
    assert inc[6] and inc[1] and not inc[8]


def test_pbc_contact():
    L = 20.0
    j, t = make([[0.2, 0, 0], [L - 0.2, 0, 0], [10, 0, 0]], [ON, ON, OFF],
                [1, 2, 3], L=L)
    tout, _ = check(j, t)
    assert int(tout[4]) == 2 and tout[3][2]


def test_statistics_over_rounds():
    """probON 0.5 on 64 isolated OFF molecules, 5 events with the types
    reset each round: the 7-stat vector accumulates as JAX's does."""
    import dataclasses

    n_mol = 64
    pos = [[4.0 * (i + 1), 0, 0] for i in range(n_mol)]
    types, mols = [OFF] * n_mol, list(range(1, n_mol + 1))
    j, t = make(pos, types, mols, L=400.0, probON=0.5)
    stats = None
    for k in range(5):
        tr, jr = apply_both(j, t, k, stats)
        stats = (jr[1], tr[1])
    frac = float(stats[1].v[1]) / float(stats[1].v[0])
    assert 0.3 < frac < 0.7
    assert dataclasses.replace(t[0]).typ.tolist() == types   # inputs intact


@pytest.mark.parametrize("max_sweeps", [3, 20, 39, 40, 64])
def test_max_sweeps_cap(max_sweeps):
    """An open chain of 40 molecules in contact: the seed's label reaches
    the far end at the 39th sweep and the 40th changes nothing, so the JAX
    loop converges for max_sweeps >= 40 only, after 40 sweeps.  Below that
    both packages stop at the cap with converged False and the same
    partial labels (the port reads its change flag every SWEEP_CHECK
    sweeps; 20, 39 and 40 end inside a batch)."""
    pos = [[1.0 * i + 0.5, 0, 0] for i in range(40)]
    j, t = make(pos, [ON] * 40, list(range(1, 41)), L=100.0,
                max_sweeps=max_sweeps)
    tout, _ = check(j, t)
    assert tout[5] == (max_sweeps >= 40)
    assert tout[6] == min(max_sweeps, 40)


def test_params_converter():
    """``cluster_switch_params_from_numpy`` of the JAX params equals the
    port's own ``make_params``."""
    j, t = make(*CHAIN, mol_offset=2)
    c = convert.cluster_switch_params_from_numpy(convert.as_numpy_dict(j[2]),
                                                 device="cpu")
    for f in ("contact_ok", "off_to_on", "on_to_off", "is_on", "is_off",
              "cutsq", "probON"):
        a, b = getattr(c, f), getattr(t[2], f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (c.maxmol, c.max_sweeps, c.mol_seed, c.mol_offset) == (
        t[2].maxmol, t[2].max_sweeps, t[2].mol_seed, t[2].mol_offset)
