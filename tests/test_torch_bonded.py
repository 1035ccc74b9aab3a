"""The port's bonded terms (``models/bonded.py``) against the JAX package's
in float64, on the same tags, coefficients and positions: chains of four
carrying harmonic bonds, angles, dihedrals of multiplicity 1, 2 and 3 with
both signs of d, and impropers, one of them near planar (χ ~ 1e-5, where
the guarded arccos derivative sets the force).  Forces, pe and the virial
agree to 1e-10 of their scale (the same formulas in float64; the
scatter's summation order differs); so do ``potential_energy`` and its
autograd force.  ``special_tags`` and the converter agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.core.state import SimState as JSimState
from lammps_ucg_dev_tpu.models import bonded as jbd
from lammps_ucg_dev_tpu_torch import convert
from lammps_ucg_dev_tpu_torch.models import bonded as tbd
from test_torch_core import one_torch_thread  # noqa: F401

NMOL, L = 12, 9.0
TOL = 1e-10
DIHEDRAL = {1: (2.0, 1, 3), 2: (1.5, -1, 1), 3: (0.7, 1, 2),
            4: (1.1, -1, 3), 5: (0.4, 1, 1)}
IMPROPER = {1: (1.5, 35.0), 2: (0.8, 0.0)}
jcompute = jax.jit(jbd.compute)       # faster than eager op by op here


def chains(seed=7):
    """Positions and data-file rows of NMOL chains of four; the last chain
    is planar but for a 1e-5 offset of its fourth atom (improper type 2,
    χ0 = 0: the guarded branch)."""
    rng = np.random.default_rng(seed)
    x = []
    for m in range(NMOL):
        start = rng.uniform(1.0, L - 1.0, 3)
        steps = rng.normal(size=(3, 3))
        steps /= np.linalg.norm(steps, axis=1, keepdims=True)
        x.append(start + np.cumsum(np.vstack([np.zeros(3), 0.85 * steps]),
                                   axis=0))
    x[-1] = x[-1][0] + np.array([[0, 0, 0], [0.9, 0, 0], [1.4, 0.7, 0],
                                 [2.3, 0.8, 1e-5]])
    x = np.concatenate(x) % L
    bonds, angles, dih, imp = [], [], [], []
    for m in range(NMOL):
        a = 4 * m + 1
        for k in range(3):
            bonds.append([len(bonds) + 1, 1 + k % 2, a + k, a + k + 1])
        for k in range(2):
            angles.append([len(angles) + 1, 1 + k, a + k, a + k + 1,
                           a + k + 2])
        dih.append([m + 1, 1 + m % len(DIHEDRAL), a, a + 1, a + 2, a + 3])
        imp.append([m + 1, 2 if m == NMOL - 1 else 1, a, a + 1, a + 2,
                    a + 3])
    return x, tuple(np.asarray(r) for r in (bonds, angles, dih, imp))


def params(mod, rows, terms="all", **kw):
    """Both packages' BondedParams of ``rows``, restricted to one class of
    terms unless ``terms`` is "all"."""
    bonds, angles, dih, imp = (r if terms in ("all", t) else None
                               for r, t in zip(rows, ("bonds", "angles",
                                                      "dihedrals",
                                                      "impropers")))
    return mod.make_params(bonds, {1: (50.0, 0.9), 2: (30.0, 0.8)}, angles,
                           {1: (10.0, 120.0), 2: (6.0, 100.0)},
                           dihedrals=dih, dihedral_coeffs=DIHEDRAL,
                           impropers=imp, improper_coeffs=IMPROPER, **kw)


@pytest.fixture(scope="module")
def system():
    x, rows = chains()
    n = len(x)
    jstate = JSimState.create(
        x=x, mol=np.repeat(np.arange(1, NMOL + 1), 4),
        box=JBox.create([0, 0, 0], [L] * 3, dtype=jnp.float64),
        dtype=jnp.float64)
    tstate = convert.state_from_numpy(convert.as_numpy_dict(jstate),
                                      device="cpu")
    jp = params(jbd, rows, dtype=jnp.float64)
    tp = params(tbd, rows, dtype=torch.float64, device="cpu")
    assert n == 4 * NMOL
    return jstate, tstate, jp, tp, rows


def close(got, ref, err_msg=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=TOL * scale, err_msg=err_msg)


@pytest.mark.parametrize("terms", ["bonds", "angles", "dihedrals",
                                   "impropers", "all"])
def test_compute_matches_jax(system, terms):
    jstate, tstate, _, _, rows = system
    jf, jpe, jvir = jcompute(jstate, params(jbd, rows, terms,
                                               dtype=jnp.float64))
    tf, tpe, tvir = tbd.compute(tstate, params(tbd, rows, terms,
                                               dtype=torch.float64,
                                               device="cpu"))
    close(tf.numpy(), jf, "f")
    close(float(tpe), float(jpe), "pe")
    close(tvir.numpy(), jvir, "virial")
    assert float(np.abs(np.asarray(jf)).max()) > 0


def test_near_planar_improper_uses_the_guard(system):
    """The last chain's χ is ~1e-5: its improper force is finite, nonzero
    and JAX's guarded one; unguarded autograd of arccos would divide by
    ~0 there."""
    jstate, tstate, _, _, rows = system
    tf, _, _ = tbd.compute(tstate, params(tbd, rows, "impropers",
                                          dtype=torch.float64, device="cpu"))
    jf, _, _ = jcompute(jstate, params(jbd, rows, "impropers",
                                          dtype=jnp.float64))
    planar = slice(4 * (NMOL - 1), 4 * NMOL)
    assert torch.isfinite(tf).all()
    assert float(tf[planar].abs().max()) > 0
    close(tf[planar].numpy(), np.asarray(jf)[planar], "planar improper f")


def test_potential_energy_and_its_gradient(system):
    """``potential_energy`` equals JAX's, and away from the guarded planar
    improper its autograd force is ``compute``'s (which matches JAX's)."""
    jstate, tstate, jp, tp, rows = system
    x = tstate.x.clone().requires_grad_(True)
    e = tbd.potential_energy(x, tstate, tp)
    je = jax.jit(lambda y: jbd.potential_energy(y, jstate, jp))(jstate.x)
    close(float(e.detach()), float(je), "E")
    (g,) = torch.autograd.grad(e, x)
    f, pe, _ = tbd.compute(tstate, tp)
    close(float(pe), float(e.detach()), "pe")
    rest = slice(0, 4 * (NMOL - 1))
    close(-g[rest].numpy(), f[rest].numpy(), "f = -dE/dx")


def test_special_tags_match_jax(system):
    *_, rows = system
    bonds, angles, dih, _ = rows
    n = 4 * NMOL
    for kw in (dict(bonds=bonds), dict(bonds=bonds, angles=angles),
               dict(bonds=bonds, angles=angles, dihedrals=dih),
               dict(bonds=bonds, angles=angles, dihedrals=dih, cap=6),
               dict(bonds=bonds, weights=(1.0, 1.0, 1.0))):
        got, ref = tbd.special_tags(n, **kw), jbd.special_tags(n, **kw)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), kw
    with pytest.raises(NotImplementedError):
        tbd.special_tags(n, bonds=bonds, weights=(0.5, 0.0, 0.0))
    with pytest.raises(ValueError):
        tbd.special_tags(n, bonds=bonds, angles=angles, cap=1)


def test_converter_and_make_params_agree(system):
    """``bonded_params_from_numpy`` of the JAX params computes what the
    port's own ``make_params`` does, bit for bit."""
    jstate, tstate, jp, tp, rows = system
    cp = convert.bonded_params_from_numpy(convert.as_numpy_dict(jp),
                                          device="cpu")
    for name in ("bond_tags", "angle_tags", "dihedral_tags", "improper_tags",
                 "bond_k", "bond_r0", "angle_k", "angle_t0", "dihedral_k",
                 "dihedral_d", "dihedral_wsel", "improper_k", "improper_x0"):
        a, b = getattr(cp, name), getattr(tp, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(tbd.compute(tstate, cp), tbd.compute(tstate, tp)):
        assert torch.equal(a, b)


def test_make_params_errors_as_jax():
    with pytest.raises(ValueError):
        tbd.make_params([[1, 2, 1, 2]], {1: (1.0, 1.0)}, device="cpu")
    with pytest.raises(ValueError):
        tbd.make_params(dihedrals=[[1, 1, 1, 2, 3, 4]],
                        dihedral_coeffs={1: (1.0, 0.5, 1)}, device="cpu")
    empty = tbd.make_params(device="cpu")
    assert (empty.n_bonds, empty.n_angles, empty.n_dihedrals,
            empty.n_impropers) == (0, 0, 0, 0)
