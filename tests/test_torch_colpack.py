"""PyTorch port vs the JAX package: the column list (``ops/colpack.build``).
For the same cz/gz/gzt/czp both packages must place every atom and ghost in
the same slot, and every cluster's nine candidate spans must agree exactly
(JAX encodes them in ``pk_meta`` as z0 | L << 12 | d << 20)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from lammps_ucg_dev_tpu.core.state import Box as JBox
from lammps_ucg_dev_tpu.ops import colpack as jcp
from lammps_ucg_dev_tpu_torch.core.state import Box as TBox
from lammps_ucg_dev_tpu_torch.ops import colpack as tcp
from lammps_ucg_dev_tpu_torch.ops import neighbor as tnb
from test_torch_core import one_torch_thread  # noqa: F401

RC, SKIN = 2.5, 0.4


def config(rng, kind):
    if kind == "uniform":                  # the flagship's start: rho 0.6
        n = 1024
        L = (n / 0.6) ** (1 / 3)
        return rng.uniform(0, L, (n, 3)), L
    n, L = 768, 12.5
    x = np.asarray(helpers.random_fluid(rng, n, L, min_sep=0.8))
    if kind == "boundary_heavy":
        # atoms piled against the z faces exercise ghost copies both ways
        x[:, 2] = np.mod(x[:, 2] * 0.3 + L - 1.0, L)
    return x, L


@pytest.mark.parametrize("kind,dtype", [("uniform", "float32"),
                                        ("uniform", "float64"),
                                        ("random", "float64")])
def test_build_matches_jax_exactly(rng, kind, dtype):
    x, L = config(rng, kind)
    x = x.astype(dtype)
    jspec = jcp.measure_spec(x.astype(np.float64), [L] * 3, RC, SKIN)
    assert jspec.NV > 0
    jcl = jax.jit(lambda xx, box: jcp.build(xx, box, jspec))(
        jnp.asarray(x), JBox.create([0, 0, 0], [L] * 3,
                                    dtype=getattr(jnp, dtype)))
    tspec = tcp.ColumnSpec(cutoff=RC, skin=SKIN, mx=jspec.mx, my=jspec.my,
                           cz=jspec.cz, gz=jspec.gz, gzt=jspec.gzt,
                           czp=jspec.czp)
    tcl = tcp.build(torch.as_tensor(x),
                    TBox.create([0, 0, 0], [L] * 3,
                                dtype=getattr(torch, dtype)), tspec)
    for name in ("slot_atom_ext", "zshift", "atom_slot", "i_valid"):
        np.testing.assert_array_equal(getattr(tcl, name).numpy(),
                                      np.asarray(getattr(jcl, name)),
                                      err_msg=name)
    cpc = tcl.z0.shape[1]
    code = np.asarray(jcl.pk_meta)[:, :cpc * 9].reshape(tcl.z0.shape)
    span = (code >> 12) & 255
    np.testing.assert_array_equal(tcl.L.numpy(), span)
    # an empty span has code 0 in JAX; its start is immaterial
    np.testing.assert_array_equal(np.where(span > 0, tcl.z0.numpy(), 0),
                                  np.where(span > 0, code & 4095, 0))
    assert bool(tcl.overflow) == bool(jcl.overflow) is False


def expand_candidates(cl):
    """Per cluster, (atom id, z image) of each candidate (numpy)."""
    sten, _, _ = tcp.stencil(cl.mx, cl.my)
    sae = cl.slot_atom_ext.numpy().reshape(cl.ncol, cl.czp)
    zsh = cl.zshift.numpy().reshape(cl.ncol, cl.czp)
    z0, span = cl.z0.numpy(), cl.L.numpy()
    out = {}
    for c in range(cl.ncol):
        for b in range(cl.cz // 8):
            sl = [(sten[c, s], slice(z0[c, b, s], z0[c, b, s] + span[c, b, s]))
                  for s in range(9)]
            out[c * (cl.cz // 8) + b] = (
                np.concatenate([sae[k, q] for k, q in sl]),
                np.concatenate([zsh[k, q] for k, q in sl]))
    return out


@pytest.mark.parametrize("kind", ["random", "uniform", "boundary_heavy"])
def test_spans_cover_every_pair_once(rng, kind):
    """Every pair within cutoff+skin is a candidate of the i-atom's cluster,
    and no (atom, z image) is a candidate twice.  The same atom may appear
    as itself and as a ghost copy: Lz >= 2(cutoff+skin) puts at most one of
    those images within reach."""
    x, L = config(rng, kind)
    xt = torch.as_tensor(x)
    box = TBox.create([0, 0, 0], [L] * 3, dtype=torch.float64)
    spec = tcp.measure_spec(x, [L] * 3, RC, SKIN)
    cl = tcp.build(xt, box, spec)
    assert not bool(cl.overflow)
    n = x.shape[0]
    ref = tnb.build_nsq(xt, box, tnb.NeighborSpec(cutoff=RC, skin=SKIN,
                                                  capacity=300))
    cands = expand_candidates(cl)
    slot = cl.atom_slot.numpy()
    for i in range(n):
        ids, img = cands[slot[i] // 8]
        assert np.all(ids < n), f"atom {i}: a pad is a candidate"
        need = set(ref.idx[i][ref.idx[i] < n].tolist())
        assert not need - set(ids.tolist()), f"atom {i}: dropped pairs"
        keys = set(zip(ids.tolist(), img.tolist()))
        assert len(keys) == len(ids), f"atom {i}: duplicate candidates"
    assert int(cl.max_occupancy) == max(len(v[0]) for v in cands.values())


def test_measure_spec_rejects_small_boxes():
    with pytest.raises(ValueError):
        tcp.measure_spec(np.zeros((4, 3)), [6.0, 6.0, 20.0], RC, SKIN)
    with pytest.raises(ValueError):
        tcp.measure_spec(np.zeros((4, 3)), [20.0, 20.0, 5.0], RC, SKIN)


def test_pack_shapes_and_validity(rng):
    x, L = config(rng, "random")
    n = x.shape[0]
    box = TBox.create([0, 0, 0], [L] * 3, dtype=torch.float64)
    cl = tcp.build(torch.as_tensor(x), box,
                   tcp.measure_spec(x, [L] * 3, RC, SKIN))
    lam = torch.as_tensor(rng.uniform(0, 1, n))
    st = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32)
    ipack, cols = tcp.pack(cl, box, torch.as_tensor(x), lam, st)
    assert ipack.shape == (cl.n_slots, 8) and ipack.dtype == torch.float32
    assert cols.shape == (cl.ncol, 8, cl.czp) and cols.is_contiguous()
    assert int((ipack[:, 5] > 0.5).sum()) == n           # n real i-slots
    back = ipack[cl.atom_slot].numpy()
    np.testing.assert_allclose(back[:, :3], x, atol=1e-5)
    np.testing.assert_allclose(back[:, 3], lam.numpy(), atol=1e-6)
    # pads are poisoned far away, ghosts carry z shifted by ±Lz
    pads = cl.slot_atom_ext.numpy() == n
    flat = cols.transpose(1, 2).reshape(-1, 8).numpy()
    assert np.all(flat[pads, 0] == np.float32(tcp._PAD_POISON))
    zs = cl.zshift.numpy()
    sae = cl.slot_atom_ext.numpy()
    for s in (-1, 1):
        m = zs == s
        np.testing.assert_allclose(flat[m, 2], x[sae[m], 2] + s * L,
                                   atol=1e-5)
