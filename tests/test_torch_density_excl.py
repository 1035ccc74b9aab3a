"""The density styles' special exclusions on the kernel path (P3 K5 → K3 →
K6, P4 K5 → K4 → K6, here through the kernels' CPU twins in float32): the
entries take the special lists (``excl_rows=``) and subtract each pass's
sums over them after it, ρ and the count before the priors read them.

Held against the port's reference pair path in float32 on the same
inputs, whose list leaves the specials out, at the kernel-vs-reference
gates of ``chip_smoke.check_density_oracle`` (the JAX package's
kernel-vs-XLA gates): f within 1e-4 of max|f|, pe 3e-5 relative, the
virial 1e-4 of its largest component, P3's scores and posterior 5e-5
(measured: f 3.3e-6 / 4.5e-6, pe 7e-8 / 0, scores 6.7e-6), and the same
out-of-table count.
The specials are each atom's nearest neighbour for 96 atoms, so they sit
well inside the cutoff: leaving the subtraction out misses those gates
by orders of magnitude (checked too)."""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.models import pair_bethe_density as pbd
from lammps_ucg_dev_tpu_torch.models import pair_rleucg as pr4
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr
from lammps_ucg_dev_tpu_torch.ops import neighbor as nb
from lammps_ucg_dev_tpu_torch.runtime.sim import excl_route
from test_torch_core import one_torch_thread  # noqa: F401

N = 512
STYLES = {"p3": (flagship.build_density_sim, pbd.compute,
                 hd.compute_style_density),
          "p4": (flagship.build_rleucg_sim, pr4.compute,
                 hr.compute_style_rleucg)}


def special_rows(state, count: int = 96) -> torch.Tensor:
    """(N, S) symmetric special lists as rows (N where empty): atom i and
    its nearest neighbour, for the first ``count`` atoms."""
    x = state.x.double()
    dr = state.box.min_image(x[:, None, :] - x[None, :, :])
    rsq = (dr * dr).sum(-1)
    rsq.fill_diagonal_(float("inf"))
    near = rsq.argmin(1).numpy()
    lists = [set() for _ in range(state.n_atoms)]
    for i in range(count):
        lists[i].add(int(near[i]))
        lists[int(near[i])].add(i)
    S = max(len(v) for v in lists)
    rows = np.full((state.n_atoms, S), state.n_atoms, np.int64)
    for i, v in enumerate(lists):
        rows[i, :len(v)] = sorted(v)
    return torch.as_tensor(rows)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_density_excl_delta_matches_reference_without_specials(style):
    build, ref_fn, entry = STYLES[style]
    ker = build(n=N, device="cpu", kernel=True)
    assert ker.pair_compute is entry and excl_route(entry) == "rows"
    state = dataclasses.replace(ker.state, x=ker.state.box.wrap(ker.state.x))
    cl = colpack.build(state.x, state.box, ker.nbr_spec)
    rows = special_rows(state)
    ref = build(n=N, device="cpu", kernel=False)
    spec = nb.make_spec(N, state.box.lengths.numpy(), flagship.RC, 0.4,
                        method="nsq")
    fr = ref_fn(state, nb.build(state.x, state.box, spec, excl=rows),
                ref.pair_params)
    fields = ("scores", "ucgp") if style == "p3" else ()

    def errs(fk):
        scale = float(fr.f.abs().max())
        e = {"f": float((fk.f - fr.f).abs().max()) / scale,
             "pe": abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe)),
             "virial": float((fk.virial - fr.virial).abs().max()
                             / fr.virial.abs().max())}
        for name in fields:
            e[name] = float((getattr(fk, name) - getattr(fr, name))
                            .abs().max())
        return e

    gates = {"f": 1e-4, "pe": 3e-5, "virial": 1e-4, "scores": 5e-5,
             "ucgp": 5e-5}
    out = entry(state, cl, ker.pair_params, excl_rows=rows)
    got = errs(out)
    assert all(v <= gates[k] for k, v in got.items()), got
    assert int(out.oob_low) == int(fr.oob_low)
    # the fast entries subtract too: the same forces
    fast = entry.fast_variant(state, cl, ker.pair_params, excl_rows=rows)
    assert float((fast.f - fr.f).abs().max()) <= 1e-4 * float(
        fr.f.abs().max())
    # and the specials matter: without the subtraction the gates fail
    missed = errs(entry(state, cl, ker.pair_params))
    assert missed["f"] > 100 * gates["f"], missed
