"""Kernel-only ablation microbench of K1 (port of the JAX package's
``tools/kbench.py``).

Times K7 (``ops/hopper_ablation.py``, ``csrc/ucgld_ablation.cu``) bare, on
K1's no-scores inputs staged once, at increasing physics levels, to split
the gap between K1's bound and its measured time:

  L0  the tile walk's loads: one load and one add per candidate and
      cluster (no cutoff test)
  L1  + geometry: dx/dy/dz, rsq and the cutoff test against the cluster's
      8 i-slots, the queue of hits and the sums of full-warp batches
  L2  + the u map and the Chebyshev recurrence
  L3  + the six D-form accumulators
  L4  + the D-form mix and the force and λ-force tallies (K1 no-scores)
  prod  ``hopper_pair.compute`` without observables or scores: pack + K1 +
        the slot→atom take

Usage (needs a CUDA device)::

    python -m lammps_ucg_dev_tpu_torch.tools.kbench [--n 262144] [--reps 30]
        [--levels 0,1,2,3,4,prod]

Prints an info line (the card's name and power limit, the geometry), then
one JSON line per level: ms per launch, ns per atom and ns per 128
i-slots (``ns_block``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.ops import colpack
from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.tools.timing import card, cuda_ms

BLOCK = 128            # i-slots per unit of ns_block (16 clusters)
LEVELS = ("0", "1", "2", "3", "4", "prod")


def staged(sim):
    """``sim``'s state wrapped into the box and a fresh column list: the
    inputs every level reads (``sim`` is a K1 path of ``flagship.build_sim``)."""
    if not isinstance(sim.nbr_spec, colpack.ColumnSpec):
        raise ValueError("kbench needs the K1 column path")
    state = sim.state
    state = dataclasses.replace(state, x=state.box.wrap(state.x))
    cl = colpack.build(state.x, state.box, sim.nbr_spec)
    if bool(cl.overflow):
        raise RuntimeError("column list overflow")
    return state, cl


def run(sim, levels=LEVELS, reps: int = 30) -> list[dict]:
    """Time each level of ``levels`` on ``sim``'s staged inputs; one row
    per level."""
    if not torch.cuda.is_available() or sim.state.device.type != "cuda":
        raise RuntimeError("kbench times kernels on a CUDA device")
    state, cl = staged(sim)
    params, cheb = sim.pair_params, sim.pair_params.cheb
    args, kw = ha.kernel_inputs(state, cl, params, cheb)
    n, n_blocks = state.n_atoms, -(-cl.n_slots // BLOCK)
    rows = []
    for lv in levels:
        if lv == "prod":
            def fn():
                return hp.compute(state, cl, params, cheb, observe=False,
                                  want_scores=False)
        else:
            def fn(level=int(lv)):
                return ha.ucgld_ablation(*args, **kw, level=level)
        ms = cuda_ms(fn, reps, warmup=2)
        rows.append({"level": lv if lv == "prod" else int(lv), "ms": ms,
                     "ns_atom": ms * 1e6 / n, "ns_block": ms * 1e6 / n_blocks})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--levels", default=",".join(LEVELS))
    a = ap.parse_args(argv)
    levels = a.levels.split(",")
    bad = [lv for lv in levels if lv not in LEVELS]
    if bad:
        raise SystemExit(f"unknown levels {bad}; choose from {LEVELS}")
    if not torch.cuda.is_available():
        raise SystemExit("kbench: no CUDA device")
    sim = flagship.build_sim(n=a.n, device="cuda", reneigh_every=20)
    sim.setup((0, 1000))
    _, cl = staged(sim)
    print(json.dumps({"n": a.n, "card": card(),
                      "kind": torch.cuda.get_device_name(0), "ncol": cl.ncol,
                      "cz": cl.cz, "czp": cl.czp, "n_slots": cl.n_slots,
                      "blocks": -(-cl.n_slots // BLOCK),
                      "degree": sim.pair_params.cheb.degree}), flush=True)
    for row in run(sim, levels, a.reps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
