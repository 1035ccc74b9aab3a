"""Where the UCG-LD deck's steps/s differ from the flagship builder's: the
two systems and the steps between them, one difference at a time, on one
card in one call.

    python -m lammps_ucg_dev_tpu_torch.tools.deckgap [--n 1048576]
        [--steps 200] [--turns 2]

The systems, all at ``--n`` beads on K1's slot-major path:

* ``builder r20``: ``flagship.build_sim(reneigh_every=20)``, the builder
  path of ``chip_smoke.py``'s phase 4 (uniform random start, ``linear
  1000`` tables);
* ``builder r10``: the same, rebuilt every 10 steps (the deck's cadence);
* ``deck r10 t2000``: ``tools.make_deck.write_ucgld_deck`` as written
  (jittered lattice start, ``neigh_modify every 10``, ``linear 2000``),
  set up by ``ScriptRunner`` with ``run 0``;
* ``deck r20 t2000``, ``deck r10 t1000``, ``deck r20 t1000``: the deck
  with ``neigh_modify every 20`` and/or ``linear 1000``;
* ``relaxed r20 t1000``: ``deck r20 t1000`` started from the data file
  that ``write_data`` wrote after 200 of its steps (the column list's
  spec is measured from those positions, not from the lattice).

Each system takes one warm block; then, in each turn (the systems in
order, then reversed, and so on), ``--steps`` steps by ``run_fused`` (the
builder's loop) and ``--steps`` steps by ``Simulation.run(100)`` calls
(the deck's loop at its thermo and dump cadence, without the rows and
frames), each between two CUDA synchronizes; and K1's full and no-scores
launches on the state reached (CUDA events, 20 launches each).  Prints the
card's name and power limit, one JSON line per system and turn, and one
JSON line per system with the means and the state's Chebyshev degree,
column spec, column slots, candidates and in-cutoff pairs.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.tools import make_deck
from lammps_ucg_dev_tpu_torch.tools.kbench import staged
from lammps_ucg_dev_tpu_torch.tools.timing import card, cuda_ms
from lammps_ucg_dev_tpu_torch.utils.profiling import Throughput

DECK_DIR = Path(__file__).resolve().parents[2] / "_decks" / "deckgap"
CHUNK = 100        # the deck's thermo and dump cadence


def variant(text: str, reneigh: int, tablength: int, run: str) -> str:
    return (text.replace("neigh_modify every 10",
                         f"neigh_modify every {reneigh}")
                .replace("linear 2000", f"linear {tablength}")
                .replace("run 200", run))


def deck_sim(text: str):
    """The Simulation of the deck ``text`` (which ends in ``run 0``)."""
    r = ScriptRunner(workdir=str(DECK_DIR), log_callback=lambda m: None)
    r.run_string(text)
    if r.sim.pair_compute is not hp.compute_style or not r.sim._slot_ok:
        raise RuntimeError(f"the deck did not take K1 slot-major: "
                           f"{r.pair_path}")
    return r.sim


def k1_ms(sim) -> dict:
    state, cl = staged(sim)
    params = sim.pair_params
    out = {}
    for name, (observe, scores) in (("full", (True, True)),
                                    ("noscores", (False, False))):
        args, kw = hp.kernel_inputs(state, cl, params, params.cheb, observe,
                                    scores)
        out[f"k1_{name}_ms"] = cuda_ms(lambda: hp.ucgld_pair(*args, **kw),
                                       reps=20, warmup=2)
    return out


def workload(sim) -> dict:
    """Chebyshev degree, column slots, candidates and in-cutoff pairs of
    K1 on ``sim``'s current state (the twins' span walk)."""
    state, cl = staged(sim)
    params = sim.pair_params
    args, kw = hp.kernel_inputs(state, cl, params, params.cheb, True, True)
    scal, z0, span_len, ipack, cols = args[:5]
    pairs = sum(int(mask.sum()) for *_, mask in hp.span_pairs(
        scal, z0, span_len, ipack, cols, mx=kw["mx"], my=kw["my"],
        observe=True))
    per_slot = span_len.sum(-1).reshape(-1).repeat_interleave(8)
    cand = int((per_slot * (ipack[:, 5] > 0.5)).sum())
    spec = sim.nbr_spec
    return {"cheb_degree": int(params.cheb.degree),
            "spec": [spec.mx, spec.my, spec.cz, spec.gz, spec.gzt, spec.czp],
            "n_slots": cl.n_slots,
            "candidates": cand, "pairs": pairs}


def turn(sim, steps: int) -> dict:
    n = sim.state.n_atoms
    fused = Throughput(n)
    with fused:
        sim.run_fused(steps // sim.cfg.reneigh_every)
    fused.add_steps(steps // sim.cfg.reneigh_every * sim.cfg.reneigh_every)
    loop = Throughput(n)
    with loop:
        for _ in range(steps // CHUNK):
            sim.run(CHUNK)
    loop.add_steps(steps // CHUNK * CHUNK)
    return {"run_fused_steps_s": fused.steps_per_sec,
            "run_steps_s": loop.steps_per_sec, **k1_ms(sim),
            "dangerous_builds": sim.dangerous_builds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deckgap: no CUDA device")
    print(card(), flush=True)
    t0 = time.perf_counter()
    shutil.rmtree(DECK_DIR, ignore_errors=True)
    text = open(make_deck.write_ucgld_deck(str(DECK_DIR), n=args.n,
                                           nsteps=200)).read()
    sims = {
        "builder r20": flagship.build_sim(n=args.n, reneigh_every=20),
        "builder r10": flagship.build_sim(n=args.n, reneigh_every=10),
    }
    for r in (10, 20):
        for t in (2000, 1000):
            sims[f"deck r{r} t{t}"] = deck_sim(variant(text, r, t, "run 0"))
    relax = ScriptRunner(workdir=str(DECK_DIR), log_callback=lambda m: None)
    relax.run_string(variant(text, 20, 1000,
                             "run 200\nwrite_data relaxed.data"))
    del relax
    sims["relaxed r20 t1000"] = deck_sim(
        "\n".join(ln for ln in variant(text, 20, 1000, "run 0").splitlines()
                  if not ln.startswith("velocity")).replace(
            "read_data system.data", "read_data relaxed.data"))
    for sim in sims.values():
        sim.run_fused(1)                                 # warm block
    torch.cuda.synchronize()
    print(f"systems built and warmed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = {name: [] for name in sims}
    order = list(sims)
    for k in range(args.turns):
        for name in (order if k % 2 == 0 else order[::-1]):
            row = turn(sims[name], args.steps)
            rows[name].append(row)
            print(json.dumps({"system": name, "turn": k, **row}), flush=True)
    for name, sim in sims.items():
        keys = [k for k in rows[name][0] if k != "dangerous_builds"]
        mean = {k: sum(r[k] for r in rows[name]) / len(rows[name])
                for k in keys}
        print(json.dumps({"system": name, "mean": mean, **workload(sim)}),
              flush=True)
    shutil.rmtree(DECK_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
