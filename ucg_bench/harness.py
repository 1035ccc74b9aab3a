"""One run of one cell: the deck from the seed, the deck's lines through the
program's ``ScriptRunner``, a warm-up ``run``, the
timed window (one ``Simulation.run`` of the simulation the runner built,
with the deck's thermo cadence and, in config 4, its events), then the
check of ``correct`` against the plain reference and the metrics.

A cell on several cards starts one process a card (``parallel/launch``,
NCCL); each runs the same deck with its ``processors`` line, and rank 0
reports.  Everything here is driven by the cell's files: the
configuration, the traffic and the metrics' readers are found by name.
"""

from __future__ import annotations

import gc
import importlib
import json
import shlex
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ucg_bench import check
from ucg_bench.gen import decks
from ucg_bench.nojax import ForbiddenLoaded, forbidden_loaded
from ucg_bench.spans import Instruments

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def say(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def deck_commands(script: str) -> list:
    """The deck's commands: everything a run sets up before its ``run``
    (a template has no ``run`` line; the harness gives the runs)."""
    cmds = []
    for raw in open(script).read().splitlines():
        line = raw.split("#")[0].strip()
        if line:
            cmds.append(line)
    if any(shlex.split(c)[0] == "run" for c in cmds):
        raise ValueError(f"{script}: a deck template has no run line")
    return cmds


def plan(seed: int, n_blocks: int, per_thermo: int, trace: bool,
         events: int) -> dict:
    """Which blocks the traced and counted sub-windows cover (one thermo
    interval each, whole blocks, in the window's middle), which block and
    which event are checked (drawn from the seed, outside the
    sub-windows)."""
    rng = np.random.default_rng([int(seed), 7])
    p = {"trace_blocks": None, "stats_blocks": None, "event": None}
    skip = set()
    if trace:
        k0 = per_thermo * max(1, (n_blocks // per_thermo) // 2 - 1)
        p["trace_blocks"] = (k0, per_thermo)
        p["stats_blocks"] = (k0 + per_thermo, per_thermo)
        skip = set(range(k0, k0 + 2 * per_thermo + 1))
    free = [b for b in range(n_blocks) if b not in skip] or [n_blocks - 1]
    p["check_block"] = int(free[int(rng.integers(len(free)))])
    if events:
        p["event"] = int(rng.integers(events))
    return p


def window_steps(rate: float, seconds: float, every: int, min_blocks: int):
    """The window's steps: the traffic's fixed rate times ``--seconds``, in
    whole blocks, so that every run of a cell does the same work whatever
    the program's speed."""
    n = int(rate * seconds) // every * every
    return max(n, min_blocks * every)


def _events_in(step0: int, n: int, every: int, freq: int) -> int:
    return sum(1 for s in range(step0, step0 + n, every)
               if s > 0 and s % freq == 0)


# ---- one rank -----------------------------------------------------------

def run_rank(rank: int, world: int, device: str, job: dict) -> dict:
    """The deck, the warm-up, the window and the captures on this rank;
    rank 0 also judges ``correct``.  Returns this rank's readings, with
    the forbidden modules its process holds once all that is done."""
    out = _run_rank(rank, world, device, job)
    out["forbidden"] = forbidden_loaded()
    return out


def _run_rank(rank: int, world: int, device: str, job: dict) -> dict:
    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner

    if job.get("hook"):
        mod, fn = job["hook"].split(":")
        getattr(importlib.import_module(mod), fn)()
    cuda = str(device).startswith("cuda")
    dev = torch.device(device)
    rank0 = rank == 0
    log = (lambda m: print(m, flush=True)) if rank0 else (lambda m: None)
    cfg, traffic = job["cfg"], job["traffic"]
    s = cfg["settings"]
    every, cadence = s["reneigh_every"], s["thermo_every"]
    out = {"rank": rank}

    runner = ScriptRunner(workdir=job["deck_dir"], device=device,
                          log_callback=log)
    pre = deck_commands(job["script"])
    t0 = time.perf_counter()
    for line in pre:
        ta = time.perf_counter()
        runner.command(line)
        if line.startswith("read_data"):
            out["read_data_s"] = time.perf_counter() - ta

    made = {}
    make_sim = runner._make_sim

    def timed_make_sim(*a, **k):
        ta = time.perf_counter()
        sim = make_sim(*a, **k)
        setup = sim.setup

        def timed_setup(*sa, **sk):
            r = setup(*sa, **sk)
            _sync(cuda)
            made["setup"] = time.perf_counter() - ta
            del sim.setup                     # only the first setup
            return r
        sim.setup = timed_setup
        return sim
    runner._make_sim = timed_make_sim
    runner.command(f"run {traffic['warmup_steps']}")
    runner._make_sim = make_sim
    sim = runner.sim
    out["sim_setup_s"] = made.get("setup", float("nan"))
    _sync(cuda)
    out["setup_s"] = time.perf_counter() - t0 + job.get("build_s", 0.0)

    n = window_steps(traffic["steps_per_s"], job["seconds"], every,
                     4 * (cadence // every) + 2 if job["trace"] else 2)
    spatial = hasattr(sim, "ring")
    step0 = sim._step if spatial else int(sim.state.step)
    n_ev = (_events_in(step0, n, every, sim.cswitch[1])
            if getattr(sim, "cswitch", None) is not None else 0)
    p = plan(job["seed"], n // every, cadence // every, job["trace"], n_ev)
    inst = Instruments(sim, p, cuda, spans=job["trace"]).install()

    rows = []

    def row(r):
        rows.append(r)
        log("  ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in r.items()))
    _sync(cuda)
    tw = time.perf_counter()
    sim.run(n, thermo_every=cadence, thermo_callback=row)
    inst.stamps.mark()
    _sync(cuda)
    out["window_s"] = time.perf_counter() - tw
    inst.uninstall()
    out["steps"] = n
    out["block_ms"] = inst.stamps.intervals_ms()
    out["events"] = n_ev
    out["sweeps"] = inst.sweeps
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    out["kind"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if inst.prof is not None and inst.trace_s is not None:
        from ucg_bench import trace
        out["trace"] = trace.read(inst.prof)
        out["trace_s"] = inst.trace_s
        out["trace_steps"] = p["trace_blocks"][1] * every
    if inst.ring_stats is not None:
        out["ring_stats"] = inst.ring_stats
        out["stats_steps"] = p["stats_blocks"][1] * every
    out["thermo_last"] = rows[-1] if rows else None

    # ---- the captures, gathered to rank 0 -------------------------------
    if spatial:
        from lammps_ucg_dev_tpu_torch.parallel import spatial as sp
        cols = {name: k for k, name in enumerate(sp._MIG_F)}
        got = {}
        for key, cap in (("in", inst.block_in), ("out", inst.block_out),
                         ("final", {"F": sim._F, "nloc": sim._nloc})):
            got[key] = _gather_rows(cap["F"], cap["nloc"], world)
        tx = (_gather_rows(inst.trace_x["F"], inst.trace_x["nloc"], world)
              if inst.trace_x is not None else None)
        if not rank0:
            return out
        inp = _rows_state(got["in"], cols)
        prog = _rows_state(got["out"], cols)
        prog["pe"] = inst.block_out["pe"]
        final = _rows_state(got["final"], cols)
        gathered = {"x": sim.state.x, "v": sim.state.v,
                    "lam": sim.state.ucgl, "vlam": sim.state.ucgvl,
                    "ucgp": sim.state.ucgp, "typ": sim.state.typ,
                    "tag": sim.state.tag}
        gathered = check.tag_sorted({k: v.clone() for k, v in
                                     gathered.items()})
        gather_gap = max(float((gathered[k].double() - final[k].double())
                               .abs().max()) for k in
                         ("x", "v", "lam", "vlam", "ucgp", "typ", "tag"))
        trace_pos = (None if tx is None else
                     (tx[:, cols["x0"]:cols["x2"] + 1],
                      tx[:, cols["typ"]].round().long()))
        gen_state = inst.block_in["gen"]
        nsteps = inst.block_in["nsteps"]
    else:
        inp = check.tag_sorted(inst.block_in["state"])
        prog = check.tag_sorted(inst.block_out["state"])
        prog["pe"] = inst.block_out["state"]["pe"]
        gen_state = inst.block_in["gen"]
        nsteps = inst.block_in["nsteps"]
        gather_gap = None
        trace_pos = inst.trace_x
    L = sim.state.box.lengths.double().cpu().numpy()
    ev_in, ev_out = inst.event_in, inst.event_out

    # the program's state is freed before the reference runs on the card
    del sim, runner, inst
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from ucg_bench.reference import deck as rdeck
    ph = rdeck.read(job["script"])
    tc = time.perf_counter()
    inp64 = check.as_double(inp)
    ref = check.reference_block(ph, inp64, gen_state, nsteps, L,
                                torch.float64)
    numbers = check.block_gaps(check.as_double(prog), ref, inp64, L)
    if ev_in is not None:
        numbers.update(check.event_gaps(ph, ev_in, ev_out, L))
    if gather_gap is not None:
        numbers["gather_gap"] = gather_gap
    out["check_s"] = time.perf_counter() - tc
    out["numbers"] = numbers
    if job.get("control"):
        out["control"] = control_numbers(ph, inp64, gen_state, nsteps, L,
                                         ref, ev_in)
    if trace_pos is not None:
        from ucg_bench.roofline import count_pairs
        out["pairs"] = count_pairs(ph, trace_pos[0], trace_pos[1], L)
        out["n_atoms"] = int(trace_pos[0].shape[0])
    out["physics_tables"] = (len(ph.tables), len(ph.tables[0][2]))
    return out


def control_numbers(ph, inp64, gen_state, nsteps, L, ref, ev_in,
                    dtype=torch.bfloat16) -> dict:
    """The numbers with the reference in ``dtype`` put in the program's
    place: the control that has to come out as not correct."""
    low = check.reference_block(ph, inp64, gen_state, nsteps, L, dtype)
    numbers = check.block_gaps(low, ref, inp64, L)
    if ev_in is not None:
        from ucg_bench.reference import switch
        typ, in_cluster, _ = switch.event(
            ph.switch, ev_in["x"].double(), ev_in["typ"], ev_in["mol"],
            ev_in["u"], L, dtype)
        numbers.update(check.event_gaps(
            ph, ev_in, {"typ": typ, "in_cluster": in_cluster}, L))
    return numbers


def _gather_rows(F, nloc, world):
    """Every rank's first ``nloc`` rows of ``F``, on rank 0 (None
    elsewhere), by the benchmark's own all-gather."""
    dist = torch.distributed
    pad = torch.zeros((1, F.shape[1]), dtype=F.dtype, device=F.device)
    pad[0, 0] = nloc.to(F.dtype)
    buf = torch.cat([F, pad]).contiguous()
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat([b[:int(round(float(b[-1, 0])))] for b in parts])


def _rows_state(rows, cols) -> dict:
    def c(name):
        return rows[:, cols[name]]
    d = {"x": rows[:, cols["x0"]:cols["x2"] + 1],
         "v": rows[:, cols["v0"]:cols["v2"] + 1],
         "lam": c("ucgl"), "vlam": c("ucgvl"), "ml": c("ucgml"),
         "ucgp": c("ucgp"), "typ": c("typ").round().long(),
         "ucgstate": c("ucgstate").round().long(),
         "tag": c("tag").round().long(),
         "f": rows[:, cols["f0"]:cols["f2"] + 1], "lamforce": c("ucgforce")}
    d["x0"] = d["x"]            # the slab driver builds its list every block
    return check.tag_sorted(d)


# ---- the cell -----------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", n_atoms: int | None = None,
             steps: dict | None = None, control: bool = False,
             calibrate: bool = False, hook: str | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``n_atoms`` and ``steps`` (warm-up and rate steps) shrink the cell for
    the CPU tests; ``calibrate`` adds every number of the check
    (``numbers``) and, with ``control``, the control's (``control``);
    ``hook`` ("module:function") is called on every rank before the deck,
    where the tests plant a fault under the timed path."""
    bench = benchmark()
    cell = cell_of(bench, workload)
    cfg = decks.load_config(cell["config"])
    traffic = dict(decks.load_traffic(cell["traffic"]), **(steps or {}))
    world = int(cell["chips"])
    cuda = str(device).startswith("cuda")
    tmp = tempfile.mkdtemp(prefix="ucg_bench-")
    try:
        d = decks.write_deck(cfg, traffic, seed, tmp, n_atoms=n_atoms)
        say(f"[deck] {cell['config']} n={d['n_atoms']} written in "
            f"{d['write_s']:.3f} s (not in setup_s); seeds {d['seeds']}")
        build_s = 0.0
        if cuda:
            from lammps_ucg_dev_tpu_torch.ops import cuda_lib
            from lammps_ucg_dev_tpu_torch.parallel import launch
            tb = time.perf_counter()
            libs = cuda_lib.build(launch.KERNEL_SOURCES)
            build_s = time.perf_counter() - tb
            say(f"[build] {build_s:.3f} s loading the kernels, nvcc "
                + ", ".join(f"{k} {v.build_seconds:.1f} s"
                            for k, v in libs.items()))
        job = {"cfg": cfg, "traffic": traffic, "deck_dir": tmp,
               "script": d["script"], "seed": seed, "seconds": seconds,
               "trace": trace, "build_s": build_s, "control": control,
               "hook": hook}
        if world == 1:
            ranks = [run_rank(0, 1, device, job)]
        else:
            from lammps_ucg_dev_tpu_torch.parallel import launch
            ranks = launch.start(run_rank, world, job,
                                 backend="nccl" if cuda else "gloo",
                                 device=device, timeout=330.0).join()
        found = {r["rank"]: r["forbidden"] for r in ranks if r["forbidden"]}
        if found:
            raise ForbiddenLoaded(found)
        return result(bench, cell, cfg, ranks, world, trace, cuda,
                      calibrate=calibrate)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def result(bench, cell, cfg, ranks, world, trace, cuda,
           calibrate=False) -> dict:
    r0 = ranks[0]
    ctx = {"cell": cell, "config": cfg, "ranks": ranks, "world": world,
           **{k: r0[k] for k in ("steps", "window_s", "block_ms", "setup_s",
                                 "events", "sweeps")}}
    if "trace" in r0:
        say(f"[trace] {r0['trace_s']:.3f} s, busy {r0['trace']['busy']:.3f} s,"
            f" spans {r0['trace']['span']}, device time with no launch found "
            f"{r0['trace']['unlaunched']:.6f} s")
    say(f"[check] {r0['numbers']}")
    say(f"[window] {r0['steps']} steps in {r0['window_s']:.3f} s, "
        f"{len(r0['block_ms']) + 1} block starts, {r0['events']} events "
        f"(sweeps {r0['sweeps']})"
        f", check {r0['check_s']:.2f} s; last thermo {r0['thermo_last']}")
    want = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[want]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        mod = importlib.import_module(f"ucg_bench.metrics.{m['name']}")
        v = mod.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lim = check.limits(cfg["name"])
    ok, rows = check.judge(r0["numbers"], lim)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": r0["kind"], "count": world,
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    out = {"correct": ok, "attempted": len(rows),
           "failed": sum(1 for _, v, lim_ in rows
                         if not (np.isfinite(v) and v <= lim_)),
           "metrics": metrics, "device": device}
    traced = [r for r in ranks if "trace" in r]
    if trace and traced:
        device["busy_s"] = float(np.mean([r["trace"]["busy"]
                                          for r in traced]))
        device["window_s"] = float(np.mean([r["trace_s"] for r in traced]))
        out["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                            "idle_gaps": r0["trace"]["idle_gaps"]}
    if calibrate:
        out["numbers"] = r0["numbers"]
        out["control"] = r0.get("control")
    out["compared"] = {name: {"value": v, "limit": lim_}
                       for name, v, lim_ in rows}
    for name, v, lim_ in rows:
        say(f"{name} {v!r} limit {lim_!r}")
    return out
