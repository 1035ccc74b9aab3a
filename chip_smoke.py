#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths on the card — the flagship 2-state UCG-LD
fluid (``flagship.build_sim``, kernel K1 ``csrc/ucgld_pair.cu``) and the
config-3 self-consistent Bethe fluid (``flagship.build_bethe_sim``, kernel
K2 ``csrc/bethe_pair.cu``), both at 2^20 beads through ``Simulation`` —
after building both kernels with nvcc (one process per source, started
together) into ``lammps_ucg_dev_tpu_torch/_build/``.  Phases, each of which
raises on failure:

1. the card's name and power limit, torch and CUDA versions;
2. the kernels' build;
3. K1 against its plain PyTorch twin in all three variants on the same
   inputs, at 32,768 beads and at the main path's 2^20, with both times;
   then the K1 path against the float64 reference pair path on 4,096;
4. the UCG-LD main path: setup, one warm block, five timed blocks of 20
   steps, with K1's launch counts set to 0 just before and read just after;
5. the NVE energy drift by the JAX package's ``bench.run_drift`` protocol
   (32,768 beads, Langevin off, dt 0.002, 1 + 19 blocks of 10 steps);
6. K2 against its twin: bethe pseudolikelihood full and fast at 32,768 and
   2^20, mf and full-SCE full and fast at 32,768, every variant on a 2-type
   mixed system of 8,192;
7. the K2 path against the float64 reference pair path on 4,096;
8. the Bethe main path: setup, one warm block, twenty timed blocks of 5
   steps, with K2's launch counts set to 0 just before and read just after.

The line before the last is a JSON object of the kernels on the main paths
(times, errors, launches and the bound each kernel's work puts on its time);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

K1_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/ucgld_pair.cu"
K2_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/bethe_pair.cu"
REPLACES = "lammps_ucg_dev_tpu/ops/pallas_pair.py:719"
TOL = 2e-5       # kernel vs twin: f32 sums taken in another order (see below)
DRIFT_MAX = 1e-4
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- the least time the card needs for a kernel's work ---------------------

def kernel_ops(kernel: str, kw: dict, nrow: int) -> tuple[float, float]:
    """(operations per candidate, operations per in-cutoff pair) of one
    kernel variant: each add, multiply, divide, compare-select, exp or sqrt
    one operation, an FMA two.  A candidate costs its distance test (10);
    a pair the u map (2), the Chebyshev rows (2 per row to start, then 2 +
    2 per row for each further degree), and the style's mixing and tallies
    as written in the kernel source."""
    degree = kw["degree"]
    series = 2 + 2 * nrow + (degree - 2) * (2 + 2 * nrow)
    tail = 12                                     # fmix + three force sums
    if kw["observe"]:
        tail += 26                                # pe, 6 virial sums, oob
    if kernel == "ucgld":
        tail += 4 + (8 if kw["want_scores"] else 0)   # λ-force, scores
    else:
        if not kw["mf"]:
            tail += 22                            # xk, exp, Q, D, sqrt, root
        tail += 21 if kw["sce"] else 8            # conditional or pseudo
    return 10.0, float(series + tail)


def bound(kernel: str, args, kw, nrow: int) -> dict:
    """Least time of one launch on these inputs: the larger of its
    operations (this data's candidates and in-cutoff pairs, counted by the
    twins' span walk) over the f32 peak and its bytes (every input read
    once, every output written once) over the memory rate."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    scal, z0, span_len, ipack, cols = args[:5]
    pairs = 0
    for *_, mask in hp.span_pairs(scal, z0, span_len, ipack, cols,
                                  mx=kw["mx"], my=kw["my"],
                                  observe=kw["observe"]):
        pairs += int(mask.sum())
    per_slot = span_len.sum(-1).reshape(-1).repeat_interleave(8)
    cand = int((per_slot * (ipack[:, 5] > 0.5)).sum())
    per_cand, per_pair = kernel_ops(kernel, kw, nrow)
    ops = cand * per_cand + pairs * per_pair
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    nbytes += ipack.numel() * 4 * (2 if kw["observe"] else 1)
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    r = {"bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "pairs": pairs, "candidates": cand, "ops": ops, "bytes": nbytes}
    log(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}: {pairs} pairs "
        f"of {cand} candidates, {ops:.4e} operations, {nbytes} bytes")
    return r


# ---- a kernel against its twin ---------------------------------------------

def hold(label: str, name: str, kernel, twin, to_fout, fields, args, kw,
         observe: bool, kernel_reps: int, twin_reps: int) -> dict:
    """One kernel variant against its twin on the same CUDA tensors.
    Tolerances (both sides f32, the same algorithm; they differ by FMA
    contraction and summation order): each field within TOL times its
    largest magnitude, pe within TOL relative, the virial within TOL times
    its largest component, oob exactly."""
    import torch

    # time the kernel before the twin has run on the card
    ms = cuda_ms(lambda: kernel(*args, **kw), kernel_reps, warmup=3)
    out_k, part_k = kernel(*args, **kw)
    out_t, part_t = twin(*args, **kw)
    torch.cuda.synchronize()
    fk, ft = to_fout(out_k, part_k), to_fout(out_t, part_t)
    errs = {}
    for field in fields:
        a, b = getattr(fk, field), getattr(ft, field)
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{label} {name}: non-finite {field}")
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        errs[field] = err / scale
        if err > TOL * scale:
            raise RuntimeError(f"{label} {name}: {field} differs by "
                               f"{err:.3e} (scale {scale:.3e})")
    if observe:
        pe_err = abs(float(fk.pe) - float(ft.pe)) / abs(float(ft.pe))
        vscale = float(ft.virial.abs().max())
        v_err = float((fk.virial - ft.virial).abs().max()) / vscale
        errs.update(pe=pe_err, virial=v_err)
        if pe_err > TOL or v_err > TOL:
            raise RuntimeError(f"{label} {name}: pe/virial differ "
                               f"({pe_err:.3e}, {v_err:.3e})")
        if int(fk.oob_low) != int(ft.oob_low):
            raise RuntimeError(f"{label} {name}: oob_low differs")
    max_abs = float((out_k - out_t).abs().max())
    plain_ms = cuda_ms(lambda: twin(*args, **kw), twin_reps)
    log(f"[{label}] {name:14s} vs twin: max|out diff| {max_abs:.3e}, "
        f"rel errs {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "rel_err": errs}


def column_state(sim):
    """``sim``'s state wrapped into the box and a fresh column list."""
    from lammps_ucg_dev_tpu_torch.ops import colpack

    state = sim.state
    x_w, _ = state.box.wrap(state.x, state.image)
    state = dataclasses.replace(state, x=x_w)
    cl = colpack.build(state.x, state.box, sim.nbr_spec)
    if bool(cl.overflow):
        raise RuntimeError("column list overflow")
    return state, cl


def compare_k1(sim, label: str, kernel_reps: int, twin_reps: int,
               with_bound: bool = False):
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state, cl = column_state(sim)
    params, cheb = sim.pair_params, sim.pair_params.cheb
    res = {}
    for name, observe, scores in (("full", True, True),
                                  ("fast", False, True),
                                  ("noscores", False, False)):
        args, kw = hp.kernel_inputs(state, cl, params, cheb, observe, scores)
        res[name] = hold(
            label, f"K1 {name}", hp.ucgld_pair, hp.ucgld_pair_reference,
            lambda o, p, _o=observe, _s=scores: hp.force_out(
                o, p, state, cl, params, _o, _s),
            ("f", "ucgforce", "scores"), args, kw, observe, kernel_reps,
            twin_reps)
        if with_bound:
            res[name].update(bound("ucgld", args, kw, args[5].shape[0]))
    return res


def compare_k2(state, cl, params, label: str, variants, kernel_reps: int,
               twin_reps: int, with_bound: bool = False):
    """K2 against its twin; ``variants`` holds (method, pseudo, observe)."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb

    res = {}
    for method, pseudo, observe in variants:
        p = dataclasses.replace(params, method=method, pseudo=pseudo)
        args, kw = hb.kernel_inputs(state, cl, p, p.cheb, observe)
        name = (f"{method}/{'pseudo' if pseudo else 'sce'}/"
                f"{hb.variant(observe)}")
        res[name] = hold(
            label, f"K2 {name}", hb.bethe_pair, hb.bethe_pair_reference,
            lambda o, q, _p=p, _o=observe: hb.force_out(
                o, q, state, cl, _p, _o),
            ("f", "scores"), args, kw, observe, kernel_reps, twin_reps)
        if with_bound:
            res[name].update(bound("bethe", args, kw, args[5].shape[0]))
    return res


# ---- the kernel paths against the float64 reference paths ------------------

def check_k1_oracle(device: str, n: int = 4096) -> None:
    """One force evaluation of the K1 path (f32, on the card) against the
    float64 reference pair path on the CPU, same system: agreement to the
    Chebyshev fit gate (the fit's max relative error is < 1e-4)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    ker = flagship.build_sim(n=n, device=device)
    if ker.pair_compute is not hp.compute_style:
        raise RuntimeError("kernel path was not selected for the oracle check")
    ref = flagship.build_sim(n=n, dtype=torch.float64, kernel=False,
                             device="cpu")
    for s in (ker, ref):       # no thermostat noise: the draws differ
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
    fk, fr = ker.setup((0, 10)), ref.setup((0, 10))
    f_k, f_r = fk.f.double().cpu(), fr.f
    scale = float(f_r.abs().max())
    f_err = float((f_k - f_r).abs().max()) / scale
    pe_err = abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe))
    lam_err = float((fk.ucgforce.double().cpu() - fr.ucgforce).abs().max())
    log(f"[K1 oracle n={n}] kernel path (f32) vs reference path (f64): "
        f"f rel {f_err:.3e}, pe rel {pe_err:.3e}, ucgforce abs {lam_err:.3e}")
    if f_err > 3e-5 or pe_err > 1e-5 or lam_err > 1e-4:
        raise RuntimeError("K1 path disagrees with the reference path")


def check_k2_oracle(device: str, n: int = 4096) -> None:
    """The K2 path (f32, on the card) against the float64 reference pair
    path ``pair_bethe.compute`` on the CPU, same system, at the JAX
    package's kernel-vs-XLA gate (f 5e-5 of max|f|, pe 3e-5 relative,
    scores 3e-5 absolute): once at setup (priors from the chemical
    potentials) and once on the state after it (priors from ucgp)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb

    ker = flagship.build_bethe_sim(n=n, device=device)
    if ker.pair_compute is not hb.compute_style_bethe:
        raise RuntimeError("K2 path was not selected for the oracle check")
    ref = flagship.build_bethe_sim(n=n, dtype=torch.float64, kernel=False,
                                   device="cpu")
    for s in (ker, ref):
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
    outs = [(ker.setup((0, 10)), ref.setup((0, 10)), "setup")]
    f32 = {f.name: getattr(ref.state, f.name).to(device)
           for f in dataclasses.fields(ref.state)
           if isinstance(getattr(ref.state, f.name), torch.Tensor)}
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in f32.items()}
    box = dataclasses.replace(ref.state.box, lo=ref.state.box.lo.float().to(device),
                              hi=ref.state.box.hi.float().to(device))
    s32 = dataclasses.replace(ref.state, box=box, **f32)
    outs.append((ker.pair_compute(s32, ker._nbr, ker.pair_params),
                 ref.pair_compute(ref.state, ref._nbr, ref.pair_params),
                 "assigned"))
    for fk, fr, what in outs:
        scale = float(fr.f.abs().max())
        f_err = float((fk.f.double().cpu() - fr.f).abs().max()) / scale
        pe_err = abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe))
        s_err = float((fk.scores.double().cpu() - fr.scores).abs().max())
        log(f"[K2 oracle n={n}, {what} priors] kernel path (f32) vs "
            f"reference path (f64): f rel {f_err:.3e}, pe rel {pe_err:.3e}, "
            f"scores abs {s_err:.3e}")
        if f_err > 5e-5 or pe_err > 3e-5 or s_err > 3e-5:
            raise RuntimeError("K2 path disagrees with the reference path")


def finite_row(row: dict) -> bool:
    return all(v == v and abs(v) != float("inf")
               for v in row.values() if isinstance(v, float))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build K1 and K2 (one nvcc each, together) -------------------
    t0 = time.perf_counter()
    libs = cuda_lib.build(["ucgld_pair", "bethe_pair"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, nl in libs.items():
        log(f"  {name}: nvcc {nl.build_seconds:.1f} s -> {nl.path.name}")
        for line in nl.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")

    # ---- 3. K1 vs its twin, and the K1 path vs the oracle ---------------
    small = flagship.build_sim(n=32768, device=device, reneigh_every=20)
    compare_k1(small, "n=32768", kernel_reps=40, twin_reps=3)
    del small
    sim = flagship.build_sim(n=2**20, device=device, reneigh_every=20)
    if sim.pair_compute is not hp.compute_style:
        raise RuntimeError("select_pair_kernel did not choose K1 at 2^20")
    k1 = compare_k1(sim, "n=2^20", kernel_reps=20, twin_reps=1,
                    with_bound=True)
    check_k1_oracle(device)

    # ---- 4. the UCG-LD main path ------------------------------------------
    blocks, nre = 5, sim.cfg.reneigh_every
    window = (0, (blocks + 1) * nre)
    for k in hp.ucgld_pair.launches:
        hp.ucgld_pair.launches[k] = 0
    sim.setup(window)
    sim.run_fused(1, run_window=window)            # warm block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_fused(blocks, run_window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = dict(hp.ucgld_pair.launches)
    row = sim.thermo()
    steps_s = blocks * nre / wall
    log(f"[UCG-LD main n=2^20] {blocks * nre} steps in {wall:.3f} s = "
        f"{steps_s:.2f} steps/s ({steps_s * 2**20 / 1e6:.2f} M atom-steps/s) "
        f"on {card}; temp {row['temp']:.6f} etotal {row['etotal']:.6f} "
        f"oob_low {row['oob_low']}; dangerous builds {sim.dangerous_builds}; "
        f"K1 launches {k1_launches}")
    nblk = blocks + 1
    if (k1_launches["full"] < nblk
            or k1_launches["noscores"] < (nre - 1) * nblk):
        raise RuntimeError(f"main path did not run through K1: {k1_launches}")
    if not finite_row(row):
        raise RuntimeError(f"non-finite thermo: {row}")
    if row["oob_low"] != 0:
        raise RuntimeError(f"pairs below the table inner cutoff: {row}")
    del sim

    # ---- 5. NVE drift (bench.run_drift protocol) -------------------------
    ds = flagship.build_sim(n=32768, device=device, reneigh_every=10)
    ds.cfg = dataclasses.replace(ds.cfg, langevin=None, dt=0.002)
    tp = ds.pair_params.tp

    def hamiltonian():
        mu = torch.where(tp.n_states[ds.state.typ] > 1,
                         ds.state.ucgl * tp.mu_diff[ds.state.typ], 0.0)
        return ds.thermo()["etotal"] + float(mu.sum())

    ds.setup((0, 200))
    ds.run_fused(1, run_window=(0, 200))
    e0 = hamiltonian()
    ds.run_fused(19, run_window=(0, 200))
    e1 = hamiltonian()
    drift = abs(e1 - e0) / max(abs(e0), 1e-12)
    log(f"[drift n=32768] H0 {e0:.9f} H1 {e1:.9f} drift {drift:.6e} "
        f"(limit {DRIFT_MAX:g})")
    if not drift < DRIFT_MAX:
        raise RuntimeError(f"NVE drift {drift} exceeds {DRIFT_MAX}")
    del ds

    # ---- 6. K2 vs its twin -------------------------------------------------
    main_variants = [("bethe", True, True), ("bethe", True, False)]
    side_variants = [(m, p, o) for m, p in (("mf", True), ("bethe", False))
                     for o in (True, False)]
    small = flagship.build_bethe_sim(n=32768, device=device)
    small.setup((0, 10))                   # priors from ucgp from here on
    state, cl = column_state(small)
    compare_k2(state, cl, small.pair_params, "n=32768",
               main_variants + side_variants, kernel_reps=40, twin_reps=3)
    del small
    mstate, mparams, mspec = mixed_bethe(device)
    from lammps_ucg_dev_tpu_torch.ops import colpack

    mcl = colpack.build(mstate.x, mstate.box, mspec)
    compare_k2(mstate, mcl, mparams, "mixed n=8192",
               [(m, p, o) for m in ("bethe", "mf") for p in (True, False)
                for o in (True, False)], kernel_reps=40, twin_reps=3)
    sim = flagship.build_bethe_sim(n=2**20, device=device)
    if sim.pair_compute is not hb.compute_style_bethe:
        raise RuntimeError("select_pair_kernel did not choose K2 at 2^20")
    sim.setup((0, 10))
    state, cl = column_state(sim)
    k2 = compare_k2(state, cl, sim.pair_params, "n=2^20", main_variants,
                    kernel_reps=20, twin_reps=1, with_bound=True)
    k2 = {"full": k2["bethe/pseudo/full"], "fast": k2["bethe/pseudo/fast"]}
    del sim, state, cl

    # ---- 7. the K2 path vs the oracle ---------------------------------------
    check_k2_oracle(device)

    # ---- 8. the Bethe main path -----------------------------------------
    sim = flagship.build_bethe_sim(n=2**20, device=device)
    blocks, nre = 20, sim.cfg.reneigh_every
    window = (0, (blocks + 1) * nre)
    for k in hb.bethe_pair.launches:
        hb.bethe_pair.launches[k] = 0
    sim.setup(window)
    sim.run_fused(1, run_window=window)            # warm block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_fused(blocks, run_window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_launches = dict(hb.bethe_pair.launches)
    row = sim.thermo()
    p = sim.state.ucgp
    p_lo, p_hi = float(p.min()), float(p.max())
    steps_s = blocks * nre / wall
    log(f"[Bethe main n=2^20] {blocks * nre} steps in {wall:.3f} s = "
        f"{steps_s:.2f} steps/s ({steps_s * 2**20 / 1e6:.2f} M atom-steps/s) "
        f"on {card}; temp {row['temp']:.6f} etotal {row['etotal']:.6f} "
        f"oob_low {row['oob_low']}; ucgp in [{p_lo:.6f}, {p_hi:.6f}]; "
        f"dangerous builds {sim.dangerous_builds}; K2 launches {k2_launches}")
    nblk = blocks + 1
    if k2_launches["full"] < nblk or k2_launches["fast"] < (nre - 1) * nblk:
        raise RuntimeError(f"Bethe path did not run through K2: {k2_launches}")
    if not finite_row(row):
        raise RuntimeError(f"non-finite thermo: {row}")
    if row["oob_low"] != 0:
        raise RuntimeError(f"pairs below the table inner cutoff: {row}")
    if not (p_lo >= 1e-6 and p_hi <= 1 - 1e-6):
        raise RuntimeError(f"ucgp outside [1e-6, 1-1e-6]: {p_lo}, {p_hi}")
    del sim

    log(f"K1 fast variant (not on the UCG-LD main path under ucgstate ld): "
        f"{json.dumps(k1['fast'], default=float)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    def entry(name, source, launches, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": REPLACES, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    kernels = ([entry(f"ucgld_pair[{v}]", K1_SOURCE, k1_launches[v], k1[v])
                for v in ("full", "noscores")]
               + [entry(f"bethe_pair[{v}]", K2_SOURCE, k2_launches[v], k2[v])
                  for v in ("full", "fast")])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mixed_bethe(device: str, n: int = 8192):
    """A 2-type Bethe system (plain type 1 + 2-state type 2) at ρ 0.6 with
    assigned priors: (state, params, spec) for K2's multi-type variants."""
    import numpy as np
    import torch

    from lammps_ucg_dev_tpu_torch.core.state import Box, SimState
    from lammps_ucg_dev_tpu_torch.flagship import soft_table
    from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
    from lammps_ucg_dev_tpu_torch.models import pair_bethe
    from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder
    from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel

    rng = np.random.default_rng(5)
    st = parse_state_settings("2 3 2\n1 1\n2 2\n2 3\n0.0 0.4\n", "bethe")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 1, 1, [(soft_table(1.0, 1500), 2.5)])
    b.pair_coeff(1, 2, 1, 2, [(soft_table(e, 1500), 2.5) for e in (0.8, 0.5)])
    b.pair_coeff(2, 2, 2, 2, [(soft_table(e, 1500), 2.5)
                              for e in (0.9, 0.55, 0.55, 0.3)])
    bank, tp = b.build(device=device)
    L = (n / 0.6) ** (1 / 3)
    state = SimState.create(
        x=rng.uniform(0, L, (n, 3)), typ=rng.integers(1, 3, n),
        ucgl=rng.uniform(0.2, 0.8, n), ucgstate=rng.integers(0, 2, n),
        ucgp=rng.uniform(0.1, 0.9, n),
        box=Box.create([0, 0, 0], [L] * 3, device=device), device=device)
    params = pair_bethe.make_params(bank, tp, 0.8)
    sel = select_pair_kernel(params, state, 2.5, 0.4)
    if sel is None or sel[0].__name__ != "compute_style_bethe":
        raise RuntimeError("K2 was not selected for the mixed system")
    _, spec, params = sel
    return state, params, spec


if __name__ == "__main__":
    sys.exit(main())
