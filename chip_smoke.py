#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the flagship 2-state UCG-LD fluid at 2^20
beads through ``flagship.build_sim`` / ``Simulation`` — on the card, after
building its hand-written kernel (K1, ``csrc/ucgld_pair.cu``) with nvcc into
``lammps_ucg_dev_tpu_torch/_build/``.  Phases, each of which raises on
failure:

1. the card's name and power limit, torch and CUDA versions;
2. K1's build;
3. K1 against its plain PyTorch twin in all three variants on the same
   inputs, at 32,768 beads and at the main path's 2^20, with both times;
   then the kernel path against the float64 reference pair path on a small
   system;
4. the main path: setup, one warm block, five timed blocks of 20 steps,
   with K1's launch counts read around that run;
5. the NVE energy drift by the JAX package's ``bench.run_drift`` protocol
   (32,768 beads, Langevin off, dt 0.002, 1 + 19 blocks of 10 steps).

The line before the last is a JSON object of the kernels on the main path;
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

SOURCE = "lammps_ucg_dev_tpu_torch/csrc/ucgld_pair.cu"
REPLACES = "lammps_ucg_dev_tpu/ops/pallas_pair.py:719"
TOL = 2e-5       # K1 vs twin: f32 sums taken in another order (see below)
DRIFT_MAX = 1e-4


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


def compare_variants(sim, label: str, kernel_reps: int, twin_reps: int):
    """K1 vs its twin on the column list of ``sim``'s current state, every
    variant.  Tolerances (both sides f32, the same algorithm; they differ by
    FMA contraction and summation order): f, ucgforce and scores within
    TOL times the field's largest magnitude, pe within TOL relative, the
    virial within TOL times its largest component."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import colpack
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state = sim.state
    x_w, _ = state.box.wrap(state.x, state.image)
    state = dataclasses.replace(state, x=x_w)
    cl = colpack.build(state.x, state.box, sim.nbr_spec)
    if bool(cl.overflow):
        raise RuntimeError(f"{label}: column list overflow")
    params, cheb = sim.pair_params, sim.pair_params.cheb
    res = {}
    for name, observe, scores in (("full", True, True),
                                  ("fast", False, True),
                                  ("noscores", False, False)):
        args, kw = hp.kernel_inputs(state, cl, params, cheb, observe, scores)
        out_k, part_k = hp.ucgld_pair(*args, **kw)
        out_t, part_t = hp.ucgld_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        fk = hp.force_out(out_k, part_k, state, cl, params, observe, scores)
        ft = hp.force_out(out_t, part_t, state, cl, params, observe, scores)
        errs = {}
        for field in ("f", "ucgforce", "scores"):
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
        ms = cuda_ms(lambda: hp.ucgld_pair(*args, **kw), kernel_reps)
        plain_ms = cuda_ms(lambda: hp.ucgld_pair_reference(*args, **kw),
                           twin_reps)
        res[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     "rel_err": errs}
        log(f"[{label}] K1 {name:8s} vs twin: max|out diff| {max_abs:.3e}, "
            f"rel errs {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
            f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
    return res


def check_against_oracle(device: str, n: int = 4096) -> None:
    """One force evaluation of the kernel path (f32, on the card) against
    the float64 reference pair path on the CPU, same system: agreement to
    the Chebyshev fit gate (the fit's max relative error is < 1e-4)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    ker = flagship.build_sim(n=n, device=device)
    if ker.pair_compute is not hp.compute_style:
        raise RuntimeError("kernel path was not selected for the oracle check")
    ref = flagship.build_sim(n=n, dtype=torch.float64, kernel=False)
    for s in (ker, ref):       # no thermostat noise: the draws differ
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
    fk, fr = ker.setup((0, 10)), ref.setup((0, 10))
    f_k, f_r = fk.f.double().cpu(), fr.f
    scale = float(f_r.abs().max())
    f_err = float((f_k - f_r).abs().max()) / scale
    pe_err = abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe))
    lam_err = float((fk.ucgforce.double().cpu() - fr.ucgforce).abs().max())
    log(f"[oracle n={n}] kernel path (f32) vs reference path (f64): "
        f"f rel {f_err:.3e}, pe rel {pe_err:.3e}, ucgforce abs {lam_err:.3e}")
    if f_err > 3e-5 or pe_err > 1e-5 or lam_err > 1e-4:
        raise RuntimeError("kernel path disagrees with the reference path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib
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

    # ---- 2. build K1 ---------------------------------------------------------
    nl = cuda_lib.load("ucgld_pair")
    log(f"K1 built in {nl.build_seconds:.1f} s -> {nl.path.name}")
    for line in nl.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. K1 vs its twin, and the kernel path vs the oracle -------------
    small = flagship.build_sim(n=32768, device=device, reneigh_every=20)
    compare_variants(small, "n=32768", kernel_reps=20, twin_reps=3)
    del small
    sim = flagship.build_sim(n=2**20, device=device, reneigh_every=20)
    if sim.pair_compute is not hp.compute_style:
        raise RuntimeError("select_pair_kernel did not choose K1 at 2^20")
    big = compare_variants(sim, "n=2^20", kernel_reps=10, twin_reps=1)
    check_against_oracle(device)

    # ---- 4. the main path ------------------------------------------------
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
    launches = dict(hp.ucgld_pair.launches)
    row = sim.thermo()
    steps_s = blocks * nre / wall
    log(f"[main n=2^20] {blocks * nre} steps in {wall:.3f} s = "
        f"{steps_s:.2f} steps/s ({steps_s * 2**20 / 1e6:.2f} M atom-steps/s); "
        f"temp {row['temp']:.6f} etotal {row['etotal']:.6f} "
        f"oob_low {row['oob_low']}; dangerous builds {sim.dangerous_builds}; "
        f"K1 launches {launches}")
    nblk = blocks + 1
    if launches["full"] < nblk or launches["noscores"] < (nre - 1) * nblk:
        raise RuntimeError(f"main path did not run through K1: {launches}")
    if not all(v == v and abs(v) != float("inf")
               for v in row.values() if isinstance(v, float)):
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

    log(f"fast variant (not on the main path under ucgstate ld): "
        f"{json.dumps(big['fast'], default=float)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = [{"name": f"ucgld_pair[{v}]", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": launches[v],
                "max_abs_err": big[v]["max_abs_err"], "ms": big[v]["ms"],
                "plain_ms": big[v]["plain_ms"]}
               for v in ("full", "noscores")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
