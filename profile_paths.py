#!/usr/bin/env python3
"""Where one block of a main path spends its time on the GPU.

    python3 profile_paths.py [--path bethe|ucgld|density|rleucg|cluster]

Builds the path's system at 2^20 beads (``flagship.build_bethe_sim``,
``build_sim``, ``build_density_sim``, ``build_rleucg_sim`` or
``build_cluster_sim``; reneighbour every 5, 20, 10, 10 and 20 steps), runs setup and two warm blocks, times five
blocks one by one on the host clock (each ending
in a synchronize), then traces one more with ``torch.profiler``.  Prints
the card's name and power limit, the median ms per step with the fastest
and slowest block, the device time per step and its share of the median
step (the traced block's wall time carries the profiler's own host
overhead, so its idle share is printed apart), and the device time of the
heaviest operations per step.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lammps_ucg_dev_tpu_torch.tools.timing import card  # noqa: E402


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lammps_ucg_dev_tpu_torch import flagship

    ap = argparse.ArgumentParser()
    builders = {"bethe": flagship.build_bethe_sim,
                "ucgld": lambda n: flagship.build_sim(n=n, reneigh_every=20),
                "density": flagship.build_density_sim,
                "rleucg": flagship.build_rleucg_sim,
                "cluster": flagship.build_cluster_sim}
    ap.add_argument("--path", choices=tuple(builders), default="bethe")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: no CUDA device")
    n = 2**20
    sim = builders[a.path](n=n)
    nre = sim.cfg.reneigh_every
    window = (0, 8 * nre)
    sim.setup(window)
    sim.run_fused(2, run_window=window)
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        sim.run_fused(1, run_window=window)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / nre)
    block_ms.sort()
    ms_step = block_ms[2]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_fused(1, run_window=window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels, copies and fills on the device (the aten ops that launch
    # them carry the same time and are left out)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(card())
    busy_step = busy_ms / nre
    print(f"[{a.path} n={n}] {ms_step:.3f} ms/step untraced, median of 5 "
          f"blocks ({block_ms[0]:.3f}-{block_ms[-1]:.3f}; "
          f"{1e3 / ms_step:.2f} steps/s); device busy {busy_step:.3f} "
          f"ms/step = {100 * busy_step / ms_step:.1f}% of the median step "
          f"(idle {100 * (1 - busy_step / ms_step):.1f}%); traced block "
          f"{wall_ms:.2f} ms, idle {100 * (1 - busy_ms / wall_ms):.1f}% "
          f"under the profiler")
    print(f"{'ms/step':>8} {'share':>6} {'calls':>6}  operation")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        t = e.self_device_time_total / 1e3
        print(f"{t / nre:8.3f} {100 * t / busy_ms:5.1f}% {e.count:6d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
