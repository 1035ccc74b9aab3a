"""Shared measurement helpers: the card's name and power limit, and the
mean time of a call on the card by CUDA events.  Imports no kernel."""

from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
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
