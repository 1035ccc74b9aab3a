"""Tracing & profiling utilities (port of
``lammps_ucg_dev_tpu/utils/profiling.py``: the reference relies on stock
LAMMPS thermo/Timer; here ``torch.profiler`` traces, named ranges and a
throughput counter).
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where a CUDA
    device is present, the card, written for TensorBoard into
    ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


named_scope = torch.profiler.record_function   # annotate step phases


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Throughput:
    """steps/s and atom-steps/s counter; the wall clock is read after a CUDA
    synchronize at both edges of each timed section, so queued device work
    is counted where it belongs."""

    def __init__(self, n_atoms: int):
        self.n_atoms = n_atoms
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed += time.perf_counter() - self._t0

    def add_steps(self, n: int):
        self.steps += n

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def atom_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n_atoms

    def row(self) -> dict:
        return {
            "steps": self.steps,
            "wall_s": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "atom_steps_per_sec": round(self.atom_steps_per_sec, 1),
        }
