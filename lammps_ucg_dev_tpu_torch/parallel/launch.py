"""Start the ranks of a spatial run: processes on one host that share a
``FileStore``, or the processes ``torchrun`` started.

    results = spawn(fn, world, arg, ..., backend="gloo", device="cuda")
    ranks = start(fn, world, ...); ...; results = ranks.join()

runs ``fn(rank, world, device, *args)`` in ``world`` fresh processes (the
``spawn`` start method) after each has joined the process group, and
returns their results in rank order, each process running PyTorch on one
thread.  ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``.
The store is a file in a temporary directory, so concurrent runs (test
workers) never share a port.  The
group's timeout bounds each collective; ``timeout`` bounds the whole run:
when a rank raises, dies or outlives it, every rank is killed and
:func:`spawn` raises with the failing rank's traceback.  On a CUDA device
the parent builds every kernel first (``ops/cuda_lib.build``), so the
ranks load the libraries instead of racing ``nvcc`` into ``_build/``.
With ``nccl`` each rank takes card ``rank % device_count``; with ``gloo``
every rank uses ``device`` as given (several ranks may share a card).

Under ``torchrun``, :func:`init_from_env` joins the group that its
environment describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

KERNEL_SOURCES = ("ucgld_pair", "bethe_pair", "density_cv")


def _device_for(rank: int, backend: str, device: str) -> str:
    if backend == "nccl":
        return f"cuda:{rank % torch.cuda.device_count()}"
    return device


def _child(fn, rank, world, backend, device, store_path, timeout, results,
           args):
    try:
        torch.set_num_threads(1)
        dev = _device_for(rank, backend, device)
        if torch.device(dev).index is not None:
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: the queue's own pickler would pass tensors by
        # shared-memory handles that die with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                             # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """The processes of a run that :func:`start` began."""

    def __init__(self, procs, results, tmp: str, timeout: float):
        self.procs, self.results, self.tmp = procs, results, tmp
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """The ranks' results in rank order; raises when a rank failed,
        died or outlasted the timeout.  No rank outlives the call."""
        procs, world = self.procs, len(self.procs)
        out, failure = {}, None
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, val = self.results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > self.deadline:
                        failure = f"the ranks outlasted {self.timeout:.0f} s"
                    continue
                if ok:
                    out[rank] = pickle.loads(val)
                else:
                    failure = f"rank {rank} failed:\n{val}"
            if failure is None:
                for p in procs:
                    p.join(max(self.deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
            self.results.close()
            shutil.rmtree(self.tmp, ignore_errors=True)
        if failure is not None:
            raise RuntimeError(f"spatial run failed: {failure}")
        return [out[r] for r in range(world)]


def start(fn, world: int, *args, backend: str = "gloo", device: str = "cuda",
          timeout: float = 120.0) -> Ranks:
    """Begin ``fn(rank, world, device_of_rank, *args)`` in ``world``
    processes joined in one process group (``backend``), each running
    PyTorch on one thread; :meth:`Ranks.join` collects the results.  ``fn`` and the results must pickle."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and not str(device).startswith("cuda"):
        raise ValueError("nccl runs on CUDA devices")
    if str(device).startswith("cuda"):
        from lammps_ucg_dev_tpu_torch.ops import cuda_lib

        cuda_lib.build(KERNEL_SOURCES)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ucg-ranks-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, backend, str(device),
                               os.path.join(tmp, "store"), timeout, results,
                               args))
             for r in range(world)]
    ranks = Ranks(procs, results, tmp, timeout)
    try:
        for p in procs:
            p.start()
    except BaseException:
        ranks.deadline = 0.0
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return ranks


def spawn(fn, world: int, *args, backend: str = "gloo", device: str = "cuda",
          timeout: float = 120.0) -> list:
    """``[fn(rank, world, device_of_rank, *args) for each rank]`` (see
    :func:`start`); raises when a rank fails or the run outlasts
    ``timeout`` seconds, and no rank outlives the call."""
    return start(fn, world, *args, backend=backend, device=device,
                 timeout=timeout).join()


def init_from_env(backend: str, timeout: float = 600.0) -> tuple[int, int]:
    """Join the process group ``torchrun`` describes; returns (rank,
    world).  With ``nccl`` the rank takes card ``LOCAL_RANK``."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return rank, world
