"""The spatial drivers' communication over ``torch.distributed``: the only
module of the port that calls it.

A :class:`Ring` is the processor grid of a slab (``Dx × 1``) or pencil
(``Dx × Dy``) decomposition over an initialised process group, with
``rank = i·Dy + j`` for the subdomain in x column ``i`` and y row ``j``
(the JAX package's mesh layout, ``parallel/spatial.py:323-333``).  Its
operations are the JAX driver's collectives:

* :meth:`Ring.exchange` is a pair of ``lax.ppermute`` ring shifts along one
  axis: every rank sends one fixed-capacity buffer to each neighbour and
  gets one from each, in ONE ``all_to_all_single`` whose splits are
  non-zero only for the two neighbours.  Buffers are fixed-capacity and
  counts travel inside them, so nothing is read on the host;
* :meth:`Ring.all_reduce` (sum, max or min) is ``psum``/``pmax``/``pmin``
  (the min merges ``fix cluster_switch``'s labels, the reference's
  ``MPI_Allreduce(MIN)``, ``fix_cluster_switch.cpp:682-683``);
* :meth:`Ring.all_gather` gathers one fixed block from every rank.

The backend is the caller's (``nccl`` with one rank per card, or ``gloo``);
nothing here switches it.  Gloo's collectives run on host memory, so with
``gloo`` a CUDA tensor is copied to the host for the collective and back
(``staged``): the ranks of ``chip_smoke.py`` share one card that way.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Ring:
    """The ``dims = (Dx, Dy)`` processor grid over ``group`` (the default
    process group when None), whose size must be ``Dx·Dy``."""

    def __init__(self, dims, group=None):
        self.group = group
        self.dims = (int(dims[0]), int(dims[1]))
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.dims[0] * self.dims[1] != self.world:
            raise ValueError(f"a {self.dims[0]}x{self.dims[1]} grid needs "
                             f"{self.dims[0] * self.dims[1]} ranks, the "
                             f"group has {self.world}")
        self.me = divmod(self.rank, self.dims[1])
        self.backend = str(dist.get_backend(group))
        self.staged = self.backend == "gloo"
        # {kind: [calls, seconds, bytes sent]} of the exchanges while a
        # dict; each is then timed between two device synchronizations
        self.stats: dict | None = None

    def neighbours(self, axis: int) -> tuple[int, int]:
        """(lower, upper) neighbour ranks along ``axis`` (0 x, 1 y), with
        periodic wrap."""
        i, j = self.me
        dx, dy = self.dims
        if axis == 0:
            return ((i - 1) % dx) * dy + j, ((i + 1) % dx) * dy + j
        return i * dy + (j - 1) % dy, i * dy + (j + 1) % dy

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged and t.is_cuda else t

    def exchange(self, axis: int, to_lo: torch.Tensor, to_hi: torch.Tensor,
                 kind: str = "halo"):
        """Send ``to_lo`` to the lower neighbour along ``axis`` and
        ``to_hi`` to the upper one; returns ``(from_lo, from_hi)``, what
        they sent to this rank.  The four buffers share one shape and
        dtype; the axis must have at least 3 ranks.  ``kind`` names the
        exchange in :attr:`stats`."""
        if self.stats is None:
            return self._exchange(axis, to_lo, to_hi)
        sync = torch.cuda.synchronize if to_lo.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = self._exchange(axis, to_lo, to_hi)
        sync()
        rec = self.stats.setdefault(kind, [0, 0.0, 0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
        rec[2] += 2 * to_lo.numel() * to_lo.element_size()
        return out

    def _exchange(self, axis, to_lo, to_hi):
        lo, hi = self.neighbours(axis)
        if lo == hi:
            raise ValueError("an exchange axis needs at least 3 ranks")
        rows = to_lo.shape[0]
        first_lo = lo < hi
        send = torch.cat([to_lo, to_hi] if first_lo else [to_hi, to_lo])
        splits = [0] * self.world
        splits[lo] = splits[hi] = rows
        dev = send.device
        send = self._host(send).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, splits, splits, group=self.group)
        recv = recv.to(dev)
        a, b = recv[:rows], recv[rows:]
        return (a, b) if first_lo else (b, a)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum (``op`` "sum"), maximum ("max") or minimum
        ("min") of ``t`` over every rank, as a new tensor on ``t``'s
        device."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        h = self._host(t).clone()
        dist.all_reduce(h, op=red, group=self.group)
        return h.to(t.device)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), in rank order, on
        ``t``'s device."""
        h = self._host(t).contiguous()
        out = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(out, h, group=self.group)
        return [o.to(t.device) for o in out]

    def barrier(self) -> None:
        dist.barrier(group=self.group)
