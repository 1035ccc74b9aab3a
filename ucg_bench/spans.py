"""What the benchmark puts around the program's calls, from outside: the
block wrapper (a device timestamp at each block's start, the captures the
check of ``correct`` reads, the profiled and counted sub-windows), the
event wrapper, and, in a traced run, ``record_function`` ranges around the
pair pass, the packing, the rebuild and the event.

The wrappers are instance attributes over the simulation's own methods
(``_block``, ``_cswitch_event``, ``_pair_pass``, ``_rebuild``,
``_to_slots``, ``_from_slots``) and module attributes over ``colpack.pack``
and ``colpack.pack_slots``, which the pair entries look up at each call.
"""

from __future__ import annotations

import time

import torch

PREFIX = "ucg:"


class Stamps:
    """Timestamps at block starts: CUDA events on a card, the host clock
    elsewhere (the CPU tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


class Instruments:
    """The benchmark's hooks on one rank's simulation for one window.

    ``plan``: ``check_block`` (the block whose input and output are kept),
    ``trace_blocks`` ((first, count) profiled, or None), ``stats_blocks``
    ((first, count) in which ``Ring.stats`` counts, or None), ``event``
    (the index of the event whose input and output are kept, or None)."""

    def __init__(self, sim, plan: dict, cuda: bool, spans: bool):
        self.sim, self.plan, self.cuda, self.spans = sim, plan, cuda, spans
        self.spatial = hasattr(sim, "ring")
        self.stamps = Stamps(cuda)
        self.blocks = 0
        self.events = 0
        self.sweeps: list[int] = []
        self.block_in = self.block_out = None
        self.event_in = self.event_out = None
        self.trace_x = None
        self.prof = None
        self.trace_s = None
        self.ring_stats = None
        self._undo = []

    # ---- installing ---------------------------------------------------

    def _wrap_attr(self, owner, name, make):
        orig = getattr(owner, name)
        had = name in vars(owner)
        setattr(owner, name, make(orig))
        self._undo.append((lambda: setattr(owner, name, orig)) if had
                          else (lambda: delattr(owner, name)))

    def install(self):
        sim = self.sim
        self._wrap_attr(sim, "_block", self._block_wrapper)
        if getattr(sim, "cswitch", None) is not None:
            self._wrap_attr(sim, "_cswitch_event", self._event_wrapper)
        if self.spans:
            from lammps_ucg_dev_tpu_torch.ops import colpack
            for name, span in (("_pair_pass", "pair"), ("_rebuild", "rebuild"),
                               ("_to_slots", "pack"), ("_from_slots", "pack")):
                if hasattr(sim, name):
                    self._wrap_attr(sim, name, self._ranged(span))
            for name in ("pack", "pack_slots"):
                self._wrap_attr(colpack, name, self._ranged("pack"))
        return self

    def uninstall(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        if self.prof is not None and self.trace_s is None:
            self.prof.stop()

    @staticmethod
    def _ranged(span):
        from torch.profiler import record_function

        def wrap(fn):
            def call(*a, **k):
                with record_function(PREFIX + span):
                    return fn(*a, **k)
            return call
        return wrap

    # ---- the block ----------------------------------------------------

    def _block_wrapper(self, fn):
        def block(*a, **k):
            nsteps = k.get("nsteps", a[0] if self.spatial else a[3])
            if nsteps == 0:                  # a spatial setup's force pass
                return fn(*a, **k)
            b = self.blocks
            self.blocks += 1
            self.stamps.mark()
            self._windows(b)
            keep = b == self.plan.get("check_block")
            if keep:
                self.block_in = self._capture_in(a, nsteps, k)
            out = fn(*a, **k)
            if keep:
                self.block_out = self._capture_out(out)
            return out
        return block

    def _windows(self, b):
        tb = self.plan.get("trace_blocks")
        if tb is not None and self.cuda:
            if b == tb[0]:
                _sync(True)
                self.trace_x = self._positions()
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                self._t_trace = time.perf_counter()
            elif b == tb[0] + tb[1] and self.prof is not None:
                _sync(True)
                self.trace_s = time.perf_counter() - self._t_trace
                self.prof.stop()
        elif tb is not None and b == tb[0]:
            self.trace_x = self._positions()
        sb = self.plan.get("stats_blocks")
        if sb is not None and self.spatial:
            if b == sb[0]:
                self.sim.ring.stats = {}
            elif b == sb[0] + sb[1]:
                self.ring_stats = self.sim.ring.stats
                self.sim.ring.stats = None

    def _positions(self):
        """This rank's beads at a block's start: its packed rows and their
        count on slabs, else (x, typ)."""
        sim = self.sim
        if self.spatial:
            return {"F": sim._F.clone(), "nloc": sim._nloc.clone()}
        return sim.state.x.clone(), sim.state.typ.long().clone()

    def _capture_in(self, a, nsteps, k=None):
        sim = self.sim
        gen = sim.generator.get_state()
        if self.spatial:
            return {"F": sim._F.clone(), "nloc": sim._nloc.clone(),
                    "gen": gen, "nsteps": nsteps}
        state, fcarry = a[0], a[1]
        d = _state_fields(state, fcarry)
        nbr = k.get("nbr") if k else None
        if nbr is not None:
            d["x0"] = nbr.x0.clone()        # the last list build's positions
        return {"state": d, "gen": gen, "nsteps": nsteps}

    def _capture_out(self, out):
        sim = self.sim
        if self.spatial:
            return {"F": sim._F.clone(), "nloc": sim._nloc.clone(),
                    "pe": sim._pe.clone()}
        state, fout = out[0], out[1]
        d = _state_fields(state, fout)
        d["pe"] = fout.pe.clone()
        return {"state": d}

    # ---- the event ----------------------------------------------------

    def _event_wrapper(self, fn):
        from torch.profiler import record_function

        def event(state, stats, u):
            k = self.events
            self.events += 1
            keep = k == self.plan.get("event")
            if keep:
                self.event_in = {"x": state.x.clone(),
                                 "typ": state.typ.clone(),
                                 "mol": state.mol.clone(), "u": u.clone()}
            if self.spans:
                with record_function(PREFIX + "event"):
                    out = fn(state, stats, u)
            else:
                out = fn(state, stats, u)
            info = out[2]
            self.sweeps.append(int(info["sweeps"]))
            if keep:
                self.event_out = {"typ": out[0].typ.clone(),
                                  "in_cluster": info["in_cluster"].clone()}
            return out
        return event


def _state_fields(state, fout) -> dict:
    return {"tag": state.tag.clone(), "x": state.x.clone(),
            "v": state.v.clone(), "lam": state.ucgl.clone(),
            "vlam": state.ucgvl.clone(), "ml": state.ucgml.clone(),
            "typ": state.typ.clone(), "ucgstate": state.ucgstate.clone(),
            "ucgp": state.ucgp.clone(), "f": fout.f.clone(),
            "lamforce": fout.ucgforce.clone()}
