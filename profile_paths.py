#!/usr/bin/env python3
"""Where one block of a main path spends its time on the GPU.

    python3 profile_paths.py [--path bethe|ucgld|density|rleucg|cluster|
                                     molecular] [--atom-order]
                             [--cluster-switch]

Builds the path's system at 2^20 beads (``flagship.build_bethe_sim``,
``build_sim``, ``build_density_sim``, ``build_rleucg_sim``,
``build_cluster_sim`` or ``build_molecular_sim``, 1,048,575 beads;
reneighbour every 5, 20, 10, 10, 20 and 5 steps), runs setup and two warm
units, times five units one by one on the host clock (each ending in a
synchronize), then traces one more with ``torch.profiler``.  A unit is
one block of ``run_fused``; with ``--cluster-switch`` (``--path density``
only: config 4 with its ``fix cluster_switch``) it is one event and the
20 steps that follow it, through ``Simulation.run``, which fires the
events.  Prints
the card's name and power limit, the median ms per step with the fastest
and slowest block, the device time per step and its share of the median
step (the traced block's wall time carries the profiler's own host
overhead, so its idle share is printed apart), the device time of the row
gathers and scatters (every ``index``/``gather`` kernel), that of the
heaviest operations per step, the column list's real-slot count against
N, and the device time of ``torch.cat`` split
by its call site (``colpack.pack`` in atom order and in slot order,
``Simulation._to_slots``, ``Simulation._from_slots``, the rest), with
each site's largest call, and the device time under each named site:
``bonded`` (``models.bonded.compute``), ``excl_delta``, the
cluster_switch ``event``, its ``contact list`` and label ``sweep``s, the
``setup`` after an event, and the ``index_add_`` scatters by site.  The
traced unit runs with the sites wrapped in ``record_function`` ranges,
which only this script adds (their device spans are left out of the
device time).  The column paths run their interior steps
slot-major, as the driver chooses; ``--atom-order`` profiles the
atom-ordered interior instead (``Simulation._slot_ok`` set false).  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lammps_ucg_dev_tpu_torch.tools.timing import card  # noqa: E402


def mark_sites(sim):
    """Wrap the call sites of ``torch.cat`` on the block's path, and the
    topology and cluster_switch calls, in ``record_function`` ranges
    named ``site:...``; returns the undo."""
    from torch.profiler import record_function

    from lammps_ucg_dev_tpu_torch.fixes import cluster_switch as fcs
    from lammps_ucg_dev_tpu_torch.models import bonded
    from lammps_ucg_dev_tpu_torch.ops import colpack
    from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod

    pack = colpack.pack

    def ranged_pack(*a, **k):
        with record_function("site:pack(slot)" if k.get("slot")
                             else "site:pack(atom)"):
            return pack(*a, **k)

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(f"site:{name}"):
                return fn(*a, **k)
        return call

    colpack.pack = ranged_pack
    methods = {"_to_slots": "_to_slots", "_from_slots": "_from_slots",
               "_cswitch_event": "event", "setup": "setup"}
    for name, site in methods.items():
        setattr(sim, name, ranged(site, getattr(sim, name)))
    # module functions the driver looks up at each call
    swapped = [(bonded, "compute", "bonded"), (fcs, "sweep", "sweep"),
               (nbrmod, "build", "contact list")]
    if getattr(sim.pair_compute, "excl_delta", None) is not None:
        swapped.append((sim.pair_compute, "excl_delta", "excl_delta"))
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in swapped]
    for owner, name, site in swapped:
        setattr(owner, name, ranged(site, getattr(owner, name)))

    def undo():
        colpack.pack = pack
        for name in methods:
            delattr(sim, name)
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return undo


def sites(prof, nre: int) -> None:
    """Print the device time under each ``site:`` range of
    :func:`mark_sites` per step (a range's kernels and its children's; a
    nested site is also counted in the one around it)."""
    total = {}
    for e in prof.events():
        if e.name.startswith("site:") and e.device_type.name == "CPU":
            calls, us = total.get(e.name[5:], (0, 0.0))
            total[e.name[5:]] = (calls + 1, us + e.device_time_total)
    print(f"device time by site:\n{'ms/step':>8} {'calls':>6}  site")
    for site, (calls, us) in sorted(total.items(), key=lambda kv: -kv[1][1]):
        print(f"{us / 1e3 / nre:8.3f} {calls:6d}  {site}")


def op_by_site(prof, nre: int, op: str = "aten::cat") -> None:
    """Print the device time of every ``op`` (``torch.stack`` is an
    ``aten::cat`` too) summed by the nearest enclosing ``site:`` range of
    :func:`mark_sites` ("-": none)."""
    sites = {}
    for e in prof.events():
        if e.name != op:
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("site:"):
            p = p.cpu_parent
        site = p.name[5:] if p is not None else "-"
        calls, us, big = sites.get(site, (0, 0.0, 0.0))
        t = e.device_time_total
        sites[site] = (calls + 1, us + t, max(big, t))
    total = sum(us for _, us, _ in sites.values())
    print(f"{op} by call site: {total / 1e3 / nre:.3f} ms/step")
    print(f"{'ms/step':>8} {'calls':>6} {'ms/call':>8} {'max ms':>8}  site")
    for site, (calls, us, big) in sorted(sites.items(),
                                         key=lambda kv: -kv[1][1]):
        print(f"{us / 1e3 / nre:8.3f} {calls:6d} {us / 1e3 / calls:8.4f} "
              f"{big / 1e3:8.4f}  {site}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lammps_ucg_dev_tpu_torch import flagship

    ap = argparse.ArgumentParser()
    builders = {"bethe": flagship.build_bethe_sim,
                "ucgld": lambda n: flagship.build_sim(n=n, reneigh_every=20),
                "density": flagship.build_density_sim,
                "rleucg": flagship.build_rleucg_sim,
                "cluster": flagship.build_cluster_sim,
                "molecular": lambda n: flagship.build_molecular_sim(
                    nmol=n // 3)}
    ap.add_argument("--path", choices=tuple(builders), default="bethe")
    ap.add_argument("--atom-order", action="store_true",
                    help="the atom-ordered interior, not the slot-major one")
    ap.add_argument("--cluster-switch", action="store_true",
                    help="config 4 with its fix cluster_switch (--path "
                         "density), through Simulation.run")
    a = ap.parse_args()
    if a.cluster_switch and a.path != "density":
        raise SystemExit("profile_paths: --cluster-switch needs --path "
                         "density")
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: no CUDA device")
    n = 2**20
    sim = (flagship.build_density_sim(n=n, cluster_switch=True)
           if a.cluster_switch else builders[a.path](n=n))
    n = sim.state.n_atoms
    if a.atom_order:
        sim._slot_ok = False
    interior = "slot-major" if sim._slot_ok else "atom-ordered"
    if a.cluster_switch:
        nre = sim.cswitch[1]             # steps per unit: one event each

        def unit():
            sim.run(nre)
    else:
        nre = sim.cfg.reneigh_every
        window = (0, 8 * nre)
        sim.setup(window)

        def unit():
            sim.run_fused(1, run_window=window)
    for _ in range(2):
        unit()
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / nre)
    block_ms.sort()
    ms_step = block_ms[2]

    undo = mark_sites(sim)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    undo()
    # kernels, copies and fills on the device (the aten ops that launch
    # them carry the same time and are left out)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not e.key.startswith("site:")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(card())
    busy_step = busy_ms / nre
    path = a.path + (" + cluster_switch" if a.cluster_switch else "")
    print(f"[{path} n={n}, {interior} interior] {ms_step:.3f} ms/step "
          f"untraced, median of 5 units ({block_ms[0]:.3f}-{block_ms[-1]:.3f}; "
          f"{1e3 / ms_step:.2f} steps/s); device busy {busy_step:.3f} "
          f"ms/step = {100 * busy_step / ms_step:.1f}% of the median step "
          f"(idle {100 * (1 - busy_step / ms_step):.1f}%); traced block "
          f"{wall_ms:.2f} ms ({nre} steps), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% under the profiler")
    rows = [e for e in events
            if "index" in e.key.lower() or "gather" in e.key.lower()]
    rows_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"row gathers and scatters: {rows_ms / nre:.3f} ms/step = "
          f"{100 * rows_ms / busy_ms:.1f}% of the device time "
          f"({sum(e.count for e in rows) / nre:.1f} launches/step)")
    slots = getattr(sim._nbr, "n_slots", None)
    if slots is not None:
        print(f"slot rows: n_slots {slots} = {slots / n:.3f} N (the rows "
              f"of the kernels' i-side block and, slot-major, of the "
              f"interior's per-atom arrays)")
    print(f"{'ms/step':>8} {'share':>6} {'calls':>6}  operation")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        t = e.self_device_time_total / 1e3
        print(f"{t / nre:8.3f} {100 * t / busy_ms:5.1f}% {e.count:6d}  "
              f"{e.key[:90]}")
    sites(prof, nre)
    op_by_site(prof, nre, "aten::cat")
    op_by_site(prof, nre, "aten::index_add_")
    return 0


if __name__ == "__main__":
    sys.exit(main())
