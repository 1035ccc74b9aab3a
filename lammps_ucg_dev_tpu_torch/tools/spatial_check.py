"""The spatial drivers' legs, run by ranks (``parallel/launch.py``): the
same jobs serve the CPU tests, ``chip_smoke.py``'s ranks sharing one card
over gloo, and one NCCL rank per card.

    python -m lammps_ucg_dev_tpu_torch.tools.spatial_check \\
        [--backend nccl|gloo] [--ranks 4] [--device cuda|cpu] [--n 1048576]
        [--small 32768] [--steps 100] [--timeout 900]

on its own runs these legs on ``--ranks`` x-slabs and prints one line
each, then a JSON line of the results: setup forces and pe of the four
styles at ``--small`` beads against one process's column path on rank
0's card; the 2^20 flagship (``--n``) through ``run_fused``: a warm block,
then ``--steps`` timed steps, the overflow and danger flags, K1's
launches per rank, the conservation check (Σ nloc = N, the tags a
permutation) and D1 on every rank; the NVE drift of the
``bench.run_drift`` protocol at ``--small`` beads; a ``processors R 1 1``
deck (``tools/make_deck.write_ucgld_deck``, ``--small`` beads, 20 steps)
against the same deck on one process; the molecular trimers
(``build_molecular_sim``, 3·(``--n`` // 3) beads, K1 with ``excl_delta``)
like the flagship, 20 timed steps; r-RESPA's drift with topology
(``build_respa_sim``, K 400, 4 inner steps, dt 0.004) at ``--small``;
config 4 with its switch at ``--n`` through 60 steps and two events; the
flagship at ``--small`` on the atom decomposition (``parallel/domain.py``)
over the ranks against one process.  Exit 0 when every gate holds: setup
f within 2e-5 of max|f| and pe 1e-5, Σ nloc = N, the tags a permutation,
D1 with no pair that was within cutoff + skin at a rebuild missing on
every slab leg, drift under 1e-4 (r-RESPA's under 2e-4), the deck's pe
within 1e-5, both events converged, the atom decomposition bit for bit
one process's.  The card's name and power limit come first.

A job is a dict; :func:`run_jobs` runs a list of them on one rank and
returns one result each (arrays from rank 0 only):

* ``run``: a builder's system (``style`` ucgld, bethe, p3 or p4; ``n``;
  ``kernel``: the column kernels, else the reference path; ``dtype``;
  ``nve``: Langevin off; ``reneigh``) on the grid ``dims``: ``steps``
  through ``run`` (thermo every ``thermo_every``), or with ``timed`` a
  warm block and ``steps`` timed through ``run_fused``, then one block
  with each exchange timed (``comm``: calls, ms a call, bytes this rank
  sends a step, by kind: migrate, halo, refresh, xchg); the gathered
  per-atom fields and forces in tag order when ``arrays``;
  (``inputs``: then the kernel inputs, as the ``inputs`` job gives them;
  ``residual``: then rank 0's :func:`excl_residual` at its last rebuild);
  ``style`` also molecular (``build_molecular_sim``, K1 with
  ``excl_delta``), mol_bethe (its Bethe form, K2), respa
  (``build_respa_sim``, ``respa_inner``) and switch (config 4 with its
  ``fix cluster_switch``, ``freq`` and ``max_sweeps`` to override), and
  ``bonds``, ``far_bond``, ``stream`` change the system (:func:`build`);
  ``cs_draws``: the events' accept uniforms (:func:`inject_draws`);
  with ``expect_error`` the error a rank raised, or None;
* ``inputs``: the kernel inputs (CPU tensors) of the last launch of each
  kernel variant in the setup and one block on rank 0's subdomain;
* ``domain``: a ``run`` job's system on ``parallel/domain.py``'s atom
  decomposition over all ranks (arrays from every rank);
* ``topo_drift``: the NVE drift of ``build_respa_sim`` (``respa_inner``,
  ``dt``, ``bond_k``; ``warm`` + the rest of ``steps``) and D1;
* ``switch_events``: config 4 with its switch block by block, each block
  timed, the event's sweeps and stats (:func:`switch_events`);
* ``drift``: the NVE drift protocol;
* ``stress``: a streaming fluid that migrates across the subdomains for
  ``blocks`` blocks;
* ``single``: the one-device run of another job (``job``), on rank
  ``rank`` alone (a reference beside the ranks' work);
* ``overflow``: a halo capacity of 8 must raise;
* ``deck``: a deck file run by ``compat.script.ScriptRunner`` on every
  rank (rank 0 keeps the files).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

def builder(style: str):
    from lammps_ucg_dev_tpu_torch import flagship

    def molecular(n, **kw):
        return flagship.build_molecular_sim(nmol=n // 3, **kw)

    def mol_bethe(n, **kw):
        return flagship.build_molecular_sim(nmol=n // 3, style="bethe", **kw)

    def respa(n, respa_inner=2, **kw):
        return flagship.build_respa_sim(nmol=n // 3, respa_inner=respa_inner,
                                        **kw)

    def switch(n, **kw):
        return flagship.build_density_sim(n=n, cluster_switch=True, **kw)

    return {"ucgld": flagship.build_sim, "bethe": flagship.build_bethe_sim,
            "p3": flagship.build_density_sim,
            "p4": flagship.build_rleucg_sim, "molecular": molecular,
            "mol_bethe": mol_bethe, "respa": respa, "switch": switch}[style]


# the builders whose cadence is their deck's (no reneigh_every keyword)
MOLECULAR = ("molecular", "mol_bethe", "respa")


def build(job: dict, device: str):
    """The single-device ``Simulation`` of a ``run`` job."""
    kw = {} if job.get("reneigh") is None else {
        "reneigh_every": job["reneigh"]}
    if job["style"] in MOLECULAR and kw:
        raise ValueError(f"style {job['style']!r} reneighbours at its "
                         "deck's cadence: drop 'reneigh'")
    if job["style"] == "respa" and "respa_inner" in job:
        kw["respa_inner"] = job["respa_inner"]
    sim = builder(job["style"])(
        n=job["n"], dtype=getattr(torch, job.get("dtype", "float32")),
        device=device, kernel=job.get("kernel"), **kw)
    if job.get("bonds"):
        sim = with_bonds(sim, job["bonds"])
    if job.get("far_bond"):
        sim.bonded = far_bond(sim)
    if job.get("stream"):
        v = sim.state.v.clone()
        v[:, 0] += job["stream"]
        sim.state = dataclasses.replace(sim.state, v=v)
    if job.get("nve"):
        sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    if sim.cswitch is not None:
        params, freq = sim.cswitch
        sim.cswitch = (dataclasses.replace(
            params, max_sweeps=job.get("max_sweeps", params.max_sweeps)),
            job.get("freq", freq))
    if job.get("log_dir") is not None:
        sim.log_dir = job["log_dir"]
    return sim


def inject_draws(sim, draws) -> None:
    """``sim``'s cluster_switch events take the accept uniforms ``draws``
    (one list per event) in turn, in place of its generator's: the hold
    against another implementation's draws."""
    it = iter(draws)
    sim._cs_draws = lambda p: torch.tensor(
        next(it), dtype=p.probON.dtype, device=p.probON.device)


def with_bonds(sim, count: int):
    """``sim`` with harmonic bonds (K 50, r0 the pair's distance) between
    each of the first ``count`` atoms and its nearest neighbour, and those
    pairs excluded (``special_bonds lj 0 0 0``): topology on a system
    whose builder has none (the density styles' in-pass exclusions)."""
    from lammps_ucg_dev_tpu_torch.models import bonded
    from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation

    st = sim.state
    x = st.x.double().cpu()
    dr = st.box.min_image(x[:count, None, :] - x[None, :, :].to(x))
    rsq = (dr * dr).sum(-1)
    rsq[torch.arange(count), torch.arange(count)] = float("inf")
    near = rsq.argmin(1).numpy()
    pairs = sorted({tuple(sorted((i, int(j)))) for i, j in
                    zip(range(count), near)})
    tag = st.tag.cpu().numpy()
    bonds = np.array([[k + 1, 1, tag[i], tag[j]]
                      for k, (i, j) in enumerate(pairs)])
    r0 = float(rsq.min(1).values.mean().sqrt())
    bp = bonded.make_params(bonds, {1: (50.0, r0)}, dtype=st.x.dtype,
                            device=st.device)
    excl = bonded.special_tags(st.n_atoms, bonds=bonds)
    return Simulation(sim.system, st, sim.pair_compute, sim.pair_params,
                      sim.nbr_spec, sim.cfg, seed=sim.seed,
                      cluster_switch=sim.cswitch, bonded=bp, excl_tags=excl)


def far_bond(sim):
    """``sim``'s bonded terms with one more bond, between the atom nearest
    the middle of the first of 3 x-slabs and the one farthest from it in
    x, half a box away: past the halo of its slab (the slab's half width
    plus cutoff + skin), so the slab driver must raise its overflow
    flag."""
    bp = sim.bonded
    st = sim.state
    L = st.box.lengths[0]
    x = st.box.wrap(st.x)[:, 0] - st.box.lo[0]
    i = torch.argmin((x - L / 6).abs())
    dx = torch.remainder(x - x[i] + L / 2, L) - L / 2      # minimum image
    j = torch.argmax(dx.abs())
    pair = st.tag[torch.stack([i, j])].long()
    tags = torch.cat([bp.bond_tags, pair[None]])
    return dataclasses.replace(bp, bond_tags=tags,
                               bond_k=torch.cat([bp.bond_k, bp.bond_k[:1]]),
                               bond_r0=torch.cat([bp.bond_r0,
                                                  bp.bond_r0[:1]]))


def arrays_of(state, fout) -> dict:
    """The per-atom fields of ``state`` and ``fout`` in tag order (numpy)."""
    order = torch.argsort(state.tag.long())
    vals = {"x": state.x, "v": state.v, "ucgl": state.ucgl,
            "ucgvl": state.ucgvl, "ucgp": state.ucgp,
            "ucgstate": state.ucgstate, "typ": state.typ, "f": fout.f,
            "ucgforce": fout.ucgforce}
    return {k: v[order].cpu().numpy() for k, v in vals.items()}


def launch_counters() -> dict:
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    return {"ucgld_pair": hp.ucgld_pair, "bethe_pair": hb.bethe_pair,
            "dbethe_pair": hd.dbethe_pair, "rleucg_pair": hr.rleucg_pair,
            "cv_rho": hcv.cv_rho, "cv_force": hcv.cv_force}


def zero_launches() -> None:
    for fn in launch_counters().values():
        for k in fn.launches:
            fn.launches[k] = 0


def read_launches() -> dict:
    return {name: {k: v for k, v in fn.launches.items() if v}
            for name, fn in launch_counters().items()
            if any(fn.launches.values())}


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _run(job, sp, device) -> dict:
    out = {}
    steps = job.get("steps", 0)
    if job.get("timed"):
        nre = sp.cfg.reneigh_every
        blocks = max(steps // nre, 1)
        window = (0, (blocks + 1) * nre)
        sp.setup(window)
        sp.run_fused(1, run_window=window)             # warm block
        zero_launches()
        _sync(device)
        t0 = time.perf_counter()
        sp.run_fused(blocks, run_window=window)
        _sync(device)
        wall = time.perf_counter() - t0
        out.update(launches=read_launches(), seconds=wall,
                   steps_s=blocks * nre / wall, rows=[sp.thermo()])
        # one more block with every exchange timed between two syncs
        sp.ring.stats = {}
        sp.run_fused(1, run_window=window)
        out["comm"] = {k: {"calls": c, "ms_per_call": 1e3 * t / c,
                           "bytes_per_step": b / nre}
                       for k, (c, t, b) in sp.ring.stats.items()}
        sp.ring.stats = None
    else:
        zero_launches()
        if steps:
            sp.run(steps, thermo_every=job.get("thermo_every", 0))
        else:
            sp.setup((0, 0))
        out.update(launches=read_launches(),
                   rows=list(sp.thermo_rows) or [sp.thermo()])
    state, fout = sp.gather()
    out.update(migrations=sp.migrations, dangerous=sp.dangerous_builds,
               nloc=int(sp._nloc), slab=dataclasses.asdict(sp.slab)
               if not job.get("arrays") else None)
    tags = np.sort(state.tag.cpu().numpy())
    out["tags_ok"] = bool(np.array_equal(tags,
                                         np.arange(1, state.n_atoms + 1)))
    if job.get("arrays") and sp.ring.rank == 0:
        out["arrays"] = arrays_of(state, fout)
        out["pe"] = float(fout.pe)
    if sp.cswitch is not None:
        out["cs_stats"] = sp.cswitch_stats.v.cpu().tolist()
        out["cs_sweeps"] = list(sp.cswitch_sweeps)
    if job.get("d1"):
        out["d1"] = missed_pairs(sp) if sp._column else None
    if job.get("residual") and sp.ring.rank == 0:
        out["residual"] = excl_residual(sp)
    if job.get("inputs"):
        inputs = _inputs(sp)                # every rank steps; 0 keeps
        out["inputs"] = inputs if sp.ring.rank == 0 else None
    return out


def missed_pairs(sp) -> dict:
    """D1 on this rank: the in-cutoff pairs (of owned atoms) at the block
    end by the list carried since the block's rebuild, against a fresh
    build on the same rows.  A pair the carried list lacks came closer
    than cutoff + skin after the rebuild (a dangerous build, as on one
    device) unless it was already that close at the rebuild: those,
    ``built_within_rc``, would be the list's fault."""
    from lammps_ucg_dev_tpu_torch.ops import colpack
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state, cl = sp.last_list()
    valid, i_owned = sp.last_masks()
    fresh = colpack.restrict_i(colpack.build(state.x, state.box, sp.nbr_spec,
                                             valid=valid), i_owned)
    n = state.n_atoms
    rows = torch.arange(n, dtype=torch.float32, device=state.device)

    def keys(lst):
        # the rows ride in the λ column, so each pair names its atoms
        ipack, cols = colpack.pack(lst, state.box, state.x, rows,
                                   state.ucgstate, dtype=torch.float32)
        scal = torch.zeros(8, dtype=torch.float32, device=ipack.device)
        scal[0:2] = state.box.lengths[0:2].float()
        scal[2] = float(sp.nbr_spec.cutoff) ** 2
        out = []
        for _, irows, jattr, *_, mask in hp.span_pairs(
                scal, lst.z0, lst.L, ipack, cols, mx=lst.mx, my=lst.my,
                observe=False, periodic=lst.periodic):
            i = irows[:, :, 3:4].expand(mask.shape)[mask].long()
            j = jattr(3).expand(mask.shape)[mask].long()
            out.append(i * n + j)
        return torch.cat(out)

    carried, now = keys(cl), keys(fresh)
    missed = now[~torch.isin(now, carried)]
    i, j = missed // n, missed % n
    d0 = state.box.min_image(cl.x0[i] - cl.x0[j]).norm(dim=-1)
    return {"carried": int(carried.numel()), "fresh": int(now.numel()),
            "missed": int(missed.numel()),
            "built_within_rc": int((d0 <= sp.nbr_spec.rc).sum()),
            "build_separation": [float(v) for v in d0[:8]]}


def variant_of(name: str, kw: dict) -> str:
    """The launch-count key of a wrapper's call with keywords ``kw``."""
    if name == "cv_rho":
        return "rho"
    observe = kw.get("observe", False)
    if name in ("ucgld_pair", "dbethe_pair"):
        scores = kw["want_scores"]
        if name == "ucgld_pair":
            return "full" if observe else ("fast" if scores else "noscores")
        return "full" if observe else ("fast" if scores else "fast_noscores")
    return "full" if observe else "fast"


def _inputs(sp) -> dict:
    """{"wrapper[variant]": (args, kwargs)} of the last launch of each
    kernel variant in the setup and one block on this rank, CPU copies:
    the kernels' inputs as the path gives them."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    store, saved = {}, []

    def cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    for mod, name in ((hp, "ucgld_pair"), (hb, "bethe_pair"),
                      (hd, "dbethe_pair"), (hr, "rleucg_pair"),
                      (hcv, "cv_rho"), (hcv, "cv_force")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            store[f"{_name}[{variant_of(_name, kw)}]"] = (
                tuple(cpu(a) for a in args), dict(kw))
            return _fn(*args, **kw)

        rec.launches = fn.launches
        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        nre = sp.cfg.reneigh_every
        sp.setup((0, nre))
        sp.run_fused(1, run_window=(0, nre))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return store


def _hamiltonian(sp) -> float:
    row = sp.thermo()
    state, _ = sp.gather()
    tp = sp.pair_params.tp
    mu = torch.where(tp.n_states[state.typ] > 1,
                     state.ucgl * tp.mu_diff[state.typ], 0.0)
    return row["etotal"] + float(mu.double().sum())


def topology_drift(sp, warm: int, steps: int) -> dict:
    """The NVE drift of the topology protocol (``chip_smoke.py`` phase 18)
    on the ranks: ``warm`` steps, H0, the rest of ``steps``, H1; D1 at the
    end."""
    nre = sp.cfg.reneigh_every
    window = (0, steps)
    sp.setup(window)
    sp.run_fused(warm // nre, run_window=window)
    e0 = _hamiltonian(sp)
    sp.run_fused((steps - warm) // nre, run_window=window)
    e1 = _hamiltonian(sp)
    return {"drift": abs(e1 - e0) / abs(e0),
            "d1": missed_pairs(sp) if sp._column else None}


def switch_events(sp, steps: int, device: str) -> dict:
    """Config 4 with its switch block by block through ``run_fused`` (the
    event riding each block it is due at), every block timed between two
    synchronizations: the events' block ms, the other blocks' median, the
    sweeps of each event, the stats, the launches of every block after
    the setup and D1 at the end."""
    nre = sp.cfg.reneigh_every
    window = (0, steps)
    sp.setup(window)
    zero_launches()
    event_ms, block_ms = [], []
    for _ in range(steps // nre):
        due = sp.event_due()
        _sync(device)
        t0 = time.perf_counter()
        sp.run_fused(1, run_window=window, do_cswitch=due)
        _sync(device)
        (event_ms if due else block_ms).append(
            1e3 * (time.perf_counter() - t0))
    return {"event_block_ms": event_ms,
            "block_ms": float(np.median(block_ms)) if block_ms else None,
            "sweeps": list(sp.cswitch_sweeps),
            "stats": sp.cswitch_stats.v.cpu().tolist(),
            "launches": read_launches(), "row": sp.thermo(),
            "d1": missed_pairs(sp) if sp._column else None}


def excl_residual(sp) -> dict:
    """On this rank at its last rebuild: K1 over every in-cutoff pair minus
    ``excl_delta`` over the owned rows' special lists, against K1's
    functional summed over a cell list of the same rows that leaves the
    specials out (``excl_delta`` over that list, ``chip_smoke.py`` phase
    16 on one device): the largest residual force on an owned atom with a
    special partner, and max|f| of the pairs that remain."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod

    state, cl = sp.last_list()
    valid, i_owned = sp.last_masks()
    _, rows, _ = sp._topology(state, valid, i_owned, sp._nloc)
    params = sp.pair_params
    n = state.n_atoms
    out = hp.compute(state, cl, params, params.cheb)
    spec = nbrmod.make_spec(n, state.box.lengths.double().cpu().numpy(),
                            sp.nbr_spec.cutoff, 0.0, method="cell")
    kept = nbrmod.build(state.x, state.box, spec, valid=valid,
                        i_valid=i_owned, excl=rows)
    rest = hp.excl_delta(state, kept.idx, params)
    res = (out.f - hp.excl_delta(state, rows, params).f - rest.f).double()
    has = (rows < n).any(1)
    return {"residual": float(res[has].abs().max()),
            "fscale": float(rest.f[i_owned].abs().max()),
            "atoms": int(has.sum()), "overflow": bool(kept.overflow)}


def _stress_sim(n: int, device: str, dtype):
    """The flagship fluid streaming at +10 in x, four steps a block: about
    twenty atoms cross each face every block."""
    from lammps_ucg_dev_tpu_torch import flagship

    sim = flagship.build_sim(n=n, dtype=dtype, device=device, kernel=False,
                             reneigh_every=4)
    v = sim.state.v.clone()
    v[:, 0] += 10.0
    sim.state = dataclasses.replace(sim.state, v=v)
    sim.cfg = dataclasses.replace(sim.cfg, langevin=None)
    return sim


def run_jobs(rank: int, world: int, device: str, jobs: list) -> list:
    """Every job of ``jobs`` on this rank of an initialised process group
    (``parallel/launch.spawn``'s ``fn``)."""
    from lammps_ucg_dev_tpu_torch.parallel import spatial
    from lammps_ucg_dev_tpu_torch.parallel.comm import Ring

    results = []
    for job in jobs:
        kind = job["kind"]
        ring = Ring(job.get("dims", (world, 1)))
        t0 = time.perf_counter()
        if kind == "run":
            sp = spatial.from_simulation(build(job, device), ring)
            if job.get("cs_draws"):
                inject_draws(sp, job["cs_draws"])
            if job.get("expect_error"):
                try:
                    _run(job, sp, device)
                    res = {"error": None}
                except RuntimeError as e:
                    res = {"error": str(e)}
            else:
                res = _run(job, sp, device)
        elif kind == "domain":
            from lammps_ucg_dev_tpu_torch.parallel import domain

            sim = domain.from_simulation(build(job, device), ring)
            steps = job["steps"]
            sim.setup((0, steps))
            zero_launches()
            _sync(device)
            t0 = time.perf_counter()
            sim.run(steps, thermo_every=job.get("thermo_every", 0))
            _sync(device)
            wall = time.perf_counter() - t0
            res = {"arrays": arrays_of(sim.state, sim._fcarry),
                   "rows": sim.thermo_rows, "launches": read_launches(),
                   "steps_s": steps / wall}
        elif kind == "topo_drift":
            from lammps_ucg_dev_tpu_torch import flagship

            sim = flagship.build_respa_sim(
                nmol=job["n"] // 3, device=device,
                respa_inner=job["respa_inner"], dt=job["dt"],
                bond_k=job["bond_k"])
            sp = spatial.from_simulation(sim, ring)
            res = topology_drift(sp, job["warm"], job.get("steps", 200))
        elif kind == "switch_events":
            sp = spatial.from_simulation(build(dict(job, style="switch"),
                                               device), ring)
            res = switch_events(sp, job["steps"], device)
        elif kind == "inputs":
            sp = spatial.from_simulation(build(job, device), ring)
            inputs = _inputs(sp)            # every rank steps; 0 keeps
            res = {"inputs": inputs if rank == 0 else None}
        elif kind == "drift":
            sim = build(dict(job, style="ucgld", reneigh=10, nve=True),
                        device)
            sim.cfg = dataclasses.replace(sim.cfg, dt=0.002)
            sp = spatial.from_simulation(sim, ring)
            sp.setup((0, 200))
            sp.run_fused(1, run_window=(0, 200))
            e0 = _hamiltonian(sp)
            sp.run_fused(19, run_window=(0, 200))
            e1 = _hamiltonian(sp)
            res = {"H0": e0, "H1": e1,
                   "drift": abs(e1 - e0) / max(abs(e0), 1e-12),
                   "slot": sp._slot_ok}
        elif kind == "stress":
            sim = _stress_sim(job["n"], device,
                              getattr(torch, job.get("dtype", "float64")))
            sp = spatial.from_simulation(sim, ring)
            res = _run(dict(job, steps=job["blocks"] * 4, arrays=True), sp,
                       device)
        elif kind == "single":
            if rank == job["rank"]:
                inner = job["job"]
                if inner["kind"] == "stress":
                    sim = _stress_sim(inner["n"], device, getattr(
                        torch, inner.get("dtype", "float64")))
                    steps = inner["blocks"] * 4
                else:
                    sim = build(inner, device)
                    steps = inner["steps"]
                sim.run(steps, thermo_every=inner.get("thermo_every", 0))
                res = {"arrays": arrays_of(sim.state, sim._fcarry),
                       "rows": sim.thermo_rows}
                if sim.cswitch is not None:
                    res["cs_stats"] = sim.cswitch_stats.v.cpu().tolist()
            else:
                res = {}
        elif kind == "overflow":
            sim = build(dict(job, style="ucgld", kernel=False), device)
            try:
                spatial.from_simulation(sim, ring, cap_halo=8).setup((0, 5))
                res = {"error": None}
            except RuntimeError as e:
                res = {"error": str(e)}
        elif kind == "deck":
            from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner

            r = ScriptRunner(workdir=job["workdir"],
                             dtype=getattr(torch, job.get("dtype", "float32")),
                             device=device)
            zero_launches()
            r.run_file(job["path"])
            res = {"rows": r.thermo_rows, "pair_path": r.pair_path,
                   "launches": read_launches(),
                   "spatial": isinstance(r.sim, spatial.SpatialSimulation),
                   "driver": type(r.sim).__name__}
            if job.get("arrays"):
                res["arrays"] = arrays_of(r.state, r.sim._fcarry)
            if r.sim.cswitch_stats is not None:
                res["cs_stats"] = r.sim.cswitch_stats.v.cpu().tolist()
        else:
            raise ValueError(f"unknown job kind {kind!r}")
        _sync(device)
        res["seconds_total"] = time.perf_counter() - t0
        results.append(res)
        ring.barrier()
    return results


# ---- the command line: the legs on their own ---------------------------------

def _single(job: dict, device: str) -> dict:
    """The setup forces and pe of a job's system on one process."""
    sim = build(job, device)
    fout = sim.setup((0, 0))
    state = sim.state
    return {"arrays": arrays_of(state, fout), "pe": float(fout.pe)}


def compare_setup(job, ref, got) -> dict:
    """Max |Δf| over max|f| and |Δpe|/|pe| of a spatial setup against one
    process's."""
    a, b = ref["arrays"], got["arrays"]
    scale = float(np.abs(a["f"]).max())
    return {"f": float(np.abs(b["f"] - a["f"]).max()) / scale,
            "pe": abs(got["pe"] - ref["pe"]) / abs(ref["pe"])}


def main(argv=None) -> int:
    from lammps_ucg_dev_tpu_torch.parallel import launch
    from lammps_ucg_dev_tpu_torch.tools import make_deck
    from lammps_ucg_dev_tpu_torch.tools.timing import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--small", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("spatial_check: no CUDA device")
    if a.device.startswith("cuda"):
        print(card(), flush=True)
    R = a.ranks
    dims = (R, 1)
    small = a.small
    setups = [dict(kind="run", style=s, n=small, kernel=None, dims=dims,
                   steps=0, arrays=True) for s in ("ucgld", "bethe", "p3",
                                                   "p4")]
    main_job = dict(kind="run", style="ucgld", n=a.n, kernel=None,
                    reneigh=20, dims=dims, steps=a.steps, timed=True,
                    d1=True)
    workdir = tempfile.mkdtemp(prefix="spatial-deck-")
    deck = make_deck.write_ucgld_deck(workdir, n=small, nsteps=20,
                                      thermo_every=10)
    text = open(deck).read()
    with open(deck, "w") as fh:
        fh.write(f"processors {R} 1 1\n" + text)
    mol_job = dict(kind="run", style="molecular", n=3 * (a.n // 3),
                   dims=dims, steps=20, timed=True, d1=True)
    small_dom = dict(kind="domain", style="ucgld", n=small - small % R,
                     steps=20,
                     thermo_every=10, dims=dims)
    jobs = setups + [main_job, dict(kind="drift", n=small, dims=dims),
                     dict(kind="deck", path=deck, workdir=workdir,
                          dims=dims),
                     mol_job,
                     dict(kind="topo_drift", n=3 * (small // 3) + 3,
                          respa_inner=4, dt=0.004, bond_k=400.0, warm=5,
                          dims=dims),
                     dict(kind="switch_events", n=a.n, steps=60,
                          dims=dims),
                     small_dom]
    t0 = time.perf_counter()
    res = launch.spawn(run_jobs, R, jobs, backend=a.backend,
                       device=a.device, timeout=a.timeout)
    wall = time.perf_counter() - t0
    out = {"ranks": R, "backend": a.backend, "wall_s": wall}
    for job, got in zip(setups, res[0][:4]):
        errs = compare_setup(job, _single(job, a.device), got)
        out[f"setup_{job['style']}"] = errs
        print(f"[{job['style']} setup n={small}, {R} slabs] vs one "
              f"process: f {errs['f']:.3e} of max|f|, pe {errs['pe']:.3e}",
              flush=True)
    mains = [r[4] for r in res]
    m = mains[0]
    out["main"] = {"steps_s": m["steps_s"], "seconds": m["seconds"],
                   "launches": [r["launches"] for r in mains],
                   "nloc": [r["nloc"] for r in mains],
                   "tags_ok": m["tags_ok"], "dangerous": m["dangerous"],
                   "migrations": m["migrations"],
                   "d1": [r["d1"] for r in mains], "row": m["rows"][0],
                   "comm": m["comm"]}
    print(f"[UCG-LD n={a.n} on {R} slabs, {a.backend}] {m['steps_s']:.2f} "
          f"steps/s; Σ nloc {sum(out['main']['nloc'])}; tags a permutation "
          f"{m['tags_ok']}; D1 {out['main']['d1']}; launches "
          f"{out['main']['launches']}; rank 0's exchanges (one more block, "
          f"each timed between syncs) {json.dumps(m['comm'])}", flush=True)
    out["drift"] = res[0][5]["drift"]
    print(f"[drift n={small}, {R} slabs] {out['drift']:.6e}", flush=True)
    single_dir = tempfile.mkdtemp(prefix="single-deck-")
    single = make_deck.write_ucgld_deck(single_dir, n=small, nsteps=20,
                                        thermo_every=10)
    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner

    one = ScriptRunner(workdir=single_dir, device=a.device,
                       log_callback=lambda msg: None)
    one.run_file(single)
    rows = res[0][6]["rows"]
    out["deck_pe_rel"] = max(abs(r["pe"] - q["pe"]) / abs(q["pe"])
                             for r, q in zip(rows, one.thermo_rows))
    print(f"[deck processors {R} 1 1 n={small}] pe against one process "
          f"{out['deck_pe_rel']:.3e}", flush=True)
    mols = [r[7] for r in res]
    mol = mols[0]
    out["molecular"] = {"steps_s": mol["steps_s"],
                        "launches": [r["launches"] for r in mols],
                        "nloc": [r["nloc"] for r in mols],
                        "tags_ok": mol["tags_ok"],
                        "d1": [r["d1"] for r in mols], "row": mol["rows"][0],
                        "comm": mol["comm"]}
    print(f"[molecular n={mol_job['n']} on {R} slabs, {a.backend}] "
          f"{mol['steps_s']:.2f} steps/s; Σ nloc "
          f"{sum(out['molecular']['nloc'])}; D1 {out['molecular']['d1']}; "
          f"launches {out['molecular']['launches']}; rank 0's exchanges "
          f"{json.dumps(mol['comm'])}", flush=True)
    out["respa_drift"] = res[0][8]["drift"]
    out["respa_d1"] = [r[8]["d1"] for r in res]
    print(f"[r-RESPA drift n={jobs[8]['n']}, {R} slabs] "
          f"{out['respa_drift']:.6e}; D1 {out['respa_d1']}", flush=True)
    sw = res[0][9]
    out["switch"] = {k: sw[k] for k in ("event_block_ms", "block_ms",
                                        "sweeps", "stats", "launches")}
    out["switch"]["d1"] = [r[9]["d1"] for r in res]
    print(f"[config 4 + cluster_switch n={a.n} on {R} slabs] sweeps "
          f"{sw['sweeps']}, event blocks {sw['event_block_ms']} ms against "
          f"a plain block's {sw['block_ms']} ms; launches "
          f"{json.dumps(sw['launches'])}; D1 {out['switch']['d1']}",
          flush=True)
    one_dom = build(dict(small_dom, kind="run"), a.device)
    one_dom.run(small_dom["steps"])
    ref_dom = arrays_of(one_dom.state, one_dom._fcarry)
    out["domain_equal"] = all(
        all(np.array_equal(r[10]["arrays"][k], ref_dom[k]) for k in ref_dom)
        for r in res)
    print(f"[atom decomposition n={small_dom['n']} over {R} ranks] bit for "
          f"bit one "
          f"process's on every rank: {out['domain_equal']}; launches "
          f"{json.dumps(res[0][10]['launches'])}", flush=True)
    slab_d1 = (out["main"]["d1"] + out["molecular"]["d1"] + out["respa_d1"]
               + out["switch"]["d1"])
    ok = (all(out[f"setup_{s}"]["f"] < 2e-5 and out[f"setup_{s}"]["pe"]
              < 1e-5 for s in ("ucgld", "bethe", "p3", "p4"))
          and sum(out["main"]["nloc"]) == a.n and m["tags_ok"]
          and sum(out["molecular"]["nloc"]) == mol_job["n"]
          and mol["tags_ok"]
          and all(d is None or d["built_within_rc"] == 0 for d in slab_d1)
          and out["drift"] < 1e-4 and out["deck_pe_rel"] < 1e-5
          and out["respa_drift"] < 2e-4 and len(sw["sweeps"]) >= 2
          and out["domain_equal"])
    out["ok"] = bool(ok)
    print(json.dumps(out, default=float), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
