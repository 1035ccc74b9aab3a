#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four main paths on the card — the flagship 2-state UCG-LD
fluid (``flagship.build_sim``, kernel K1 ``csrc/ucgld_pair.cu``), the
config-3 self-consistent Bethe fluid (``flagship.build_bethe_sim``, kernel
K2 ``csrc/bethe_pair.cu``), the config-4 density-CV system
(``flagship.build_density_sim``, K5 → K3 → K6) and the config-5 RLE-UCG
interface system (``flagship.build_rleucg_sim``, K5 → K4 → K6; K3 and K4
are styles of ``csrc/bethe_pair.cu``, K5 and K6 ``csrc/density_cv.cu``),
all at 2^20 beads through ``Simulation`` — and the two paths of the JAX
package's remaining TPU kernels: the K1 ablation microbench
(``tools/kbench.py`` of the port, kernel K7 ``csrc/ucgld_ablation.cu``)
and the flagship fluid on cell-padded cluster lists
(``flagship.build_cluster_sim``, kernel K8 ``csrc/ucgld_cluster.cu``),
after building the kernels with nvcc (one process per source, started
together) into ``lammps_ucg_dev_tpu_torch/_build/``.  Phases, each of
which raises on failure:

1. the card's name and power limit, torch and CUDA versions;
2. the kernels' build;
3. K1 against its plain PyTorch twin in all three variants on the same
   inputs, at 32,768 beads and at the main path's 2^20, with both times;
   K7 at its five levels against its twins, and level 4 against K1's
   no-scores kernel, at 32,768 and 2^20; then the K1 path against the
   float64 reference pair path on 4,096;
3b. the K7 ablation table at 2^20 (``tools.kbench.run``), with K7's launch
   counts set to 0 just before and read just after;
4. the UCG-LD main path: setup, one warm block, five timed blocks of 20
   steps, with K1's launch counts set to 0 just before and read just after;
5. the NVE energy drift by the JAX package's ``bench.run_drift`` protocol
   (32,768 beads, Langevin off, dt 0.002, 1 + 19 blocks of 10 steps);
6. K2 against its twin: bethe pseudolikelihood full and fast at 32,768 and
   2^20, mf and full-SCE full and fast at 32,768, every variant on a 2-type
   mixed system of 8,192;
7. the K2 path against the float64 reference pair path on 4,096;
8. the Bethe main path: setup, one warm block, twenty timed blocks of 5
   steps, with K2's launch counts set to 0 just before and read just after;
9. K5, K3 and K6 against their twins on the inputs the P3 path gives them
   (K3 full, fast and fast without scores with the path's method, and
   with mf off the path; K6 full and fast with the path's g-form, and with
   the two others off the path) at 32,768 and 2^20; K5, K4 (full and
   fast, both feedback modes) and K6 likewise on P4;
10. the K3 path and the K4 path against the port's reference pair path in
   float32 on the same 4,096-bead inputs, at the JAX package's
   kernel-vs-XLA gates, with the gap to the float64 reference printed;
11. the P3 and P4 main paths: setup, one warm block, ten timed blocks of 10
   steps, with every launch count set to 0 just before and read just after;
12. K8 against its twin at 32,768 and 2^20 (columns, pe, virial and the
   inner-cutoff count gated apart; the rows of the i-clusters without
   atoms, which its grid leaves to the occupied clusters' warps, exactly
   zero);
13. the K8 path against the float64 reference pair path on 4,096, at K1's
   Chebyshev gate;
14. the cluster main path at 2^20: setup, one warm block, five timed blocks
   of 20 steps, K8 on every step, with its launch count set to 0 just
   before and read just after;
15. the slot-major interior against the atom-ordered one: each column
   style (UCG-LD under ``ucgstate ld`` and ``default``, Bethe, P3, P4) at
   32,768 beads, two blocks through ``Simulation``, once as the driver
   chooses (``_slot_ok`` must be true) and once with ``_slot_ok`` set
   false: x, v, λ, λ-velocity, ucgp, ucgstate, f, the λ-force and pe must
   be the same bits, and every kernel's launches the same; UCG-LD's
   interior must launch K1 without scores under ``ld`` and with them
   under ``default``, and not the other variant;
16. exclusions on the card: the molecular trimers
   (``flagship.build_molecular_sim``, 4,095 beads) on K1's path with
   ``excl_delta`` subtracted, and under ``table_ucg_bethe`` on K2's with
   ``excl_delta_bethe``, against the float64 reference path whose nsq list
   leaves the specials out, at K1's and K2's oracle gates; and the
   largest residual force of K(all pairs) - excl_delta against K's
   functional over a list without the specials, on the atoms with a
   special partner (within TOL of max|f|);
17. the molecular main path at 1,048,575 beads (349,525 trimers): setup,
   one warm block, twenty timed blocks of 5 steps, K1's launch counts set
   to 0 just before and read just after, K1 against its twin on the
   state the run reached in the path's two variants (full and without
   scores), the CUDA-event spans of ``bonded.compute`` and
   ``excl_delta`` per step over one more block, then D1;
18. NVE drift with topology on the kernel path at 32,769 beads, Langevin
   off: Verlet (bonds 50, dt 0.001) under 1e-4; r-RESPA (bond K 400, 4
   inner steps, dt 0.004) under 2e-4 and under a fifth of plain Verlet's
   at the same K and dt;
19. config 4 with its ``fix cluster_switch`` at 2^20
   (``build_density_sim(cluster_switch=True)``) through
   ``Simulation.run``: 20 warm steps, then five events and the 100 steps
   they start, every launch count set to 0 just before and read just
   after; steps/s with the events, each event's ms, sweeps and cluster
   size, the 7-stat vector; K5, K3 and K6 against their twins on the
   state the run reached; then D1;
20. the tetramer deck (``build_tetramer_sim``, 32,768 beads):
   ``bonded.compute`` in f32 on the card against f64 (forces, pe, virial,
   with dihedrals and impropers; near-planar impropers held to their f32
   conditioning), and one block of its K1 path;
21. the deck entry point at full width: ``tools/make_deck.write_ucgld_deck``
   at 2^20 beads (its published settings; ``run 200``, ``thermo 100``, a
   dump every 100 steps, ``write_data`` and ``write_restart``) through
   ``compat.script.ScriptRunner`` on the card, line by line: the
   ``pair path:`` line must name K1, the interior be slot-major, K1's
   launches in the ``run`` (counts set to 0 just before it) be full and
   without scores alone, the native dump writer write every frame, the
   thermo rows be finite with no pair outside the tables and λ inside the
   walls; printed: the deck's steps/s (the ``run`` command, and its
   stepping alone) beside phase 4's, and ms per ``read_data``, dump frame,
   ``write_restart``, ``write_data`` and ``rerun`` frame; then K1 against
   its twin on the state the run reached (``@deck`` entries);
22. restart continuity on the card: the UCG-LD deck at 32,768 beads
   (Langevin on λ, ``ucgstate ld``), ``run 40`` against ``run 20`` +
   ``write_restart`` + a new runner's ``read_restart`` + ``run 20``: x, v,
   λ, λ-velocity and ucgp the same bits;
23. the other decks on the card: Bethe (K2), config 4 with its
   ``cluster_switch`` (K5, K3, K6 and its first event at step 20 at 4,096
   beads; at 32,768 its ``run 100`` completes through four events, each
   converged under the runner's ``max_sweeps`` n + 1 and its sweeps
   printed; the config-4 and RLE-UCG decks at 4,096 with 64 bonds and
   ``special_bonds lj 0 0 0`` run K5, K3/K4 and K6 with the density
   ``excl_delta``, their step-0 pe within 1e-6 of the float64 reference
   path on the CPU, and the excluded pairs cancel: the kernel path's
   forces against its own float32 functional over a list without the
   specials within TOL of max|f| on the atoms with a special partner),
   RLE-UCG (K5, K4, K6) and
   molecular UCG-LD (K1 with ``excl_delta``) at 32,768, the molecular
   switch deck at its 192 beads (the reference path: no 2-state type);
   each deck's kernels launched, its rows finite, and each at 4,096 beads
   to step 0 on the card against the float64 reference path on the CPU
   within the matching oracle phase's pe gate; last, the ``verify``
   skill's deck fingerprint (n 1,000): step-0 etotal 5520.27;
24. table styles: the UCG-LD deck at 2^20 with ``spline 2000``, then with
   ``bitmap 12`` on the same data file (its sha256 printed and checked
   the same; ``run 200``, ``thermo 100``, no dumps): K1 named and launched (full and without scores only), finite
   rows, no pair outside the tables, the fit's degree and error, the
   stepping's steps/s beside phase 21's and the column slots printed, K1
   against its twin on the state reached (``@spline``, ``@bitmap``
   entries); the Bethe deck with ``spline`` at 32,768 through K2 the
   same way (``@spline``); a ``lookup 2000`` deck at 32,768 on the
   reference path (LOOKUP does not fit), K1 launched 0 times; each of the
   four at 4,096 to step 0 against the float64 reference path on the CPU
   within max(3e-5, 5 × fit error) in pe (LOOKUP phase 3's 1e-5);
25. a tilted box and the driver's switches: the UCG-LD deck with ``xy xz
   yz`` = (0.1, -0.05, 0.08) L at 32,768 beads on the nsq reference path
   (logged), Langevin off, dt 0.002: the NVE drift of ``bench.run_drift``'s
   blocks (``run 10`` then ``run 180``) under 1e-4; at 4,096 to step 0
   against float64 on the CPU; then ``sort_atoms`` on against off on the
   flagship's cell reference path at 32,768 for 20 steps, x by tag within
   1e-5 of the box;
26. the spatial drivers (``parallel/spatial.py``) on 3 gloo ranks sharing
   the card (``run_spatial``): each style's setup at 32,768 beads against
   one process's column path; the 2^20 flagship on 3 slabs, 100 timed
   steps, D1 on every rank (no pair that was within cutoff + skin at a
   rebuild missing from its list), Σ nloc = N and the tags a permutation;
   Bethe, P3 and P4 at 2^20 for 20 steps; K1–K6 on rank 0's inputs (the x
   axis not periodic) against their twins (``@slab`` entries); the NVE
   drift at 32,768; a ``processors 3 1 1`` deck against one process; then
   a 3×3 pencil grid's setup on 9 ranks at 2^18;
27. the rest of the spatial drivers (``run_spatial_rest``) on 3 gloo ranks
   sharing the card: the molecular trimers (K1 with ``excl_delta`` on the
   owned rows, the bonded terms by member share) at 32,769 beads, their
   setup against one process; at 1,048,575, 20 timed steps beside phase
   17's one card, D1 per rank, the excluded pairs' residual on rank 0 and
   K1 on rank 0's inputs against its twin (``@molecular@slab``
   entries); the topology drift at 32,769 (Verlet and r-RESPA); config 4
   with its switch at 2^20 through two events (sweeps and ms each, K5, K3
   and K6 launched); then the ``processors 2 1 1`` flagship deck at 32,768
   on 2 ranks through the atom decomposition (``parallel/domain.py``), K1
   launched, bit for bit one process's state.

The decks are written into ``_decks/`` beside this script (listed in
``.gitignore``) and removed after each phase.

The molecular paths (16–18, 20) run atom-ordered: the driver turns the
slot-major interior off with topology, as the JAX package does.  The
column main paths (4, 8, 11, 19) and the drift leg (5) run slot-major, as
the JAX package's main path does; each column main path also prints one
reading of its steps/s with the atom-ordered interior (``_slot_ok`` set
false), the same number of timed blocks after a warm one, not gated.

Each check of a kernel against its twin also launches the kernel twice
and requires the same bits (K1, K2, K5, K6, K7 and K8 run on the tile walk
of ``csrc/colspan.cuh``, K3 and K4 on its compacting walk; both sum in an
order the inputs alone fix).  Each of the main paths (4, 8, 11, 14,
17, 19) ends with D1, the dangerous-build check: the in-cutoff pairs of the column or cluster list carried since the last rebuild against
those of a fresh build on the same positions, printed, not gated.

The line before the last is a JSON object of the kernels on the main paths
(times, errors, launches and the bound each kernel's work puts on its time),
one entry per kernel variant and path: a kernel that runs on several main
paths has an entry for each (``@molecular``, ``@P4``,
``@P3+cluster_switch``, ``@slab``, ``@molecular@slab``), with that path's
launches and its times, error and
bound on that path's inputs;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# the package beside this script; without it the script stops here
from lammps_ucg_dev_tpu_torch.tools.timing import card, cuda_ms  # noqa: E402

K1_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/ucgld_pair.cu"
K2_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/bethe_pair.cu"
CV_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/density_cv.cu"
K7_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/ucgld_ablation.cu"
K8_SOURCE = "lammps_ucg_dev_tpu_torch/csrc/ucgld_cluster.cu"
REPLACES = "lammps_ucg_dev_tpu/ops/pallas_pair.py:719"
CV_REPLACES = "lammps_ucg_dev_tpu/ops/pallas_pair.py:944"
K7_REPLACES = "tools/kbench.py:41"
K8_REPLACES = "attic/pallas_ucgld.py:77"
TOL = 2e-5       # kernel vs twin: f32 sums taken in another order (see below)
DRIFT_MAX = 1e-4
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- the least time the card needs for a kernel's work ---------------------

def rows_needed(kernel: str, kw: dict, multi: bool) -> int:
    """The D-form rows [eA eB eC eD fA fB fC fD] a pair kernel variant's
    outputs read, whatever rows the kernel evaluates: the four f rows for
    the forces; K1 eB, eD for the λ-force and all 8 with scores or pe; K2
    all 8 (its scores); K3 eB, eD for pf1 and, with several actual types,
    eA for a plain partner's pf0 (7), all 8 with scores or pe; K4 eB, eD
    with feedback, all 8 with pe."""
    observe = kw.get("observe", False)
    if kernel == "ucgld":
        return 8 if observe or kw["want_scores"] else 6
    if kernel == "bethe":
        return 8
    if kernel == "dbethe":
        return 8 if observe or kw["want_scores"] else (7 if multi else 6)
    if kernel == "rleucg":
        return 8 if observe else (6 if kw["feedback"] else 4)
    raise ValueError(f"no coefficient rows for {kernel}")


def kernel_ops(kernel: str, kw: dict, nrow: int) -> tuple[float, float]:
    """(operations per candidate, operations per in-cutoff pair) of one
    kernel variant: each add, multiply, divide, compare-select, exp, log,
    tanh or sqrt one operation, an FMA two.  A candidate costs its distance
    test (10); a pair of the table kernels the u map (2), the Chebyshev
    series of the ``nrow`` rows its outputs need (:func:`rows_needed`; 2 per
    row to start, then 2 + 2 per row for each further degree), and the
    style's mixing and tallies as written in the kernel source."""
    if kernel == "cv_rho":
        return 10.0, 9.0           # sqrt, the tanh argument, tanh, 2 sums
    if kernel == "cluster":
        # a candidate: 3 subtractions, divides, rints and FMAs of the min
        # image, rsq, the cutoff, slot-id and validity tests; a pair: the
        # same function as K1 full on the same single-type fluid (forces,
        # λ-force, scores, pe, virial, oob), counted as K1 full's is: one
        # shared recurrence and one FMA per row and degree over the 8 rows,
        # whatever summation the kernel is written with (it uses Clenshaw)
        full = dict(observe=True, want_scores=True, degree=kw["degree"])
        return 23.0, kernel_ops("ucgld", full, rows_needed("ucgld", full,
                                                           False))[1]
    if kernel == "abl":
        level = kw["level"]
        if level == 0:
            return 2.0, 0.0        # the shift and the sum, no cutoff test
        if level == 1:
            return 10.0, 1.0       # the distance test; the rsq sum
        nrow = 0 if level == 2 else nrow
        series = 2 + 2 * nrow + (kw["degree"] - 2) * (2 + 2 * nrow)
        return 10.0, float(series + {2: 1, 3: 2, 4: 16}[level])
    if kernel == "cv_force":
        per = 20.0                 # sqrt, tanh, g, fcv, 3 force sums
        if kw["pertype"]:
            per += 9.0             # the partner's radius, tanh and g
        if kw["observe"]:
            per += 18.0            # 6 virial sums
        return 10.0, per
    degree = kw["degree"]
    series = 2 + 2 * nrow + (degree - 2) * (2 + 2 * nrow)
    tail = 12                                     # fmix + three force sums
    if kw["observe"]:
        tail += 26                                # pe, 6 virial sums, oob
    if kernel == "ucgld":
        tail += 4 + (8 if kw["want_scores"] else 0)   # λ-force, scores
    elif kernel == "rleucg":
        tail += 1 + (3 if kw["feedback"] else 0)  # p11, the pf0 tally
    else:
        if not kw["mf"]:
            tail += 22                            # xk, exp, Q, D, sqrt, root
        if kernel == "bethe":
            tail += 21 if kw["sce"] else 8        # conditional or pseudo
        else:                                     # dbethe: ln(p11/p01), pf
            tail += (5 if kw["mf"] else 25) + (8 if kw["want_scores"] else 0)
    return 10.0, float(series + tail)


def kernel_io(kernel: str, kw: dict, multi: bool):
    """(i-slot attributes, candidate attributes, output columns, per-slot
    columns) that one kernel variant reads and defines.  Attributes index
    ipack's columns and cols' rows, [x y z a3 state valid a6 typ]; every
    kernel reads its i-slot's x y z and valid, and its candidates' x y z
    (and valid when it observes).  ``multi``: the rows of each type pair
    (the pair kernels) or the per-type radius (K5/K6), which read typ."""
    observe = kw.get("observe", False)
    typ = {7} if multi else set()
    irows, jrows = {0, 1, 2, 5} | typ, {0, 1, 2} | ({5} if observe else set())
    if kernel == "cv_rho":
        return irows, {0, 1, 2}, 2, 0                 # [ρ n_real]
    if kernel == "abl":
        level = kw["level"]
        if level == 0:                                # valid; x of each j
            return {5}, {0}, 1, 0
        if level < 4:
            return irows, jrows, 1, 0
        return irows | {3}, jrows | {3}, 4, 0         # f, λ-force
    if kernel == "cv_force":
        # [Fx Fy Fz], the virial (pe and oob are 0)
        return irows | {6}, jrows | {3} | typ, 3, 6 if observe else 0
    part = 8 if observe else 0                        # pe, virial, oob
    if kernel == "ucgld":
        scores = kw["want_scores"]
        return (irows | {3}, jrows | {3} | typ | ({4} if scores else set()),
                4 + (2 if scores else 0), part)      # f, λ-force, scores
    if kernel == "bethe":                             # f, scores
        return (irows | {6}, jrows | {3} | typ
                | (set() if kw["sce"] else {4}), 5, part)
    if kernel == "dbethe":                            # f, pf0, pf1, scores
        scores = kw["want_scores"]
        return (irows | {6}, jrows | {3} | typ | ({4} if scores else set()),
                5 + (2 if scores else 0), part)
    return (irows | {6}, jrows | {3} | typ,           # rleucg: f, pf0
            3 + (1 if kw["feedback"] else 0), part)


def least_time(pairs: int, cand: int, ops: float, nbytes: int) -> dict:
    """The larger of ``ops`` over the f32 peak and ``nbytes`` over the
    memory rate, and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    r = {"bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "pairs": pairs, "candidates": cand, "ops": ops, "bytes": nbytes}
    log(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}: {pairs} pairs "
        f"of {cand} candidates, {ops:.4e} operations, {nbytes} bytes")
    return r


def bound(kernel: str, args, kw) -> dict:
    """Least time of one launch on these inputs: the larger of its
    operations (this data's candidates and in-cutoff pairs, counted by the
    twins' span walk; the pair kernels' series over the rows their outputs
    need, :func:`rows_needed`) over the f32 peak and its bytes over the
    memory rate: every small input (scalars, spans, coefficient rows,
    radii) read once, the i-slot and candidate attributes it reads
    (:func:`kernel_io`) read once, the output columns it defines written
    once."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    scal, z0, span_len, ipack, cols = args[:5]
    observe = kw.get("observe", False)
    pairs = 0
    for *_, mask in hp.span_pairs(scal, z0, span_len, ipack, cols,
                                  mx=kw["mx"], my=kw["my"], observe=observe,
                                  periodic=kw.get("periodic", (True, True))):
        pairs += int(mask.sum())
    per_slot = span_len.sum(-1).reshape(-1).repeat_interleave(8)
    cand = int((per_slot * (ipack[:, 5] > 0.5)).sum())
    multi = (kw["pertype"] if kernel.startswith("cv_")
             else args[5].dim() == 4)
    nrow = (rows_needed(kernel, kw, multi)
            if kernel in ("ucgld", "bethe", "dbethe", "rleucg")
            else args[5].shape[0])
    per_cand, per_pair = kernel_ops(kernel, kw, nrow)
    ops = cand * per_cand + pairs * per_pair
    irows, jrows, out_cols, part_cols = kernel_io(kernel, kw, multi)
    n_slots, ncol, _, czp = ipack.shape[0], *cols.shape
    nbytes = sum(a.numel() * a.element_size() for a in (args[1:3] + args[5:])
                 if isinstance(a, torch.Tensor)) + scal.numel() * 4
    nbytes += 4 * (n_slots * (len(irows) + out_cols + part_cols)
                   + ncol * czp * len(jrows))
    return least_time(pairs, cand, ops, nbytes)


def bound_cluster(args, kw) -> dict:
    """:func:`bound` for K8: its candidates (every real i-slot against
    every real slot of its cluster's list) and in-cutoff pairs (counted by
    the twin's walk); the bytes of scal, the coefficient rows, ``jcl``, the
    six attributes of ``apack`` it reads [x y z λ state valid], and its
    six output and eight per-slot columns."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    scal, apack, jcl, coef = args
    pairs = 0
    for *_, mask in hc.cluster_pairs(scal, apack, jcl):
        pairs += int(mask.sum())
    cand = hc.candidates(apack, jcl)
    per_cand, per_pair = kernel_ops("cluster", kw, 8)
    ops = cand * per_cand + pairs * per_pair
    n_slots = apack.shape[0]
    nbytes = (scal.numel() * 4 + coef.numel() * 4 + jcl.numel() * 4
              + 4 * n_slots * (6 + 6 + 8))
    return least_time(pairs, cand, ops, nbytes)


# ---- a kernel against its twin ---------------------------------------------

def hold(label: str, name: str, kernel, twin, args, kw, kernel_reps: int,
         twin_reps: int, exact=()) -> dict:
    """One kernel variant against its twin on the same CUDA tensors.
    Tolerances (both sides f32, the same algorithm; they differ by FMA
    contraction and summation order): each output column within TOL times
    its largest magnitude (the columns in ``exact``, counts, exactly); with
    an observing variant's per-slot rows summed, pe within TOL relative,
    the virial within TOL times its largest component and the inner-cutoff
    count exactly.  A second launch must give the same bits: no kernel
    uses atomics, so each sums in an order its inputs fix."""
    import torch

    def pair(r):
        return r if isinstance(r, tuple) else (r, None)

    # time the kernel before the twin has run on the card
    ms = cuda_ms(lambda: kernel(*args, **kw), kernel_reps, warmup=3)
    out_k, part_k = pair(kernel(*args, **kw))
    out_t, part_t = pair(twin(*args, **kw))
    torch.cuda.synchronize()
    errs, bad = {}, []
    out_2, part_2 = pair(kernel(*args, **kw))
    if not (torch.equal(out_k, out_2)
            and (part_k is None or torch.equal(part_k, part_2))):
        bad.append("two launches on the same inputs differ")

    def gate(key, diff, ref, is_exact=False):
        err, scale = float(diff.abs().max()), float(ref.abs().max())
        errs[key] = err / scale if scale > 0 else err
        if (err != 0.0) if is_exact else (err > TOL * max(scale, 1e-30)):
            bad.append(f"{key} differs by {err:.3e} (scale {scale:.3e})")

    for out, what in ((out_k, "output"), (part_k, "per-slot rows")):
        if out is not None and not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label} {name}: non-finite {what}")
    for c in range(out_k.shape[1]):
        gate(f"c{c}", out_k[:, c] - out_t[:, c], out_t[:, c], c in exact)
    if part_k is not None:
        tk, tt = part_k.double().sum(0), part_t.double().sum(0)
        gate("pe", tk[0] - tt[0], tt[0])
        gate("virial", tk[1:7] - tt[1:7], tt[1:7])
        gate("oob", tk[7] - tt[7], tt[7], is_exact=True)
    if bad:
        raise RuntimeError(f"{label} {name}: " + "; ".join(bad))
    max_abs = float((out_k - out_t).abs().max())
    plain_ms = cuda_ms(lambda: twin(*args, **kw), twin_reps)
    log(f"[{label}] {name:24s} vs twin: max|out diff| {max_abs:.3e}, rel "
        f"errs {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
        f"; kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
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


K1_VARIANTS = {"full": (True, True), "fast": (False, True),
               "noscores": (False, False)}       # name: (observe, scores)


def compare_k1(sim, label: str, kernel_reps: int, twin_reps: int,
               with_bound: bool = False, variants=tuple(K1_VARIANTS)):
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state, cl = column_state(sim)
    params, cheb = sim.pair_params, sim.pair_params.cheb
    res = {}
    for name in variants:
        observe, scores = K1_VARIANTS[name]
        args, kw = hp.kernel_inputs(state, cl, params, cheb, observe, scores)
        res[name] = hold(label, f"K1 {name}", hp.ucgld_pair,
                         hp.ucgld_pair_reference, args, kw, kernel_reps,
                         twin_reps)
        if with_bound:
            res[name].update(bound("ucgld", args, kw))
    return res


def compare_k7(sim, label: str, kernel_reps: int, twin_reps: int,
               with_bound: bool = False) -> dict:
    """K7 at every level against its twin on K1's no-scores inputs of
    ``sim``, and level 4 against K1's no-scores kernel on the same inputs
    (the same arithmetic: within TOL of each column's scale)."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state, cl = column_state(sim)
    params, cheb = sim.pair_params, sim.pair_params.cheb
    args, kw = ha.kernel_inputs(state, cl, params, cheb)
    res = {}
    for level in ha.LEVELS:
        lkw = dict(kw, level=level)
        res[level] = hold(label, f"K7 L{level}", ha.ucgld_ablation,
                          ha.ablation_reference, args, lkw, kernel_reps,
                          twin_reps)
        if with_bound:
            res[level].update(bound("abl", args, lkw))
    k1_args, k1_kw = hp.kernel_inputs(state, cl, params, cheb, False, False)
    k1, _ = hp.ucgld_pair(*k1_args, **k1_kw)
    l4 = ha.ucgld_ablation(*args, **kw, level=4)
    torch.cuda.synchronize()
    for c in range(4):
        err = float((l4[:, c] - k1[:, c]).abs().max())
        scale = float(k1[:, c].abs().max())
        if err > TOL * scale:
            raise RuntimeError(f"{label} K7 L4 column {c} differs from K1 "
                               f"no-scores by {err:.3e} (scale {scale:.3e})")
    log(f"[{label}] K7 L4 vs K1 noscores kernel: max|diff| "
        f"{float((l4 - k1).abs().max()):.3e}, bit-identical "
        f"{bool(torch.equal(l4, k1))}")
    return res


def missed_pairs(sim, label: str) -> int:
    """D1, the dangerous-build check: the in-cutoff pairs that the column
    list carried since the last rebuild gives at ``sim``'s current
    positions, against a fresh ``colpack.build`` on the same positions.
    Prints both counts and their difference; does not gate."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import colpack
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    state, spec = sim.state, sim.nbr_spec
    dev = state.device
    zeros = torch.zeros(state.n_atoms, dtype=torch.float32, device=dev)
    L = state.box.lengths.float()
    z = torch.zeros((), device=dev)
    scal = torch.stack([L[0], L[1],
                        torch.tensor(spec.cutoff ** 2, device=dev), z, z, z,
                        z, z]).float()

    def count(cl, x):
        ipack, cols = colpack.pack(cl, state.box, x, zeros, zeros)
        return sum(int(mask.sum()) for *_, mask in hp.span_pairs(
            scal, cl.z0, cl.L, ipack, cols, mx=cl.mx, my=cl.my,
            observe=False))

    carried = count(sim._nbr, state.x)
    x_w, _ = state.box.wrap(state.x, state.image)
    fresh = count(colpack.build(x_w, state.box, spec), x_w)
    log(f"[D1 {label}] in-cutoff pairs at the block end: carried list "
        f"{carried}, fresh build {fresh}, difference {fresh - carried} "
        f"(dangerous builds {sim.dangerous_builds})")
    return fresh - carried


def missed_cluster_pairs(sim, label: str) -> int:
    """D1 on the cluster path: the in-cutoff pairs (K8's pair rule, by
    its twin's walk) of the cluster list carried since the last rebuild at
    ``sim``'s current positions, against a fresh ``clusters.build`` on the
    same positions, wrapped.  Prints both counts and their difference; does
    not gate."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    state, params = sim.state, sim.pair_params
    scal = hc.kernel_scalars(state.box, params, params.cheb)

    def count(cl, st):
        apack = hc.slot_pack(st, cl)
        return sum(int(mask.sum())
                   for *_, mask in hc.cluster_pairs(scal, apack, cl.jcl))

    carried = count(sim._nbr, state)
    wrapped, fresh_cl = cluster_state(sim)
    fresh = count(fresh_cl, wrapped)
    log(f"[D1 {label}] in-cutoff pairs at the block end: carried list "
        f"{carried}, fresh build {fresh}, difference {fresh - carried} "
        f"(dangerous builds {sim.dangerous_builds})")
    return fresh - carried


def cluster_state(sim):
    """``sim``'s state wrapped into the box and a fresh cluster list."""
    from lammps_ucg_dev_tpu_torch.ops import clusters

    state = sim.state
    state = dataclasses.replace(state, x=state.box.wrap(state.x))
    cl = clusters.build(state.x, state.box, sim.nbr_spec)
    if bool(cl.overflow):
        raise RuntimeError("cluster list overflow")
    return state, cl


def compare_k8(sim, label: str, kernel_reps: int, twin_reps: int,
               with_bound: bool = False) -> dict:
    """K8, launched over the list's occupied i-clusters as the path
    launches it, against its twin; the rows of the i-clusters without atoms
    must be exactly zero."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    state, cl = cluster_state(sim)
    params = sim.pair_params
    args, kw = hc.kernel_inputs(state, cl, params, params.cheb)
    kernel = functools.partial(hc.ucgld_cluster, occupied=cl.occupied)
    res = hold(label, "K8 full", kernel, hc.ucgld_cluster_reference, args,
               kw, kernel_reps, twin_reps)
    empty = torch.ones(cl.n_clusters, dtype=torch.bool, device=state.device)
    empty[cl.occupied.long()] = False
    out, part = kernel(*args, **kw)
    nonzero = sum(int(r.reshape(cl.n_clusters, -1)[empty].ne(0).sum())
                  for r in (out, part))
    log(f"[{label}] K8 covers {cl.occupied.shape[0]} of {cl.n_clusters} "
        f"i-clusters; nonzero entries in the rows of the others: {nonzero}")
    if nonzero:
        raise RuntimeError(f"{label} K8 left {nonzero} nonzero entries in "
                           f"the rows of i-clusters without atoms")
    if with_bound:
        res.update(bound_cluster(args, kw))
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
        res[name] = hold(label, f"K2 {name}", hb.bethe_pair,
                         hb.bethe_pair_reference, args, kw, kernel_reps,
                         twin_reps)
        if with_bound:
            res[name].update(bound("bethe", args, kw))
    return res


@contextlib.contextmanager
def recording(module, name: str, store: dict):
    """Swap the kernel wrapper ``module.name`` for one that records the
    arguments of its last call in ``store[name]`` (the launch count stays
    the wrapper's), so a path's own kernel inputs can be replayed."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        store[name] = (args, kw)
        return fn(*args, **kw)

    rec.launches = fn.launches
    setattr(module, name, rec)
    try:
        yield store
    finally:
        setattr(module, name, fn)


def path_inputs(sim):
    """The kernel inputs of one full evaluation of a density path on
    ``sim``'s current state: {wrapper name: (args, kwargs)}."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    state, cl = column_state(sim)
    store = {}
    pair_mod, pair_name = ((hd, "dbethe_pair") if sim.pair_compute
                           is hd.compute_style_density
                           else (hr, "rleucg_pair"))
    with recording(hcv, "cv_rho", store), \
            recording(hcv, "cv_force", store), \
            recording(pair_mod, pair_name, store):
        sim.pair_compute(state, cl, sim.pair_params)
    return store


def compare_density(sim, label: str, kernel_reps: int, twin_reps: int,
                    with_bound: bool = False) -> dict:
    """K5, the path's pair kernel (K3 or K4) and K6 against their twins on
    the inputs the path gives them, in every variant."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    inp = path_inputs(sim)
    res = {}

    def one(key, name, kernel, twin, args, kw, exact=(), kind=None,
            on_path=True):
        res[key] = hold(label, name, kernel, twin, args, kw, kernel_reps,
                        twin_reps, exact)
        if with_bound and on_path:
            res[key].update(bound(kind, args, kw))

    args, kw = inp["cv_rho"]
    one("cv_rho", "K5 rho", hcv.cv_rho, hcv.cv_rho_reference, args, kw,
        exact=(1,), kind="cv_rho")
    args, kw = inp["cv_force"]
    on_path = kw["gform"]
    for g in hcv.GFORMS:
        for observe in (True, False):
            v = "full" if observe else "fast"
            key = f"cv_force[{v}]" + ("" if g == on_path else f"/{g}")
            one(key, f"K6 {v} {g}", hcv.cv_force, hcv.cv_force_reference,
                args, dict(kw, gform=g, observe=observe), kind="cv_force",
                on_path=g == on_path)
    if "dbethe_pair" in inp:
        args, kw = inp["dbethe_pair"]
        for mf in (kw["mf"], not kw["mf"]):       # the path's method first
            for observe, scores in ((True, True), (False, True),
                                    (False, False)):
                v = hd.variant(observe, scores)
                key = f"dbethe_pair[{v}]" + ("" if mf == kw["mf"] else
                                             f"/mf={mf}")
                one(key, f"K3 {v} mf {mf}", hd.dbethe_pair,
                    hd.dbethe_pair_reference, args,
                    dict(kw, observe=observe, want_scores=scores, mf=mf),
                    kind="dbethe", on_path=mf == kw["mf"])
    else:
        args, kw = inp["rleucg_pair"]
        for feedback in (True, False):
            for observe in (True, False):
                v = hr.variant(observe)
                key = f"rleucg_pair[{v}]" + ("" if feedback else "/never")
                one(key, f"K4 {v} feedback {feedback}", hr.rleucg_pair,
                    hr.rleucg_pair_reference, args,
                    dict(kw, observe=observe, feedback=feedback),
                    kind="rleucg")
    return res


# ---- the kernel paths against the float64 reference paths ------------------

def check_k1_oracle(device: str, what: str, build, entry,
                    n: int = 4096) -> None:
    """One force evaluation of a flagship kernel path (``build``, a
    ``flagship`` builder whose pair entry must be ``entry``: K1's or K8's)
    in f32 on the card against the float64 reference pair path on the CPU,
    same system: agreement to the Chebyshev fit gate (the fit's max
    relative error is < 1e-4)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship

    ker = build(n=n, device=device)
    if ker.pair_compute is not entry:
        raise RuntimeError(f"{what} path was not selected for the oracle "
                           f"check")
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
    log(f"[{what} oracle n={n}] kernel path (f32) vs reference path (f64): "
        f"f rel {f_err:.3e}, pe rel {pe_err:.3e}, ucgforce abs {lam_err:.3e}")
    if f_err > 3e-5 or pe_err > 1e-5 or lam_err > 1e-4:
        raise RuntimeError(f"{what} path disagrees with the reference path")


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


def check_density_oracle(device: str, style: str, n: int = 4096) -> None:
    """The P3 (K5 → K3 → K6) or P4 (K5 → K4 → K6) path on the card against
    the port's reference pair path in float32 on the same inputs, at the
    JAX package's kernel-vs-XLA gates (tests/test_pallas_pair.py:317-327,
    :384-392): f 1e-4 of max|f|, pe 3e-5 relative, virial rtol 1e-4 (+ 1e-2
    absolute), oob exact; P3 also scores and ucgp 5e-5 absolute.  The gap to
    the float64 reference path is printed, not gated: P3's prior force has
    an intrinsic f32 envelope (PARITY.md 3b)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    build, fn = ((flagship.build_density_sim, hd.compute_style_density)
                 if style == "P3" else
                 (flagship.build_rleucg_sim, hr.compute_style_rleucg))
    ker = build(n=n, device=device)
    if ker.pair_compute is not fn:
        raise RuntimeError(f"{style}: kernel path was not selected")
    ref32 = build(n=n, kernel=False, device=device)
    ref64 = build(n=n, dtype=torch.float64, kernel=False, device=device)
    outs = []
    for s in (ker, ref32, ref64):
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
        outs.append(s.setup((0, 10)))
    fk = outs[0]
    fields = ("f", "scores", "ucgp") if style == "P3" else ("f",)
    gates = {"f": 1e-4, "scores": 5e-5, "ucgp": 5e-5}
    for fr, what in ((outs[1], "f32"), (outs[2], "f64")):
        errs = {}
        for name in fields:
            a, b = getattr(fk, name).double(), getattr(fr, name).double()
            err = float((a - b).abs().max())
            errs[name] = err / float(b.abs().max()) if name == "f" else err
        errs["pe"] = abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe))
        vk, vr = fk.virial.double(), fr.virial.double()
        errs["virial"] = float((vk - vr).abs().max() / vr.abs().max())
        v_ok = bool(((vk - vr).abs() <= 1e-4 * vr.abs() + 1e-2).all())
        oob = (int(fk.oob_low), int(fr.oob_low))
        log(f"[{style} oracle n={n}] kernel path vs {what} reference path: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f", oob {oob}" + ("" if what == "f32" else " (not gated)"))
        if what == "f32":
            bad = [k for k in fields if errs[k] > gates[k]]
            if errs["pe"] > 3e-5 or not v_ok:
                bad.append("pe/virial")
            if bad or oob[0] != oob[1]:
                raise RuntimeError(f"{style} path disagrees with the f32 "
                                   f"reference path: {bad}, oob {oob}")


def run_density_main(device: str, style: str, card_name: str,
                     blocks: int = 10, n: int = 2**20):
    """One density main path at ``n``: setup, one warm block, ``blocks``
    timed blocks, every launch count set to 0 just before and read just
    after.  Returns ({wrapper: launches}, steps/s)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    if style == "P3":
        sim = flagship.build_density_sim(n=n, device=device)
        fn, pair, fast = hd.compute_style_density, hd.dbethe_pair, \
            "fast_noscores"
    else:
        sim = flagship.build_rleucg_sim(n=n, device=device)
        fn, pair, fast = hr.compute_style_rleucg, hr.rleucg_pair, "fast"
    if sim.pair_compute is not fn:
        raise RuntimeError(f"select_pair_kernel did not choose the {style} "
                           f"kernel path at {n}")
    if not sim._slot_ok:
        raise RuntimeError(f"{style}: the slot-major interior is off")
    nre = sim.cfg.reneigh_every
    window = (0, (blocks + 1) * nre)
    counters = {"cv_rho": hcv.cv_rho, "cv_force": hcv.cv_force,
                pair.__name__: pair}
    for c in counters.values():
        for k in c.launches:
            c.launches[k] = 0
    sim.setup(window)
    sim.run_fused(1, run_window=window)            # warm block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_fused(blocks, run_window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: dict(c.launches) for name, c in counters.items()}
    row = sim.thermo()
    steps_s = blocks * nre / wall
    missed_pairs(sim, f"{style} n={n}")
    msg = (f"[{style} main n={n}] {blocks * nre} steps in {wall:.3f} s = "
           f"{steps_s:.2f} steps/s ({steps_s * n / 1e6:.2f} M "
           f"atom-steps/s) on {card_name}; temp {row['temp']:.6f} etotal "
           f"{row['etotal']:.6f} oob_low {row['oob_low']}; dangerous builds "
           f"{sim.dangerous_builds}; launches {launches}")
    nblk = blocks + 1
    if (launches["cv_rho"]["rho"] < nre * nblk
            or launches["cv_force"]["full"] < nblk
            or launches["cv_force"]["fast"] < (nre - 1) * nblk
            or launches[pair.__name__]["full"] < nblk
            or launches[pair.__name__][fast] < (nre - 1) * nblk):
        raise RuntimeError(f"{style} path did not run through its kernels: "
                           f"{launches}")
    if not finite_row(row):
        raise RuntimeError(f"non-finite thermo: {row}")
    if row["oob_low"] != 0:
        raise RuntimeError(f"pairs below the table inner cutoff: {row}")
    if style == "P3":
        p, ucg = sim.state.ucgp, sim.state.typ == 2
        p_lo, p_hi = float(p[ucg].min()), float(p[ucg].max())
        msg += (f"; ucgp of the UCG type in [{p_lo:.6f}, {p_hi:.6f}], of "
                f"the plain type {float(p[~ucg].min())}")
        if not (p_lo >= 1e-6 and p_hi <= 1 - 1e-6
                and bool((p[~ucg] == 1.0).all())):
            raise RuntimeError(f"ucgp outside [1e-6, 1-1e-6]: {p_lo}, {p_hi}")
    log(msg)
    atom_order_reading(sim, f"{style} main n={n}", blocks, window, card_name)
    return launches, steps_s


def run_cluster_main(device: str, card_name: str, blocks: int = 5,
                     n: int = 2**20):
    """The K8 cluster-list path at ``n``: setup, one warm block, ``blocks``
    timed blocks, K8's launch count set to 0 just before and read just
    after.  Returns (launches, steps/s)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    sim = flagship.build_cluster_sim(n=n, device=device)
    spec, nre = sim.nbr_spec, sim.cfg.reneigh_every
    window = (0, (blocks + 1) * nre)
    for k in hc.ucgld_cluster.launches:
        hc.ucgld_cluster.launches[k] = 0
    t0 = time.perf_counter()
    sim.setup(window)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sim.run_fused(1, run_window=window)            # warm block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_fused(blocks, run_window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hc.ucgld_cluster.launches)
    row = sim.thermo()
    steps_s = blocks * nre / wall
    nbr = sim._nbr
    log(f"[cluster main n={n}] cells {spec.cells_per_side} capacity "
        f"{spec.cell_capacity} kc {spec.kc}, {nbr.n_clusters} i-clusters, "
        f"most j-clusters kept {int(nbr.max_occupancy)}; setup "
        f"{t_setup:.3f} s; {blocks * nre} steps in {wall:.3f} s = "
        f"{steps_s:.2f} steps/s ({steps_s * n / 1e6:.2f} M atom-steps/s) on "
        f"{card_name}; temp {row['temp']:.6f} etotal {row['etotal']:.6f} oob_low "
        f"{row['oob_low']}; dangerous builds {sim.dangerous_builds}; K8 "
        f"launches {launches}")
    if launches["full"] < (blocks + 1) * nre:
        raise RuntimeError(f"cluster path did not run through K8 on every "
                           f"step: {launches}")
    if bool(nbr.overflow):
        raise RuntimeError("cluster list overflow")
    if not finite_row(row):
        raise RuntimeError(f"non-finite thermo: {row}")
    if row["oob_low"] != 0:
        raise RuntimeError(f"pairs below the table inner cutoff: {row}")
    missed_cluster_pairs(sim, f"cluster n={n}")
    return launches, steps_s


def atom_order_reading(sim, label: str, blocks: int, window,
                       card_name: str) -> float:
    """steps/s of ``sim`` over ``blocks`` timed blocks after a warm one with
    the atom-ordered interior (``_slot_ok`` false), printed beside the
    slot-major main path's, not gated; ``_slot_ok`` is restored after."""
    import torch

    slot_ok, sim._slot_ok = sim._slot_ok, False
    try:
        sim.run_fused(1, run_window=window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_fused(blocks, run_window=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sim._slot_ok = slot_ok
    steps_s = blocks * sim.cfg.reneigh_every / wall
    log(f"[{label} atom-ordered interior] {blocks * sim.cfg.reneigh_every} "
        f"steps in {wall:.3f} s = {steps_s:.2f} steps/s on {card_name} "
        f"(not gated)")
    return steps_s


def launch_counters():
    """{name: wrapper} of every kernel wrapper a column path launches."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    return {"ucgld_pair": hp.ucgld_pair, "bethe_pair": hb.bethe_pair,
            "dbethe_pair": hd.dbethe_pair, "rleucg_pair": hr.rleucg_pair,
            "cv_rho": hcv.cv_rho, "cv_force": hcv.cv_force}


def slot_vs_atom(device: str, label: str, build, mode: str | None,
                 k1_interior: str | None = None, n: int = 32768) -> None:
    """Phase 15 for one column style: two blocks through ``Simulation``,
    slot-major (``_slot_ok`` must be true) and atom-ordered (``_slot_ok``
    set false), from the same built state and the same generator seed:
    identical bits in every dynamic field and in f, the λ-force and pe,
    and the same launches of every kernel.  ``k1_interior``: the K1
    variant the interior steps must launch ("noscores" under ``ucgstate
    ld``, "fast" under ``default``), and the other interior variant none.
    Raises on a difference."""
    import torch

    from lammps_ucg_dev_tpu_torch.fixes import ucgstate as fs

    fields = ("x", "v", "ucgl", "ucgvl", "ucgp", "ucgstate")
    counters = launch_counters()
    got = {}
    for slot in (True, False):
        sim = build(n=n, device=device)
        if mode is not None:
            sim.cfg = dataclasses.replace(sim.cfg,
                                          ucgstate=fs.UCGStateCfg(mode=mode))
        if not sim._slot_ok:
            raise RuntimeError(f"{label}: the driver did not choose the "
                               f"slot-major interior")
        sim._slot_ok = slot
        window = (0, 2 * sim.cfg.reneigh_every)
        sim.setup(window)
        for c in counters.values():
            for k in c.launches:
                c.launches[k] = 0
        t0 = time.perf_counter()
        sim.run_fused(2, run_window=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: {k: v for k, v in c.launches.items() if v}
                    for name, c in counters.items()}
        launches = {k: v for k, v in launches.items() if v}
        st, fo = sim.state, sim._fcarry
        got[slot] = ({f: getattr(st, f) for f in fields}
                     | {"f": fo.f, "ucgforce": fo.ucgforce, "pe": fo.pe},
                     launches, wall)
    (a, la, wa), (b, lb, wb) = got[True], got[False]
    diff = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}
    log(f"[slot vs atom order, {label} n={n}] 2 blocks: slot-major "
        f"{wa:.3f} s, atom-ordered {wb:.3f} s; fields that differ "
        f"{json.dumps(diff)}; launches {json.dumps(la)}")
    if diff:
        raise RuntimeError(f"{label}: the slot-major interior differs from "
                           f"the atom-ordered one: {diff}")
    if la != lb or not la:
        raise RuntimeError(f"{label}: launches differ: slot-major {la}, "
                           f"atom-ordered {lb}")
    if k1_interior is not None:
        k1 = la.get("ucgld_pair", {})
        other = "fast" if k1_interior == "noscores" else "noscores"
        if not k1.get(k1_interior) or k1.get(other):
            raise RuntimeError(f"{label}: the interior launched K1 {k1}, "
                               f"not the {k1_interior} variant alone")


# ---- the topology slice: exclusions, molecules, RESPA, cluster_switch ------

@contextlib.contextmanager
def event_timed(owner, name: str, spans: list):
    """Swap ``owner.name`` for a wrapper that brackets each call with two
    CUDA events on the current stream and appends the pair to ``spans``
    (no synchronization; read with :func:`span_ms` after one)."""
    import torch

    fn = getattr(owner, name)

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn(*a, **k)
        end.record()
        spans.append((start, end))
        return r

    setattr(owner, name, timed)
    try:
        yield spans
    finally:
        setattr(owner, name, fn)


def span_ms(spans) -> float:
    return sum(a.elapsed_time(b) for a, b in spans)


def check_excl_oracle(device: str, style: str, nmol: int = 1365) -> dict:
    """Phase 16 for one style: the molecular trimers
    (``build_molecular_sim``, 3·nmol beads) on the kernel path with
    ``excl_delta`` subtracted (K1, or K2 with ``style="bethe"``) in f32
    against the float64 reference path whose nsq list leaves the specials
    out, both on the card, bonded terms and thermostat off (the pair path
    alone), at K1's oracle gate (f 3e-5 of max|f|, pe 1e-5, λ-force 1e-4)
    or K2's (f 5e-5, pe 3e-5, scores 3e-5).  Then the cancellation itself:
    K(all pairs) - excl_delta against K's functional summed over an nsq
    list built without the specials (``excl_delta`` over that list), on
    every atom with a special partner; the largest residual force is
    printed and must stay within TOL of max|f| (f32 rounding)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod

    entry = hp.compute_style if style == "ucgld" else hb.compute_style_bethe
    ker = flagship.build_molecular_sim(nmol=nmol, device=device, style=style)
    if ker.pair_compute is not entry or ker._excl_rows_static is None:
        raise RuntimeError(f"{style}: the kernel path with exclusions was "
                           f"not selected")
    ref = flagship.build_molecular_sim(nmol=nmol, dtype=torch.float64,
                                       kernel=False, style=style,
                                       method="nsq", device=device)
    for s in (ker, ref):
        s.cfg = dataclasses.replace(s.cfg, langevin=None)
        s.bonded = None
    fk, fr = ker.setup((0, 10)), ref.setup((0, 10))
    scale = float(fr.f.abs().max())
    errs = {"f": float((fk.f.double() - fr.f).abs().max()) / scale,
            "pe": abs(float(fk.pe) - float(fr.pe)) / abs(float(fr.pe)),
            "ucgforce": float((fk.ucgforce.double()
                               - fr.ucgforce).abs().max()),
            "scores": float((fk.scores.double() - fr.scores).abs().max())}
    gates = ({"f": 3e-5, "pe": 1e-5, "ucgforce": 1e-4} if style == "ucgld"
             else {"f": 5e-5, "pe": 3e-5, "scores": 3e-5})
    n = ker.state.n_atoms
    log(f"[{style} excl oracle n={n}] kernel path - excl_delta (f32) vs "
        f"reference path with the specials excluded (f64): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; gates {gates}")
    if any(errs[k] > g for k, g in gates.items()):
        raise RuntimeError(f"{style}: the exclusion path disagrees with "
                           f"the reference path: {errs}")

    state, cl = column_state(ker)
    params, rows = ker.pair_params, ker._excl_rows_static
    if style == "ucgld":
        out, delta = hp.compute(state, cl, params, params.cheb), hp.excl_delta
    else:
        out = hb.compute_bethe(state, cl, params, params.cheb)
        delta = hb.excl_delta_bethe
    spec = nbrmod.make_spec(n, state.box.lengths.cpu().numpy(),
                            flagship.RC, 0.0, method="nsq")
    kept = nbrmod.build(state.x, state.box, spec, excl=rows)
    if bool(kept.overflow):
        raise RuntimeError("the excluded nsq list overflowed")
    rest = delta(state, kept.idx, params)
    res = (out.f - delta(state, rows, params).f - rest.f).double()
    has = (rows < n).any(1)
    worst = float(res[has].abs().max())
    fscale = float(rest.f.abs().max())
    bond_f = float(delta(state, rows, params).f.abs().max())
    log(f"[{style} excl residual n={n}] K(all) - excl_delta vs "
        f"K's functional over the list without the specials: largest "
        f"residual force on an atom with a special partner {worst:.3e} "
        f"({worst / fscale:.3e} of max|f| {fscale:.3e}; the excluded "
        f"pairs' largest force {bond_f:.3e}) over {int(has.sum())} atoms")
    if worst > TOL * fscale:
        raise RuntimeError(f"{style}: excluded pairs do not cancel: "
                           f"{worst:.3e}")
    return errs


def run_molecular_main(device: str, card_name: str, blocks: int = 20,
                       nmol: int = 349525):
    """Phase 17: the molecular UCG-LD deck at 3·nmol beads on the kernel
    path (K1 with ``excl_delta`` subtracted, bonded terms added): setup,
    one warm block, ``blocks`` timed blocks of 5 steps, K1's launch counts
    set to 0 just before and read just after; then K1 against its twin on
    the state the run reached, in the two variants the path launches
    (full and without scores; ``hold``'s per-column gate and two launches
    with the same bits); then one more block with ``bonded.compute`` and
    ``excl_delta`` bracketed by CUDA events for their ms per step; D1
    last.  Returns (K1 launches, steps/s, K1 against its twin)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.models import bonded
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    t0 = time.perf_counter()
    sim = flagship.build_molecular_sim(nmol=nmol, device=device)
    t_build = time.perf_counter() - t0
    n = sim.state.n_atoms
    if sim.pair_compute is not hp.compute_style or sim._slot_ok:
        raise RuntimeError("molecular: K1's atom-ordered path with "
                           "exclusions was not selected")
    nre = sim.cfg.reneigh_every
    window = (0, (blocks + 2) * nre)
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
    k1 = compare_k1(sim, f"molecular n={n}", kernel_reps=20, twin_reps=1,
                    with_bound=True, variants=("full", "noscores"))
    b_spans, e_spans = [], []
    with event_timed(bonded, "compute", b_spans), \
            event_timed(hp.compute_style, "excl_delta", e_spans):
        sim.run_fused(1, run_window=window)
    torch.cuda.synchronize()
    log(f"[molecular main n={n}] {sim.bonded.n_bonds} bonds, "
        f"{sim.bonded.n_angles} angles, specials (N, "
        f"{sim.excl_tags.shape[1]}); built in {t_build:.1f} s; "
        f"{blocks * nre} steps in {wall:.3f} s = {steps_s:.2f} steps/s "
        f"({steps_s * n / 1e6:.2f} M atom-steps/s) on {card_name}; temp "
        f"{row['temp']:.6f} etotal {row['etotal']:.6f} oob_low "
        f"{row['oob_low']}; dangerous builds {sim.dangerous_builds}; K1 "
        f"launches {launches}; CUDA-event spans per step: bonded.compute "
        f"{span_ms(b_spans) / nre:.3f} ms ({len(b_spans)} calls), "
        f"excl_delta {span_ms(e_spans) / nre:.3f} ms ({len(e_spans)} calls)")
    nblk = blocks + 1
    if launches["full"] < nblk or launches["noscores"] < (nre - 1) * nblk:
        raise RuntimeError(f"molecular path did not run through K1: "
                           f"{launches}")
    if not finite_row(row) or row["oob_low"] != 0:
        raise RuntimeError(f"molecular thermo: {row}")
    missed_pairs(sim, f"molecular n={n}")
    return launches, steps_s, k1


def topology_drift(device: str, nmol: int = 10923) -> dict:
    """Phase 18: NVE drift with topology on the kernel path, 3·nmol beads,
    Langevin off (``build_respa_sim``): Verlet with bonds 50/0.9 and
    angles at dt 0.001 over 10 + 190 steps (the JAX package's
    ``tests/test_bonded.py:139``), gated at 1e-4; r-RESPA with bond K 400,
    4 inner steps, dt 0.004 over 5 + 195 steps (``:234-242``), gated at
    2e-4 and at one fifth of plain Verlet's drift on the same system and
    dt."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    def drift(sim, warm: int, steps: int = 200) -> float:
        if sim.pair_compute is not hp.compute_style:
            raise RuntimeError("drift leg: K1 was not selected")
        tp, nre = sim.pair_params.tp, sim.cfg.reneigh_every

        def hamiltonian():
            mu = torch.where(tp.n_states[sim.state.typ] > 1,
                             sim.state.ucgl * tp.mu_diff[sim.state.typ], 0.0)
            return sim.thermo()["etotal"] + float(mu.sum())

        window = (0, steps)
        sim.setup(window)
        sim.run_fused(warm // nre, run_window=window)
        e0 = hamiltonian()
        sim.run_fused((steps - warm) // nre, run_window=window)
        return abs(hamiltonian() - e0) / abs(e0)

    d = {"verlet_k50_dt0.001": drift(flagship.build_respa_sim(
             nmol=nmol, device=device, respa_inner=1, dt=0.001,
             bond_k=50.0), 10),
         "respa4_k400_dt0.004": drift(flagship.build_respa_sim(
             nmol=nmol, device=device, respa_inner=4, dt=0.004,
             bond_k=400.0), 5),
         "verlet_k400_dt0.004": drift(flagship.build_respa_sim(
             nmol=nmol, device=device, respa_inner=1, dt=0.004,
             bond_k=400.0), 5)}
    log(f"[topology drift n={3 * nmol}] " + ", ".join(
        f"{k} {v:.6e}" for k, v in d.items())
        + " (gates: Verlet < 1e-4; RESPA < 2e-4 and < Verlet k400 / 5)")
    if not d["verlet_k50_dt0.001"] < DRIFT_MAX:
        raise RuntimeError(f"Verlet drift with topology {d}")
    if not (d["respa4_k400_dt0.004"] < 2e-4 and d["respa4_k400_dt0.004"]
            < d["verlet_k400_dt0.004"] / 5):
        raise RuntimeError(f"r-RESPA drift {d}")
    return d


def run_density_switch(device: str, card_name: str, n: int = 2**20,
                       events: int = 5):
    """Phase 19: config 4 with its ``fix cluster_switch`` at ``n`` through
    ``Simulation.run`` (events every 20 steps at the start of a block,
    reneighbour every 10): setup and 20 warm steps, then ``events`` × 20
    timed steps, each starting with an event; every launch count set to 0
    just before and read just after.  Prints steps/s with the events, each
    event's ms (host clock, synchronized), the sweeps it took, the 7-stat
    vector and the launches; then K5, K3 and K6 against their twins on
    the state the run reached; D1 last.  Returns (launches, steps/s, the
    kernels against their twins)."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd

    sim = flagship.build_density_sim(n=n, device=device, cluster_switch=True)
    if (sim.pair_compute is not hd.compute_style_density
            or sim._cs_spec is None):
        raise RuntimeError("config 4 + cluster_switch: the kernel path with "
                           "its own contact list was not selected")
    params_cs, freq = sim.cswitch
    per_event = []
    event = sim._cswitch_event

    def timed_event(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = event(*a, **k)
        torch.cuda.synchronize()
        per_event.append((1e3 * (time.perf_counter() - t0),
                          r[2]["sweeps"], int(r[2]["n_cluster"])))
        return r

    sim._cswitch_event = timed_event
    sim.run(freq)                                  # setup + warm steps
    counters = {"cv_rho": hcv.cv_rho, "cv_force": hcv.cv_force,
                "dbethe_pair": hd.dbethe_pair}
    for c in counters.values():
        for k in c.launches:
            c.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(events * freq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: dict(c.launches) for name, c in counters.items()}
    row = sim.thermo()
    steps_s = events * freq / wall
    stats = sim.cswitch_stats.v.tolist()
    log(f"[P3 + cluster_switch n={n}] max_sweeps {params_cs.max_sweeps}; "
        f"{events * freq} steps with {len(per_event)} events in {wall:.3f} "
        f"s = {steps_s:.2f} steps/s ({steps_s * n / 1e6:.2f} M "
        f"atom-steps/s) on {card_name}; events (ms, sweeps, cluster size) "
        f"{[(round(a, 3), b, c) for a, b, c in per_event]}; 7-stat "
        f"{stats}; temp {row['temp']:.6f} etotal {row['etotal']:.6f}; "
        f"dangerous builds {sim.dangerous_builds}; launches {launches}")
    if len(per_event) != events or stats[0] <= 0:
        raise RuntimeError(f"cluster_switch events: {per_event}, {stats}")
    if (launches["cv_rho"]["rho"] < events * freq
            or launches["dbethe_pair"]["full"] < events * freq
            // sim.cfg.reneigh_every):
        raise RuntimeError(f"config 4 did not run through its kernels: "
                           f"{launches}")
    if not finite_row(row) or row["oob_low"] != 0:
        raise RuntimeError(f"config 4 thermo: {row}")
    dens = compare_density(sim, f"P3 + cluster_switch n={n}", 20, 1,
                           with_bound=True)
    missed_pairs(sim, f"P3 + cluster_switch n={n}")
    return launches, steps_s, dens


def check_tetramers(device: str, nmol: int = 8192) -> dict:
    """Phase 20: the tetramer deck (``build_tetramer_sim``, 4·nmol beads)
    on the card.  ``bonded.compute`` in f32 against f64 on the same
    (f32-rounded) positions, with bonds, angles, dihedrals and impropers:
    pe within 1e-5 relative, the virial within 1e-4 of its largest
    component, and f within 1e-4 of max|f| on every atom outside a
    near-planar improper (sin χ < 0.1).  There arccos is ill-conditioned
    in f32: c = cos χ carries ~6e-8 of rounding, so sin χ = √(1 - c²)
    carries ~6e-8/sin²χ relatively per rounding of c, ~6% at the 1e-3
    guard and ~24% for four roundings; those atoms are held to 25% of
    their own force (plus 1e-4 of max|f|): the JAX package's arithmetic
    has the same conditioning.  Then one block of its kernel
    path (K1 with the 1-2/1-3/1-4 specials subtracted): finite thermo."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.models import bonded
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    sim = flagship.build_tetramer_sim(nmol=nmol, device=device)
    if sim.pair_compute is not hp.compute_style:
        raise RuntimeError("tetramers: K1 was not selected")
    st, bp = sim.state, sim.bonded
    box64 = dataclasses.replace(st.box, lo=st.box.lo.double(),
                                hi=st.box.hi.double())
    st64 = dataclasses.replace(st, x=st.x.double(), box=box64)
    bp64 = dataclasses.replace(bp, **{
        f.name: getattr(bp, f.name).double() for f in dataclasses.fields(bp)
        if getattr(bp, f.name).is_floating_point()})
    (f32, pe32, v32), (f64, pe64, v64) = (bonded.compute(st, bp),
                                          bonded.compute(st64, bp64))
    # sin χ of each improper (f64), and the atoms of the near-planar ones
    rows = bp.improper_tags - 1                     # tag - 1 == row here
    xb = [box64.min_image(st64.x[rows[:, k + 1]] - st64.x[rows[:, k]])
          for k in range(3)]
    sin_chi = torch.sqrt(1.0 - bonded._cos_torsion(*xb) ** 2)
    planar = torch.zeros(st.n_atoms, dtype=torch.bool, device=st.device)
    planar[rows[sin_chi < 0.1].reshape(-1)] = True
    df = (f32.double() - f64).abs().max(1).values
    fmax = float(f64.abs().max())
    fmag = f64.abs().max(1).values
    errs = {"f": float(df[~planar].max()) / fmax,
            "f_planar": float((df[planar] / (fmag[planar] + 1e-4 * fmax))
                              .max()) if bool(planar.any()) else 0.0,
            "pe": abs(float(pe32) - float(pe64)) / abs(float(pe64)),
            "virial": float((v32.double() - v64).abs().max()
                            / v64.abs().max())}
    ms32 = cuda_ms(lambda: bonded.compute(st, bp), 10)
    ms64 = cuda_ms(lambda: bonded.compute(st64, bp64), 10)
    log(f"[tetramer bonded n={st.n_atoms}] {bp.n_bonds} bonds, "
        f"{bp.n_angles} angles, {bp.n_dihedrals} dihedrals, "
        f"{bp.n_impropers} impropers ({int((sin_chi < 0.1).sum())} with sin "
        f"χ < 0.1, smallest {float(sin_chi.min()):.3e}; {int(planar.sum())} "
        f"atoms): f32 vs f64 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (gates f 1e-4, f_planar 0.25, pe 1e-5, virial 1e-4); "
        f"bonded.compute {ms32:.3f} ms f32, {ms64:.3f} ms f64")
    if (errs["f"] > 1e-4 or errs["f_planar"] > 0.25 or errs["pe"] > 1e-5
            or errs["virial"] > 1e-4):
        raise RuntimeError(f"tetramer bonded terms: {errs}")
    window = (0, sim.cfg.reneigh_every)
    sim.setup(window)
    sim.run_fused(1, run_window=window)
    row = sim.thermo()
    log(f"[tetramer block n={st.n_atoms}] specials (N, "
        f"{sim.excl_tags.shape[1]}); {json.dumps(row)}")
    if not finite_row(row) or row["oob_low"] != 0:
        raise RuntimeError(f"tetramer thermo: {row}")
    return errs


# ---- the deck entry point: ScriptRunner on the card --------------------------

DECK_DIR = Path(__file__).resolve().parent / "_decks"   # gitignored scratch
SKILL_ETOTAL0 = 5520.27     # the JAX package's deck fingerprint (SKILL.md)


def deck_lines(text: str) -> list:
    return [s.strip() for s in text.splitlines() if s.split("#")[0].strip()]


def deck_runner(workdir, logs: list, device: str = "cuda", dtype=None):
    import torch

    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner

    return ScriptRunner(workdir=str(workdir), device=device,
                        dtype=dtype or torch.float32,
                        log_callback=logs.append)


def zero_launches(counters: dict) -> None:
    for c in counters.values():
        for k in c.launches:
            c.launches[k] = 0


def read_launches(counters: dict) -> dict:
    out = {name: {k: v for k, v in c.launches.items() if v}
           for name, c in counters.items()}
    return {k: v for k, v in out.items() if v}


def synced(fn):
    """(result, seconds) of ``fn()`` between two CUDA synchronizes
    (``utils.profiling.Throughput``)."""
    from lammps_ucg_dev_tpu_torch.utils.profiling import Throughput

    with Throughput(0) as t:
        out = fn()
    return out, t.elapsed


@contextlib.contextmanager
def stepping_time(n_atoms: int):
    """A ``utils.profiling.Throughput`` that counts the steps and the
    synchronized seconds of every ``Simulation.run`` while the block runs:
    the stepping of a deck's ``run`` without its setup, thermo rows and
    dump frames."""
    from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation
    from lammps_ucg_dev_tpu_torch.utils.profiling import Throughput

    orig, tp = Simulation.run, Throughput(n_atoms)

    def run(self, nsteps, *a, **kw):
        with tp:
            out = orig(self, nsteps, *a, **kw)
        tp.add_steps(nsteps)
        return out

    Simulation.run = run
    try:
        yield tp
    finally:
        Simulation.run = orig


def check_rows(label: str, rows: list, oob: bool = True) -> None:
    if not rows or not all(finite_row(r) for r in rows):
        raise RuntimeError(f"{label}: non-finite or missing thermo rows: "
                           f"{rows}")
    if oob and any(r.get("oob_low", 0) or r.get("oob_high", 0)
                   for r in rows):
        raise RuntimeError(f"{label}: pairs outside the tables: {rows}")


def run_deck_flagship(card_name: str, builder_steps_s: float,
                      n: int = 2**20, nsteps: int = 200):
    """Phase 21: ``write_ucgld_deck`` at 2^20 beads at its published
    settings (nsteps and thermo cut to 200 and 100), with a dump every 100
    steps, ``write_data`` and ``write_restart``, run through
    ``ScriptRunner`` on the card line by line; then a ``rerun`` of the
    dump.  Returns (K1 launches of the run, K1 against its twin on the
    state the run reached, the stepping's steps/s)."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.runtime import native
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    d = DECK_DIR / "flagship"
    t0 = time.perf_counter()
    path = make_deck.write_ucgld_deck(str(d), n=n, nsteps=nsteps,
                                      thermo_every=100)
    t_deck = time.perf_counter() - t0
    text = open(path).read().replace(
        "thermo 100", "dump d1 all custom 100 traj.lammpstrj id type x y z "
        "ucgstate ucgl ucgp\nthermo 100")
    text += "write_data final.data\nwrite_restart final.npz\n"
    logs, frames, secs = [], [], {}
    r = deck_runner(d, logs)
    counters = launch_counters()
    for line in deck_lines(text):
        cmd = line.split()[0]
        if cmd == "run":
            zero_launches(counters)
            with stepping_time(n) as stepping:
                _, secs[cmd] = synced(lambda: r.command(line))
            launches = read_launches(counters)
            continue
        _, secs[cmd] = synced(lambda: r.command(line))
        if cmd == "dump":
            w = r.dumps["d1"].writer
            write = w.write

            def timed_write(state, step=None, write=write):
                ok, sec = synced(lambda: write(state, step))
                frames.append(sec)
                return ok

            w.write = timed_write
    w = r.dumps["d1"].writer
    sim, rows = r.sim, r.thermo_rows
    lam = r.state.ucgl
    lam_lo, lam_hi = float(lam.min()), float(lam.max())
    k1 = launches.get("ucgld_pair", {})
    steps_run = nsteps / secs["run"]
    steps_stepping = stepping.steps_per_sec
    if stepping.steps != nsteps:
        raise RuntimeError(f"the deck's run took {stepping.steps} steps")
    log(f"[deck flagship n={n}] {r.pair_path}; slot-major {sim._slot_ok}; "
        f"launches {json.dumps(launches)}; native writer "
        f"{native.get_lib() is not None} ({w.native_frames} of {w.frames} "
        f"frames); λ in [{lam_lo:.6f}, {lam_hi:.6f}]")
    for row in rows:
        log(f"[deck flagship n={n}] {json.dumps(row)}")
    log(f"[deck flagship n={n}] run {nsteps} steps: {secs['run']:.3f} s "
        f"with setup, thermo and dumps = {steps_run:.2f} steps/s; stepping "
        f"{stepping.elapsed:.3f} s = {steps_stepping:.2f} steps/s "
        f"({stepping.atom_steps_per_sec / 1e6:.2f} M atom-steps/s); builder "
        f"path (phase 4) {builder_steps_s:.2f} steps/s; on {card_name} "
        f"(not gated)")
    log(f"[deck flagship n={n}] I/O ms: read_data "
        f"{secs['read_data'] * 1e3:.1f}, dump frame "
        f"{1e3 * sum(frames) / max(len(frames), 1):.1f} (mean of "
        f"{len(frames)}: {', '.join(f'{1e3 * f:.1f}' for f in frames)}), "
        f"write_restart {secs['write_restart'] * 1e3:.1f}, write_data "
        f"{secs['write_data'] * 1e3:.1f}; deck written in {t_deck:.1f} s")
    if sim.pair_compute is not hp.compute_style or "K1" not in r.pair_path:
        raise RuntimeError(f"the flagship deck did not take K1: "
                           f"{r.pair_path}")
    if f"pair path: {r.pair_path}" not in logs:
        raise RuntimeError("no pair-path log line")
    if not sim._slot_ok:
        raise RuntimeError("the flagship deck's interior is not slot-major")
    if not k1.get("full") or not k1.get("noscores") or k1.get("fast"):
        raise RuntimeError(f"the deck's run did not launch K1 full and "
                           f"without scores alone: {launches}")
    if native.get_lib() is None or w.frames != 3 or \
            w.native_frames != w.frames:
        raise RuntimeError(f"the native dump writer did not write the "
                           f"frames: {w.native_frames} of {w.frames}")
    check_rows("deck flagship", rows)
    if [row["step"] for row in rows] != [0, 100, 200]:
        raise RuntimeError(f"thermo rows at {[r['step'] for r in rows]}")
    if not (0.0 <= lam_lo and lam_hi <= 1.0):
        raise RuntimeError(f"λ outside the walls: [{lam_lo}, {lam_hi}]")
    k1_deck = compare_k1(sim, f"deck n={n}", kernel_reps=20, twin_reps=1,
                         with_bound=True, variants=("full", "noscores"))
    del r, sim

    # the rerun of the dump: the deck's styles, then rerun
    keep = ("units", "dimension", "boundary", "atom_style", "read_data",
            "pair_style", "pair_coeff", "neighbor", "neigh_modify",
            "timestep", "fix", "thermo")
    rr = deck_runner(d, logs)
    for line in deck_lines(text):
        if line.split()[0] in keep:
            rr.command(line)
    _, sec = synced(lambda: rr.command(
        "rerun traj.lammpstrj dump x y z ucgstate ucgl ucgp"))
    check_rows("deck rerun", rr.thermo_rows)
    log(f"[deck rerun n={n}] {len(rr.thermo_rows)} frames in {sec:.3f} s = "
        f"{1e3 * sec / len(rr.thermo_rows):.1f} ms a frame (read_dump, "
        f"apply_snapshot, setup, thermo); steps "
        f"{[row['step'] for row in rr.thermo_rows]}; {rr.pair_path}")
    if [row["step"] for row in rr.thermo_rows] != [0, 100, 200]:
        raise RuntimeError("the rerun did not take the three frames")
    if rr.sim.pair_compute is not hp.compute_style:
        raise RuntimeError("the rerun did not take K1")
    del rr
    shutil.rmtree(d)
    return k1, k1_deck, steps_stepping


def deck_restart_continuity(n: int = 32768) -> None:
    """Phase 22: the UCG-LD deck (Langevin on λ, ``ucgstate ld``) on the
    card: A runs 40 steps; B runs 20 and writes a restart, and a new runner
    reads it, re-declares the styles and runs 20 more.  x, v, λ,
    λ-velocity and ucgp must be the same bits: the random state and the
    force carry survive the restart."""
    import torch

    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    d = DECK_DIR / "restart"
    text = open(make_deck.write_ucgld_deck(str(d), n=n, nsteps=40,
                                           thermo_every=10)).read()
    logs = {k: [] for k in "abc"}
    a = deck_runner(d, logs["a"])
    a.run_string(text)
    b = deck_runner(d, logs["b"])
    b.run_string(text.replace("run 40", "run 20\nwrite_restart b.npz"))
    cont = [("read_restart b.npz" if s.startswith("read_data") else s)
            for s in deck_lines(text)
            if not s.startswith(("velocity", "run"))]
    c = deck_runner(d, logs["c"])
    c.run_string("\n".join(cont) + "\nrun 20\n")
    if not all(r.sim.pair_compute is hp.compute_style and r.sim._slot_ok
               for r in (a, b, c)):
        raise RuntimeError("the continuity deck did not take K1 slot-major")
    fields = ("x", "v", "ucgl", "ucgvl", "ucgp")
    diff = {f: float((getattr(a.state, f) - getattr(c.state, f)).abs().max())
            for f in fields
            if not torch.equal(getattr(a.state, f), getattr(c.state, f))}
    notes = [m for m in logs["c"] if "afresh" in m or "restart from" in m]
    log(f"[deck restart n={n}] run 40 against run 20 + write_restart + "
        f"read_restart + run 20: fields that differ {json.dumps(diff)}; "
        f"steps {a.state.step}/{c.state.step}; etotal "
        f"{a.thermo_rows[-1]['etotal']:.9g} / "
        f"{c.thermo_rows[-1]['etotal']:.9g}; {c.pair_path}")
    if diff or notes or c.state.step != 40:
        raise RuntimeError(f"the restart did not continue the run bit for "
                           f"bit: {diff} {notes}")
    shutil.rmtree(d)


# writer: (the writer's arguments of the main run, kernel entry, kernels
# the run must launch, the oracle phase's pe gate)
OTHER_DECKS = {
    "write_bethe_deck": (dict(n=32768), "compute_style_bethe",
                         {"bethe_pair": ("full", "fast")}, 3e-5),
    # config 4's deck at 4,096 to its first event; config4_deck_checks
    # runs it at 32,768 through four events
    "write_bethe_density_deck": (dict(n=4096, nsteps=30, thermo_every=10),
                                 "compute_style_density",
                                 {"cv_rho": ("rho",), "dbethe_pair": ("full",),
                                  "cv_force": ("full", "fast")}, 3e-5),
    "write_rleucg_deck": (dict(n=32768), "compute_style_rleucg",
                          {"cv_rho": ("rho",),
                           "rleucg_pair": ("full", "fast"),
                           "cv_force": ("full", "fast")}, 3e-5),
    "write_molecular_ucgld_deck": (dict(nmol=10923), "compute_style",
                                   {"ucgld_pair": ("full",)}, 1e-5),
    # two single-state types: K1's gate takes a 2-state type, so this deck
    # runs the reference path on the card, as in the JAX package
    "write_molecular_switch_deck": (dict(nmol=64), None, {}, 1e-5),
}


def other_decks(card_name: str) -> None:
    """Phase 23: the other deck writers through ``ScriptRunner`` on the
    card (their published settings, at the sizes of OTHER_DECKS): the
    kernel path taken and launched, finite thermo rows, the cluster_switch
    events run (their sweeps printed); then each deck at 4,096 beads
    (4,095 for the trimers) to step 0 on the card's path in f32 and on the
    float64 reference path on the CPU: pe and etotal within the matching
    oracle phase's pe gate, ke within 1e-6, the pressure within 1e-4
    (phase 10's virial gate), the out-of-table counts equal
    (:func:`deck_step0`)."""
    from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    counters = launch_counters()
    event = Simulation._cswitch_event
    for writer, (kw, entry, must, pe_gate) in OTHER_DECKS.items():
        name = writer[len("write_"):-len("_deck")]
        d = DECK_DIR / name
        path = getattr(make_deck, writer)(str(d), **kw)
        sweeps = []

        def counted(self, *a):
            out = event(self, *a)
            sweeps.append(int(out[2]["sweeps"]))
            return out

        r = deck_runner(d, [])
        zero_launches(counters)
        Simulation._cswitch_event = counted
        try:
            _, sec = synced(lambda: r.run_file(path))
        finally:
            Simulation._cswitch_event = event
        launches = read_launches(counters)
        sim = r.sim
        stats = (None if sim.cswitch_stats is None
                 else sim.cswitch_stats.v.tolist())
        n = r.state.n_atoms
        log(f"[deck {name} n={n}] {r.pair_path}; {r.state.step} steps in "
            f"{sec:.3f} s on {card_name}; launches {json.dumps(launches)}; "
            f"cluster_switch stats {stats}, sweeps {sweeps}; last row "
            f"{json.dumps(r.thermo_rows[-1])}")
        if (entry is None and ("reference" not in r.pair_path or launches)
                or entry is not None
                and sim.pair_compute.__name__ != entry):
            raise RuntimeError(f"{name}: pair path {r.pair_path}, "
                               f"launches {launches}")
        for kern, variants in must.items():
            for v in variants:
                if not launches.get(kern, {}).get(v):
                    raise RuntimeError(f"{name}: {kern} {v} not launched: "
                                       f"{launches}")
        if name == "molecular_ucgld" and sim._excl_rows_static is None:
            raise RuntimeError("molecular deck: no excl_delta subtraction")
        if stats is not None and not sweeps:
            raise RuntimeError(f"{name}: no cluster_switch event ran")
        check_rows(f"deck {name}", r.thermo_rows)
        del r, sim

        size_kw = "n" if "n" in kw else "nmol"
        small = {size_kw: 4096 if size_kw == "n" else 1365}
        deck_step0(name, lambda out, w=writer, k=small: getattr(
            make_deck, w)(str(out), nsteps=0, **k), pe_gate, entry)
        shutil.rmtree(d)


def deck_step0(name: str, make, pe_gate, entry: str | None) -> dict:
    """The deck that ``make(outdir)`` writes (ending in ``run 0``) to step
    0 on the card's path in f32 and on the float64 reference path on the
    CPU: pe and etotal within ``pe_gate`` (a number, or a function of the
    card's runner: a fit's gate), ke within 1e-6, the pressure within 1e-4
    (phase 10's virial gate), the out-of-table counts equal.  The card
    must take the kernel entry ``entry``, or with None the reference path
    and launch nothing.  Returns the card's runner."""
    import torch

    d = DECK_DIR / f"{name}_step0"
    path = make(d)
    counters = launch_counters()
    rows = []
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        rs = deck_runner(d, [], device=dev, dtype=dt)
        zero_launches(counters)
        rs.run_file(path)
        rows.append((rs.thermo_rows[0], rs.pair_path))
        if dev == "cuda":
            card_runner, launches = rs, read_launches(counters)
    gate = pe_gate(card_runner) if callable(pe_gate) else pe_gate
    n_small = rs.state.n_atoms
    (rk, pk), (rf, pf) = rows
    rel = {k: abs(rk[k] - rf[k]) / max(abs(rf[k]), 1e-30)
           for k in ("pe", "etotal", "ke", "press")}
    log(f"[deck {name} step 0 n={n_small}] card ({pk}) vs float64 "
        f"reference path on the CPU: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f"; oob {rk.get('oob_low')}/{rf.get('oob_low')}; pe gate "
        f"{gate:.3e}; card launches {json.dumps(launches)}")
    if (entry is not None and entry not in pk or entry is None
            and ("reference PyTorch pair path" not in pk or launches)):
        raise RuntimeError(f"{name} at {n_small}: the card took {pk}, "
                           f"launches {launches}")
    if (rel["pe"] > gate or rel["etotal"] > gate
            or rel["ke"] > 1e-6 or rel["press"] > 1e-4
            or rk.get("oob_low") != rf.get("oob_low")):
        raise RuntimeError(f"{name}: the step-0 rows disagree: {rel}")
    shutil.rmtree(d)
    return card_runner


def config4_deck_checks(card_name: str) -> None:
    """Phase 23's config-4 legs.  (a) The deck at 32,768 beads with the
    runner's ``max_sweeps`` n + 1: its ``run`` completes with more than one
    event, every event converged, each event's sweeps printed; K5, K3 and
    K6 launch and the rows stay finite.  (b) With bonds and
    ``special_bonds lj 0 0 0``, the config-4 deck and the RLE-UCG deck run
    their kernels with the density ``excl_delta``
    (:func:`density_excl_deck`)."""
    from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    counters = launch_counters()
    d = DECK_DIR / "config4_32768"
    path = make_deck.write_bethe_density_deck(str(d), n=32768)
    event, events = Simulation._cswitch_event, []

    def counted(self, *a):
        out = event(self, *a)
        events.append((int(out[2]["sweeps"]), bool(out[2]["converged"])))
        return out

    r = deck_runner(d, [])
    zero_launches(counters)
    Simulation._cswitch_event = counted
    try:
        _, sec = synced(lambda: r.run_file(path))
    finally:
        Simulation._cswitch_event = event
    launches = read_launches(counters)
    log(f"[deck bethe_density n=32768] {r.pair_path}; {r.state.step} steps "
        f"in {sec:.3f} s; max_sweeps {r.sim.cswitch[0].max_sweeps}; event "
        f"sweeps {[sw for sw, _ in events]}, converged "
        f"{[ok for _, ok in events]}; launches {json.dumps(launches)}; rows "
        f"{len(r.thermo_rows)} on {card_name}")
    for kern, v in (("cv_rho", "rho"), ("dbethe_pair", "full"),
                    ("cv_force", "full")):
        if not launches.get(kern, {}).get(v):
            raise RuntimeError(f"config 4 at 32,768: {kern} {v} not "
                               f"launched: {launches}")
    if len(events) < 2 or not all(ok for _, ok in events):
        raise RuntimeError(f"config 4 at 32,768: events {events}")
    if r.state.step != 100:
        raise RuntimeError(f"config 4 at 32,768 stopped at {r.state.step}")
    check_rows("deck bethe_density n=32768", r.thermo_rows)
    del r
    shutil.rmtree(d)

    for style, writer in (("P3", make_deck.write_bethe_density_deck),
                          ("P4", make_deck.write_rleucg_deck)):
        density_excl_deck(style, writer, counters, card_name)


def list_functional(state, jrows, params, cheb, style: str):
    """The density style's forces in its kernels' float32 functional
    (``excl_rho``, ``excl_dbethe``/``excl_rleucg``, ``excl_force``) summed
    over the partner lists ``jrows`` ((N, S) rows, N where empty), through
    the same priors, one-body terms and CV weights as the kernel path."""
    import torch

    from lammps_ucg_dev_tpu_torch.models import pair_bethe_density as pbd
    from lammps_ucg_dev_tpu_torch.models import pair_rleucg as pr4
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    typ = state.typ.long()
    zero = torch.zeros((), device=state.device)
    if style == "P3":
        tp = params.tp
        cv = (params.cv_rad, tp.cutsq[1, 1])
        rho, n_real = hcv.excl_rho(state, jrows, *cv)
        prior, partial0 = pbd._priors(params, typ, rho)
        pi1 = prior[:, 1]
        one = pbd.one_body(params, typ, torch.log(torch.clamp(
            prior, min=hd.P_LOG_FLOOR)), n_real)
        at2, _ = hd.excl_dbethe(state, jrows, params, cheb, pi1, True, True)
        use_den = (tp.use_density[typ] == 1) & (tp.n_states[typ] > 1)
        pf = torch.where(use_den[:, None],
                         torch.stack([at2[:, 3], at2[:, 6]], -1) + one, zero)
        cvf = torch.where(use_den, pf[:, 0] * partial0 - pf[:, 1] * partial0,
                          zero)
        gform = "mder" if params.backforce_derivative else "w"
    else:
        cv = (params.cv_rad, params.cutsq[1, 1])
        rho = hcv.excl_rho(state, jrows, *cv)[0]
        probs, partial = pr4.substate_probs(params, typ, rho)
        explicit, pf = pr4.one_body(params, typ, probs)
        at2, _ = hr.excl_rleucg(state, jrows, params, cheb, probs[:, 1], True,
                                params.feedback == "always")
        pf0 = pf[:, 0] + torch.where(explicit[:, 0], at2[:, 3], zero)
        cvf = torch.sum(torch.cat([pf0[:, None], pf[:, 1:]], 1) * partial, -1)
        gform = "mder" if params.conservative_sign else "pder"
    f3, _ = hcv.excl_force(state, jrows, *cv, cvf, gform, True)
    return at2[:, 0:3] + f3


def density_excl_deck(style, writer, counters, card_name) -> None:
    """A density (P3) or RLE-UCG (P4) deck at 4,096 beads with 64 bonds and
    ``special_bonds lj 0 0 0``, on the card: K5, K3/K4 and K6 launch with
    the density ``excl_delta`` (the specials subtracted pass by pass); its
    step-0 pe against the float64 reference path on the CPU, whose list
    leaves the specials out, within 1e-6 relative; then the cancellation:
    the kernel path's forces against its own float32 functional summed
    over an nsq list built without the specials
    (:func:`list_functional`), on every atom with a special partner,
    within TOL of max|f|."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import neighbor as nbrmod
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    d = DECK_DIR / f"{style}_bonds"
    path = make_deck.add_bonds(writer(str(d), n=4096, nsteps=0), nbonds=64)
    r = deck_runner(d, [])
    zero_launches(counters)
    r.run_file(path)
    launches = read_launches(counters)
    pair = "dbethe_pair" if style == "P3" else "rleucg_pair"
    for kern, v in (("cv_rho", "rho"), (pair, "full"), ("cv_force", "full")):
        if not launches.get(kern, {}).get(v):
            raise RuntimeError(f"{style} deck with exclusions: {kern} {v} "
                               f"not launched: {launches}")
    if not (r.sim._excl_route == "rows"
            and r.sim._excl_rows_static is not None):
        raise RuntimeError(f"{style} deck: the density excl_delta is off")
    ref = deck_runner(d, [], device="cpu", dtype=torch.float64)
    ref.run_file(path)
    pe_k, pe_r = r.thermo_rows[0]["pe"], ref.thermo_rows[0]["pe"]
    pe_err = abs(pe_k - pe_r) / abs(pe_r)
    sim = r.sim
    state, cl = column_state(sim)
    params, rows = sim.pair_params, sim._excl_rows_static
    out = sim.pair_compute(state, cl, params, excl_rows=rows)
    n = state.n_atoms
    spec = nbrmod.make_spec(n, state.box.lengths.cpu().numpy(), flagship.RC,
                            0.0, method="nsq")
    kept = nbrmod.build(state.x, state.box, spec, excl=rows)
    if bool(kept.overflow):
        raise RuntimeError("the excluded nsq list overflowed")
    f_list = list_functional(state, kept.idx, params, params.cheb, style)
    has = (rows < n).any(1)
    worst = float((out.f - f_list)[has].abs().max())
    scale = float(f_list.abs().max())
    log(f"[deck {style} + bonds n={n}] {r.pair_path}; launches "
        f"{json.dumps(launches)}; step-0 pe {pe_k:.6f} vs float64 reference "
        f"path {pe_r:.6f}: {pe_err:.3e}; excluded pairs: largest residual "
        f"force {worst:.3e} ({worst / scale:.3e} of max|f|) over "
        f"{int(has.sum())} atoms with a special partner, on {card_name}")
    if pe_err > 1e-6 or worst > TOL * scale:
        raise RuntimeError(f"{style} deck with exclusions: pe {pe_err:.3e}, "
                           f"residual {worst / scale:.3e}")
    shutil.rmtree(d)


TABLE_DECKS = (("spline", 2000), ("bitmap", 12))   # BITMAP: its index bits
TILT = (0.1, -0.05, 0.08)                           # × the box length


def fit_gate(runner) -> float:
    """The JAX package's kernel-vs-reference pe gate for a fitted bank,
    max(3e-5, 5 × the fit's max relative error)."""
    return max(3e-5, 5.0 * float(runner.sim.pair_params.cheb.max_rel_err
                                 .max()))


def run_styled_deck(path: str, label: str, n: int):
    """Run a deck line by line on the card, the launch counts set to 0
    just before its ``run`` and read just after; the ``pair path:`` line
    logged, the rows finite with no pair outside the tables.  Returns
    (runner, launches, seconds of the run, stepping Throughput)."""
    logs = []
    r = deck_runner(Path(path).parent, logs)
    counters = launch_counters()
    for line in deck_lines(open(path).read()):
        if line.split()[0] == "run":
            zero_launches(counters)
            with stepping_time(n) as stepping:
                _, sec = synced(lambda: r.command(line))
            launches = read_launches(counters)
        else:
            r.command(line)
    if f"pair path: {r.pair_path}" not in logs:
        raise RuntimeError(f"{label}: no pair-path log line")
    check_rows(label, r.thermo_rows)
    return r, launches, sec, stepping


def table_decks(card_name: str, deck_steps_s: float, n: int = 2**20,
                nsteps: int = 200):
    """Phase 24: the UCG-LD deck at 2^20 with ``spline 2000``, then with
    ``bitmap 12`` on the same data file (its sha256 printed and checked
    the same; ``run 200``, ``thermo 100``, no
    dumps): K1 named and launched (full and without scores only), finite
    rows, no pair outside the tables, the fit's degree and error, the
    stepping's steps/s beside phase 21's, the column slots, and K1 against
    its twin on the state reached (``@spline``, ``@bitmap``).  The Bethe
    deck with ``spline`` at 32,768 on K2 the same way; a ``lookup 2000``
    UCG-LD deck at 32,768 on the reference path, K1 launched 0 times; each
    of the four at 4,096 to step 0 on the card against the float64
    reference path on the CPU (pe gate max(3e-5, 5 × fit error), LOOKUP
    phase 3's 1e-5).  Returns ({tabstyle: K1 launches}, {tabstyle: K1 vs
    twin}, K2 launches, {variant: K2 vs twin})."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    d = DECK_DIR / "tables"
    k1_launches, k1, data_hash = {}, {}, set()
    for tabstyle, length in TABLE_DECKS:
        t0 = time.perf_counter()
        path = make_deck.write_ucgld_deck(
            str(d), n=n, nsteps=nsteps, thermo_every=100, tabstyle=tabstyle,
            tablength=length)
        t_deck = time.perf_counter() - t0
        digest = hashlib.sha256((d / "system.data").read_bytes()).hexdigest()
        data_hash.add(digest)
        label = f"deck {tabstyle} n={n}"
        log(f"[{label}] data file sha256 {digest}")
        if len(data_hash) != 1:
            raise RuntimeError(f"{label}: the data file differs from the "
                               f"first table style's")
        r, launches, sec, stepping = run_styled_deck(path, label, n)
        sim = r.sim
        cheb = sim.pair_params.cheb
        _, cl = column_state(sim)
        spec = sim.nbr_spec
        k1_launches[tabstyle] = launches.get("ucgld_pair", {})
        log(f"[{label}] {r.pair_path}; slot-major {sim._slot_ok}; bank "
            f"{sim.pair_params.bank.style} {sim.pair_params.bank.nbins} "
            f"entries, fit degree {cheb.degree}, max rel err "
            f"{float(cheb.max_rel_err.max()):.3e}; column spec cz {spec.cz}"
            f", {cl.n_slots} slots; launches {json.dumps(launches)}; run "
            f"{nsteps} steps {sec:.3f} s, stepping {stepping.elapsed:.3f} s "
            f"= {stepping.steps_per_sec:.2f} steps/s (phase 21's linear "
            f"deck {deck_steps_s:.2f}); deck written in {t_deck:.1f} s; on "
            f"{card_name} (not gated)")
        for row in r.thermo_rows:
            log(f"[{label}] {json.dumps(row)}")
        k = k1_launches[tabstyle]
        if (sim.pair_compute is not hp.compute_style or "K1" not in
                r.pair_path or not k.get("full") or not k.get("noscores")
                or k.get("fast") or set(launches) != {"ucgld_pair"}):
            raise RuntimeError(f"{label} did not run K1 full and without "
                               f"scores alone: {r.pair_path} {launches}")
        if float(cheb.max_rel_err.max()) >= 1e-4:
            raise RuntimeError(f"{label}: the fit fails its gate")
        k1[tabstyle] = compare_k1(sim, label, kernel_reps=20, twin_reps=1,
                                  with_bound=True,
                                  variants=("full", "noscores"))
        del r, sim, cl
    shutil.rmtree(d)

    # the Bethe deck with a SPLINE bank on K2
    d = DECK_DIR / "bethe_spline"
    path = make_deck.write_bethe_deck(str(d), n=32768, tabstyle="spline")
    label = "deck bethe spline n=32768"
    r, launches, sec, _ = run_styled_deck(path, label, 32768)
    sim = r.sim
    k2_launches = launches.get("bethe_pair", {})
    log(f"[{label}] {r.pair_path}; fit degree {sim.pair_params.cheb.degree}"
        f", max rel err {float(sim.pair_params.cheb.max_rel_err.max()):.3e}"
        f"; {r.state.step} steps in {sec:.3f} s; launches "
        f"{json.dumps(launches)}; last row {json.dumps(r.thermo_rows[-1])}")
    if (sim.pair_compute is not hb.compute_style_bethe
            or not k2_launches.get("full") or not k2_launches.get("fast")):
        raise RuntimeError(f"{label} did not run K2: {launches}")
    state, cl = column_state(sim)
    p = sim.pair_params
    k2 = compare_k2(state, cl, p, label, [(p.method, p.pseudo, True),
                                          (p.method, p.pseudo, False)],
                    kernel_reps=20, twin_reps=1, with_bound=True)
    k2 = {"full": k2[f"{p.method}/pseudo/full"],
          "fast": k2[f"{p.method}/pseudo/fast"]}
    del r, sim, state, cl
    shutil.rmtree(d)

    # LOOKUP: its staircase does not fit, so the reference path runs
    d = DECK_DIR / "lookup"
    path = make_deck.write_ucgld_deck(str(d), n=32768, nsteps=20,
                                      thermo_every=10, tabstyle="lookup")
    label = "deck lookup n=32768"
    r, launches, sec, _ = run_styled_deck(path, label, 32768)
    log(f"[{label}] {r.pair_path}; {r.state.step} steps in {sec:.3f} s; "
        f"launches {json.dumps(launches)}; last row "
        f"{json.dumps(r.thermo_rows[-1])}")
    if "reference PyTorch pair path" not in r.pair_path or launches:
        raise RuntimeError(f"{label}: {r.pair_path}, launches {launches}")
    del r
    shutil.rmtree(d)

    for name, make, gate, entry in (
            ("ucgld spline", lambda o: make_deck.write_ucgld_deck(
                str(o), n=4096, nsteps=0, tabstyle="spline"),
             fit_gate, "compute_style"),
            ("ucgld bitmap", lambda o: make_deck.write_ucgld_deck(
                str(o), n=4096, nsteps=0, tabstyle="bitmap", tablength=12),
             fit_gate, "compute_style"),
            ("bethe spline", lambda o: make_deck.write_bethe_deck(
                str(o), n=4096, nsteps=0, tabstyle="spline"),
             fit_gate, "compute_style_bethe"),
            ("ucgld lookup", lambda o: make_deck.write_ucgld_deck(
                str(o), n=4096, nsteps=0, tabstyle="lookup"), 1e-5, None)):
        deck_step0(name.replace(" ", "_"), make, gate, entry)
    return k1_launches, k1, k2_launches, k2


def tilted_deck(d: Path, n: int, nsteps: int) -> str:
    """The UCG-LD deck under NVE (Langevin off, no ucgstate, dt 0.002,
    thermo 10) in a box tilted by ``xy xz yz`` = TILT × L."""
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    path = make_deck.write_ucgld_deck(str(d), n=n, nsteps=nsteps,
                                      thermo_every=10, dt=0.002,
                                      thermostat=False, tilt=TILT)
    with open(path) as fh:
        text = "".join(ln for ln in fh if not ln.startswith("fix 3"))
    with open(path, "w") as fh:
        fh.write(text)
    return path


def triclinic_and_switches(device: str, card_name: str,
                           n: int = 32768) -> None:
    """Phase 25.  (a) The tilted UCG-LD deck at ``n`` on the card: the
    runner takes the nsq reference path (logged), rows finite, and the NVE
    drift of the JAX ``bench.run_drift`` protocol (``run 10`` then ``run
    180``, H = etotal + Σ λ μ_diff) under 1e-4; at 4,096 to step 0 against
    the float64 reference path on the CPU at phase 3's 1e-5.  (b)
    ``sort_atoms`` on against off on the flagship's cell reference path at
    ``n`` (a rebuild every block of 10), 20 steps: x by tag within 1e-5 of
    the box."""
    import torch

    from lammps_ucg_dev_tpu_torch import flagship

    d = DECK_DIR / "tilted"
    path = tilted_deck(d, n, 190)
    logs = []
    r = deck_runner(d, logs)
    for line in deck_lines(open(path).read()):
        if line.split()[0] != "run":
            r.command(line)

    def hamiltonian():
        tp, st = r.sim.pair_params.tp, r.state
        mu = torch.where(tp.n_states[st.typ] > 1,
                         st.ucgl * tp.mu_diff[st.typ], 0.0)
        return r.thermo_rows[-1]["etotal"] + float(mu.sum())

    _, sec0 = synced(lambda: r.command("run 10"))
    e0 = hamiltonian()
    _, sec1 = synced(lambda: r.command("run 180"))
    e1 = hamiltonian()
    drift = abs(e1 - e0) / max(abs(e0), 1e-12)
    log(f"[deck tilted n={n}] {r.pair_path}; tilt "
        f"{r.state.box.tilt.tolist()}; steps {r.state.step} in "
        f"{sec0 + sec1:.3f} s on {card_name}; H0 {e0:.9f} H1 {e1:.9f} drift "
        f"{drift:.6e} (limit {DRIFT_MAX:g}); last row "
        f"{json.dumps(r.thermo_rows[-1])}")
    if (r.sim.nbr_spec.method != "nsq" or "on a nsq list" not in r.pair_path
            or not r.state.box.is_triclinic):
        raise RuntimeError(f"the tilted deck did not take nsq: {r.pair_path}")
    check_rows(f"deck tilted n={n}", r.thermo_rows)
    if r.state.step != 190 or not drift < DRIFT_MAX:
        raise RuntimeError(f"tilted NVE drift {drift} exceeds {DRIFT_MAX}")
    del r
    shutil.rmtree(d)
    deck_step0("tilted", lambda o: tilted_deck(o, 4096, 0), 1e-5, None)

    sims = []
    for sort in (False, True):
        sim = flagship.build_sim(n=n, device=device, kernel=False,
                                 reneigh_every=10)
        sim.cfg = dataclasses.replace(sim.cfg, sort_atoms=sort,
                                      reneigh_check=False)
        if sim.nbr_spec.method != "cell":
            raise RuntimeError("sort_atoms leg: not on the cell list")
        _, sec = synced(lambda: sim.run(20))
        sims.append((sim, sec))
    (a, sa), (b, sb) = sims
    ia = torch.argsort(a.state.tag.long())
    ib = torch.argsort(b.state.tag.long())
    L = a.state.box.lengths
    dx = a.state.box.min_image(a.state.x[ia] - b.state.x[ib]).abs().max()
    dv = float((a.state.v[ia] - b.state.v[ib]).abs().max())
    moved = int((b.state.tag != torch.arange(1, n + 1, device=device,
                                             dtype=torch.int32)).sum())
    err = float(dx / L.min())
    log(f"[sort_atoms n={n}] 20 steps on the cell reference path: off "
        f"{sa:.3f} s, on {sb:.3f} s; rows moved by the sort "
        f"{moved}; by tag max|dx|/L {err:.3e}, max|dv| {dv:.3e}")
    if moved == 0 or not err <= 1e-5:
        raise RuntimeError(f"sort_atoms: rows moved {moved}, x differs by "
                           f"{err} of the box")


def deck_fingerprint() -> None:
    """The ``verify`` skill's deck fingerprint on the card:
    ``write_ucgld_deck(n=1000, nsteps=200, thermo_every=100)``; the step-0
    etotal beside the JAX package's 5520.27; later rows printed (the
    random streams differ, F1).  The step-0 etotal must agree to K1's
    oracle pe gate, 1e-5 relative."""
    from lammps_ucg_dev_tpu_torch.tools import make_deck

    d = DECK_DIR / "fingerprint"
    path = make_deck.write_ucgld_deck(str(d), n=1000, nsteps=200,
                                      thermo_every=100)
    r = deck_runner(d, [])
    r.run_file(path)
    check_rows("deck fingerprint", r.thermo_rows)
    e = [row["etotal"] for row in r.thermo_rows]
    log(f"[deck fingerprint n=1000] etotal at steps 0/100/200: "
        f"{e[0]:.2f} (JAX package {SKILL_ETOTAL0}) -> {e[1]:.2f} -> "
        f"{e[2]:.2f}; {r.pair_path}")
    if abs(e[0] - SKILL_ETOTAL0) > 1e-5 * SKILL_ETOTAL0:
        raise RuntimeError(f"step-0 etotal {e[0]} is not the JAX package's "
                           f"{SKILL_ETOTAL0}")
    shutil.rmtree(d)


def finite_row(row: dict) -> bool:
    return all(v == v and abs(v) != float("inf")
               for v in row.values() if isinstance(v, float))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from lammps_ucg_dev_tpu_torch import flagship
    from lammps_ucg_dev_tpu_torch.ops import cuda_lib
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- 1. the card -----------------------------------------------------
    card_name = card()
    log(card_name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build the kernels (one nvcc per source, together) ----------
    t0 = time.perf_counter()
    libs = cuda_lib.build(["ucgld_pair", "bethe_pair", "density_cv",
                           "ucgld_cluster", "ucgld_ablation"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, nl in libs.items():
        log(f"  {name}: nvcc {nl.build_seconds:.1f} s -> {nl.path.name}")
        for line in cuda_lib.ptxas_summary(nl.log):
            log(f"    ptxas: {line}")

    # ---- 3. K1 vs its twin, and the K1 path vs the oracle ---------------
    small = flagship.build_sim(n=32768, device=device, reneigh_every=20)
    compare_k1(small, "n=32768", kernel_reps=40, twin_reps=3)
    compare_k7(small, "n=32768", kernel_reps=40, twin_reps=3)
    del small
    sim = flagship.build_sim(n=2**20, device=device, reneigh_every=20)
    if sim.pair_compute is not hp.compute_style:
        raise RuntimeError("select_pair_kernel did not choose K1 at 2^20")
    if not sim._slot_ok:
        raise RuntimeError("UCG-LD: the slot-major interior is off")
    k1 = compare_k1(sim, "n=2^20", kernel_reps=20, twin_reps=1,
                    with_bound=True)
    k7 = compare_k7(sim, "n=2^20", kernel_reps=20, twin_reps=1,
                    with_bound=True)
    check_k1_oracle(device, "K1", flagship.build_sim, hp.compute_style)

    # ---- 3b. the K7 ablation table (the microbench path) -----------------
    from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha
    from lammps_ucg_dev_tpu_torch.tools import kbench

    for k in ha.ucgld_ablation.launches:
        ha.ucgld_ablation.launches[k] = 0
    table = kbench.run(sim, reps=20)
    k7_launches = dict(ha.ucgld_ablation.launches)
    for r in table:
        log(f"[kbench n=2^20] {json.dumps(r)}")
    if any(k7_launches[f"L{lv}"] < 20 for lv in ha.LEVELS):
        raise RuntimeError(f"the microbench did not run K7: {k7_launches}")

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
        f"on {card_name}; temp {row['temp']:.6f} etotal {row['etotal']:.6f} "
        f"oob_low {row['oob_low']}; dangerous builds {sim.dangerous_builds}; "
        f"K1 launches {k1_launches}")
    ucgld_steps_s = steps_s
    nblk = blocks + 1
    if (k1_launches["full"] < nblk
            or k1_launches["noscores"] < (nre - 1) * nblk):
        raise RuntimeError(f"main path did not run through K1: {k1_launches}")
    if not finite_row(row):
        raise RuntimeError(f"non-finite thermo: {row}")
    if row["oob_low"] != 0:
        raise RuntimeError(f"pairs below the table inner cutoff: {row}")
    missed_pairs(sim, "UCG-LD n=2^20")
    atom_order_reading(sim, "UCG-LD main n=2^20", blocks, window, card_name)
    del sim

    # ---- 5. NVE drift (bench.run_drift protocol) -------------------------
    ds = flagship.build_sim(n=32768, device=device, reneigh_every=10)
    ds.cfg = dataclasses.replace(ds.cfg, langevin=None, dt=0.002)
    if not ds._slot_ok:
        raise RuntimeError("drift leg: the slot-major interior is off")
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
    if not sim._slot_ok:
        raise RuntimeError("Bethe: the slot-major interior is off")
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
        f"on {card_name}; temp {row['temp']:.6f} etotal {row['etotal']:.6f} "
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
    missed_pairs(sim, "Bethe n=2^20")
    atom_order_reading(sim, "Bethe main n=2^20", blocks, window, card_name)
    del sim

    # ---- 9. K5, K3/K4 and K6 vs their twins --------------------------------
    from lammps_ucg_dev_tpu_torch import flagship as fs

    dens = {}
    for style, build in (("P3", fs.build_density_sim),
                         ("P4", fs.build_rleucg_sim)):
        small = build(n=32768, device=device)
        small.setup((0, 10))
        compare_density(small, f"{style} n=32768", 40, 3)
        del small
        sim = build(n=2**20, device=device)
        sim.setup((0, 10))
        dens[style] = compare_density(sim, f"{style} n=2^20", 20, 1,
                                      with_bound=True)
        del sim

    # ---- 10. the K3 and K4 paths vs the reference path ---------------------
    for style in ("P3", "P4"):
        check_density_oracle(device, style)

    # ---- 11. the P3 and P4 main paths -------------------------------------
    main = {style: run_density_main(device, style, card_name)
            for style in ("P3", "P4")}

    # ---- 12. K8 vs its twin ---------------------------------------------
    small = flagship.build_cluster_sim(n=32768, device=device)
    compare_k8(small, "n=32768", kernel_reps=20, twin_reps=1)
    del small
    sim = flagship.build_cluster_sim(n=2**20, device=device)
    k8 = compare_k8(sim, "n=2^20", kernel_reps=10, twin_reps=1,
                    with_bound=True)
    del sim

    # ---- 13. the K8 path vs the oracle ----------------------------------
    from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc

    check_k1_oracle(device, "K8", flagship.build_cluster_sim,
                    hc.compute_style_cluster)

    # ---- 14. the cluster main path --------------------------------------
    k8_launches, _ = run_cluster_main(device, card_name)

    # ---- 15. the slot-major interior against the atom-ordered one --------
    for label, build, mode, k1_interior in (
            ("UCG-LD ld", functools.partial(flagship.build_sim,
                                            reneigh_every=20), None,
             "noscores"),
            ("UCG-LD default", functools.partial(flagship.build_sim,
                                                 reneigh_every=20),
             "default", "fast"),
            ("Bethe", flagship.build_bethe_sim, None, None),
            ("P3", flagship.build_density_sim, None, None),
            ("P4", flagship.build_rleucg_sim, None, None)):
        slot_vs_atom(device, label, build, mode, k1_interior)

    # ---- 16. exclusions on the card ------------------------------------
    for style in ("ucgld", "bethe"):
        check_excl_oracle(device, style)

    # ---- 17. the molecular main path --------------------------------------
    mol_launches, mol_steps_s, k1_mol = run_molecular_main(device,
                                                           card_name)

    # ---- 18. drift with topology ---------------------------------------
    topology_drift(device)

    # ---- 19. config 4 with its cluster_switch ---------------------------
    sw_launches, _, dens["P3+cluster_switch"] = run_density_switch(
        device, card_name)

    # ---- 20. tetramers ---------------------------------------------------
    check_tetramers(device)

    # ---- 21. the flagship deck at 2^20 through ScriptRunner -------------
    k1_deck_launches, k1_deck, deck_steps_s = run_deck_flagship(
        card_name, ucgld_steps_s)

    # ---- 22. restart continuity -------------------------------------------
    deck_restart_continuity()

    # ---- 23. the other decks, and the deck fingerprint -------------------
    other_decks(card_name)
    config4_deck_checks(card_name)
    deck_fingerprint()

    # ---- 24. SPLINE, BITMAP and LOOKUP decks ----------------------------
    k1_tab_launches, k1_tab, k2_tab_launches, k2_tab = table_decks(
        card_name, deck_steps_s)

    # ---- 25. a tilted box, and the driver's switches --------------------
    triclinic_and_switches(device, card_name)

    # ---- 26. the spatial drivers ---------------------------------------
    slab = run_spatial(card_name)

    # ---- 27. the rest of the spatial drivers -----------------------------
    slab.update(run_spatial_rest(card_name, mol_steps_s))
    shutil.rmtree(DECK_DIR, ignore_errors=True)

    log(f"K1 fast variant (not on the UCG-LD main path under ucgstate ld): "
        f"{json.dumps(k1['fast'], default=float)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    def entry(name, source, launches, r, replaces=REPLACES):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    # one entry per kernel variant and main path: its launches on that
    # path and its times, error and bound on that path's inputs
    launch = {"P3": main["P3"][0], "P4": main["P4"][0],
              "P3+cluster_switch": sw_launches}
    kernels = ([entry(f"ucgld_pair[{v}]", K1_SOURCE, k1_launches[v], k1[v])
                for v in ("full", "noscores")]
               + [entry(f"ucgld_pair[{v}]@deck", K1_SOURCE,
                        k1_deck_launches[v], k1_deck[v])
                  for v in ("full", "noscores")]
               + [entry(f"ucgld_pair[{v}]@{t}", K1_SOURCE,
                        k1_tab_launches[t][v], k1_tab[t][v])
                  for t, _ in TABLE_DECKS for v in ("full", "noscores")]
               + [entry(f"ucgld_pair[{v}]@molecular", K1_SOURCE,
                        mol_launches[v], k1_mol[v])
                  for v in ("full", "noscores")]
               + [entry(f"bethe_pair[{v}]", K2_SOURCE, k2_launches[v], k2[v])
                  for v in ("full", "fast")]
               + [entry(f"bethe_pair[{v}]@spline", K2_SOURCE,
                        k2_tab_launches[v], k2_tab[v])
                  for v in ("full", "fast")]
               + [entry(f"dbethe_pair[{v}]" + at, K2_SOURCE,
                        launch[p]["dbethe_pair"][v],
                        dens[p][f"dbethe_pair[{v}]"])
                  for p, at in (("P3", ""),
                                ("P3+cluster_switch", "@P3+cluster_switch"))
                  for v in ("full", "fast_noscores")]
               + [entry(f"rleucg_pair[{v}]", K2_SOURCE,
                        launch["P4"]["rleucg_pair"][v],
                        dens["P4"][f"rleucg_pair[{v}]"])
                  for v in ("full", "fast")]
               + [entry("cv_rho" + at, CV_SOURCE, launch[p]["cv_rho"]["rho"],
                        dens[p]["cv_rho"], CV_REPLACES)
                  for p, at in (("P3", ""), ("P4", "@P4"),
                                ("P3+cluster_switch", "@P3+cluster_switch"))]
               + [entry(f"cv_force[{v}]" + at, CV_SOURCE,
                        launch[p]["cv_force"][v], dens[p][f"cv_force[{v}]"],
                        CV_REPLACES)
                  for p, at in (("P3", ""), ("P4", "@P4"),
                                ("P3+cluster_switch", "@P3+cluster_switch"))
                  for v in ("full", "fast")]
               + [entry("ucgld_cluster[full]", K8_SOURCE,
                        k8_launches["full"], k8, K8_REPLACES)]
               + [entry(f"ucgld_ablation[L{lv}]", K7_SOURCE,
                        k7_launches[f"L{lv}"], k7[lv], K7_REPLACES)
                  for lv in ha.LEVELS]
               + [entry(key, SLAB_KERNELS[name][2], n, r,
                        CV_REPLACES if name.startswith("cv_") else REPLACES)
                  for key, (r, n, name) in sorted(slab.items())])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---- 26. the spatial drivers ------------------------------------------------

SLABS = 3                      # ranks sharing the card over gloo
SLAB_STYLES = ("ucgld", "bethe", "p3", "p4")
SLAB_N = 2**20                 # every style's slab run, the main path's size
PENCIL_N = 2**18               # the 3x3 pencil grid's setup check
SLAB_KERNELS = {               # wrapper: (twin, kind of bound, source)
    "ucgld_pair": ("ucgld_pair_reference", "ucgld", K1_SOURCE),
    "bethe_pair": ("bethe_pair_reference", "bethe", K2_SOURCE),
    "dbethe_pair": ("dbethe_pair_reference", "dbethe", K2_SOURCE),
    "rleucg_pair": ("rleucg_pair_reference", "rleucg", K2_SOURCE),
    "cv_rho": ("cv_rho_reference", "cv_rho", CV_SOURCE),
    "cv_force": ("cv_force_reference", "cv_force", CV_SOURCE)}


def to_device(obj, dev):
    """``obj`` with every tensor moved to ``dev`` (tuples, lists, dicts)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    return obj


def slab_holds(inputs: dict, label: str) -> dict:
    """Every recorded kernel variant of one rank's slab inputs against its
    twin on the card (``hold``), with the bound of that rank's work."""
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    mods = {"ucgld_pair": hp, "bethe_pair": hb, "dbethe_pair": hd,
            "rleucg_pair": hr, "cv_rho": hcv, "cv_force": hcv}
    res = {}
    for key, (args, kw) in sorted(inputs.items()):
        name = key.split("[")[0]
        twin, kind, _ = SLAB_KERNELS[name]
        args = to_device(args, "cuda")
        if kw.get("periodic", (True, True))[0]:
            raise RuntimeError(f"{label} {key}: the slab's x axis is "
                               f"periodic")
        exact = (1,) if name == "cv_rho" else ()
        res[key] = hold(label, f"{key} periodic {kw['periodic']}",
                        getattr(mods[name], name),
                        getattr(mods[name], twin), args, kw, 20, 1, exact)
        res[key].update(bound(kind, args, kw))
    return res


def run_spatial(card_name: str) -> dict:
    """Phase 26: the spatial drivers on ``SLABS`` gloo ranks sharing the
    card (``parallel/launch.start``, the jobs of ``tools/spatial_check``),
    then a 3×3 pencil grid of 9.  On the slabs: each style's setup forces
    and pe at 32,768 beads against one process's column path on the card
    (f within TOL of max|f|, pe 1e-5 relative); the 2^20 flagship through
    ``run_fused``, a warm block and 100 timed steps, K1's launches on every
    rank (counts set to 0 just before the timed steps), overflow raising
    inside, D1 on every rank (no pair missing from a list that was within
    cutoff + skin at its rebuild; pairs that came closer since, as on one
    device after a dangerous build, are printed with their separation at
    the rebuild), Σ nloc = N and the tags a permutation;
    Bethe, P3 and P4 at 2^20 through 20 timed steps each, their kernels
    launched; the kernel inputs of rank 0 (the setup and one block of each
    style, every variant launched: the x axis not periodic) against the
    twins with their bounds (``@slab`` entries); the NVE drift of
    ``bench.run_drift`` at 32,768 under 1e-4; a ``processors 3 1 1`` deck
    (32,768 beads, 20 steps) against the same deck on one process (pe 1e-5
    relative).  On the pencils: the flagship's setup at 2^18 against one
    process (the setup gates; a check of the y halos, which no kernel row
    reads).  Returns {entry name: (result, launches,
    wrapper)}."""
    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
    from lammps_ucg_dev_tpu_torch.parallel import launch
    from lammps_ucg_dev_tpu_torch.tools import make_deck
    from lammps_ucg_dev_tpu_torch.tools import spatial_check as sc

    t0 = time.perf_counter()
    dims = (SLABS, 1)
    small = 32768
    d = DECK_DIR / "spatial"
    one = DECK_DIR / "spatial_one"
    path = make_deck.write_ucgld_deck(str(d), n=small, nsteps=20,
                                      thermo_every=10)
    text = open(path).read()
    with open(path, "w") as fh:
        fh.write(f"processors {SLABS} 1 1\n" + text)
    setups = [dict(kind="run", style=st, n=small, dims=dims, steps=0,
                   arrays=True) for st in SLAB_STYLES]
    main_job = dict(kind="run", style="ucgld", n=SLAB_N, reneigh=20,
                    dims=dims, steps=100, timed=True, d1=True)
    mids = [dict(kind="run", style=st, n=SLAB_N, dims=dims, steps=20,
                 timed=True) for st in SLAB_STYLES[1:]]
    inputs = ([dict(kind="inputs", style="ucgld", n=SLAB_N, reneigh=20,
                    dims=dims)]
              + [dict(kind="inputs", style=st, n=SLAB_N, dims=dims)
                 for st in SLAB_STYLES[1:]])
    jobs = (setups + [main_job] + mids + inputs
            + [dict(kind="drift", n=small, dims=dims),
               dict(kind="deck", path=path, workdir=str(d), dims=dims)])
    ranks = launch.start(sc.run_jobs, SLABS, jobs, device="cuda",
                         timeout=600)
    # one process's references on the same card meanwhile
    refs = [sc._single(j, "cuda") for j in setups]
    pencil = dict(kind="run", style="ucgld", n=PENCIL_N, dims=(3, 3),
                  steps=0, arrays=True)
    pencil_ref = sc._single(pencil, "cuda")
    runner = ScriptRunner(workdir=str(one), log_callback=lambda m: None)
    runner.run_file(make_deck.write_ucgld_deck(str(one), n=small, nsteps=20,
                                               thermo_every=10))
    res = ranks.join()
    t_slabs = time.perf_counter() - t0
    r0 = res[0]
    bad = []
    for job, ref, got in zip(setups, refs, r0[:4]):
        e = sc.compare_setup(job, ref, got)
        log(f"[slabs {job['style']} setup n={small}, {SLABS} gloo ranks on "
            f"one card] vs one process: f {e['f']:.3e} of max|f|, pe "
            f"{e['pe']:.3e}; launches {json.dumps(got['launches'])}")
        if e["f"] > TOL or e["pe"] > 1e-5:
            bad.append(f"{job['style']} setup {e}")
    mains = [r[4] for r in res]
    m = mains[0]
    nloc = [r["nloc"] for r in mains]
    d1 = [r["d1"] for r in mains]
    k1 = [r["launches"].get("ucgld_pair", {}) for r in mains]
    log(f"[slabs UCG-LD main n={SLAB_N}] 100 steps in {m['seconds']:.3f} s = "
        f"{m['steps_s']:.2f} steps/s on {SLABS} gloo ranks sharing "
        f"{card_name}; temp {m['rows'][0]['temp']:.6f} etotal "
        f"{m['rows'][0]['etotal']:.6f}; Σ nloc {sum(nloc)} {nloc}; tags a "
        f"permutation {m['tags_ok']}; migrations {m['migrations']}; "
        f"dangerous builds {m['dangerous']}; D1 per rank {d1}; K1 launches "
        f"per rank {k1}")
    if (sum(nloc) != SLAB_N or not m["tags_ok"]
            or any(x["built_within_rc"] != 0 for x in d1)
            or any(not k.get("full") or not k.get("noscores") for k in k1)
            or not finite_row(m["rows"][0])):
        bad.append("the slab flagship failed its checks")
    log(f"[slabs UCG-LD main comm, rank 0, one more block with each "
        f"exchange timed between syncs] {json.dumps(m['comm'])}")
    launches = {"ucgld": m["launches"]}
    for job, r in zip(mids, r0[5:8]):
        launches[job["style"]] = r["launches"]
        log(f"[slabs {job['style']} n={SLAB_N}] 20 steps "
            f"{r['steps_s']:.2f} steps/s (informational: ranks share the "
            f"card, halos staged through the host); launches "
            f"{json.dumps(r['launches'])}; comm {json.dumps(r['comm'])}")
    holds = {}
    for job, r in zip(inputs, r0[8:12]):
        for key, h in slab_holds(r["inputs"], f"slab rank 0 {job['style']} "
                                              f"n={job['n']}").items():
            holds[job["style"], key] = h
    drift = r0[12]["drift"]
    log(f"[slabs drift n={small}] {drift:.6e} (slot-major {r0[12]['slot']},"
        f" limit {DRIFT_MAX:g})")
    if not drift < DRIFT_MAX:
        bad.append(f"drift {drift}")
    deck = r0[13]
    deck_err = max(abs(a["pe"] - b["pe"]) / abs(b["pe"])
                   for a, b in zip(deck["rows"], runner.thermo_rows))
    log(f"[deck processors {SLABS} 1 1 n={small}] spatial {deck['spatial']}"
        f"; {deck['pair_path']}; pe against one process {deck_err:.3e}; "
        f"launches {json.dumps(deck['launches'])}")
    if not deck["spatial"] or deck_err > 1e-5:
        bad.append(f"deck {deck_err}")
    t1 = time.perf_counter()
    pen = launch.spawn(sc.run_jobs, 9, [pencil], device="cuda", timeout=300)
    e = sc.compare_setup(pencil, pencil_ref, pen[0][0])
    log(f"[pencils 3x3 UCG-LD setup n={PENCIL_N}, 9 gloo ranks] vs one "
        f"process: f {e['f']:.3e} of max|f|, pe {e['pe']:.3e} "
        f"({time.perf_counter() - t1:.1f} s)")
    if e["f"] > TOL or e["pe"] > 1e-5:
        bad.append(f"pencil setup {e}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(one, ignore_errors=True)
    log(f"[phase 26] {time.perf_counter() - t0:.1f} s (slabs "
        f"{t_slabs:.1f} s)")
    if bad:
        raise RuntimeError("spatial drivers: " + "; ".join(bad))
    # entry names: "wrapper[variant]@slab", P4's K5/K6 "...@P4@slab"
    out = {}
    for (style, key), r in holds.items():
        name, var = key[:-1].split("[")
        n = launches[style].get(name, {}).get(var, 0)
        if not n:
            raise RuntimeError(f"{style} {key} launched no time in its slab "
                               f"run: {launches[style]}")
        tag = "@P4@slab" if (style == "p4" and name.startswith("cv_")) \
            else "@slab"
        out[(key if name != "cv_rho" else "cv_rho") + tag] = (r, n, name)
    return out


# ---- 27. the rest of the spatial drivers -----------------------------------

MOL_SLAB_N = 1048575           # the molecular main path's 349,525 trimers
TOPO_N = 32769                 # its setup and drift legs
# the molecular setup on slabs against one process's kernel path, f of
# max|f|: read 4.468e-5 (the largest sound reading, PR 14); the control,
# that path against the float64 reference path, reads 1.344e-4
MOL_SETUP_TOL = 1e-4
SWITCH_SLAB_N = 2**20          # config 4 with its switch
DOMAIN_N = 32768               # the processors 2 1 1 deck


def run_spatial_rest(card_name: str, mol_steps_s: float) -> dict:
    """Phase 27: topology, r-RESPA and ``fix cluster_switch`` on ``SLABS``
    gloo ranks sharing the card, and the atom decomposition on 2
    (``parallel/launch.start``, the jobs of ``tools/spatial_check``).
    Molecular trimers (K1 with ``excl_delta`` on each rank's owned rows,
    the bonded terms by member share): the setup at 32,769 against one
    process's kernel path on the card, f within MOL_SETUP_TOL of max|f|
    (each float32 side sums the specials' cancellation in its own order;
    the float64 reference path's distance from one process's kernel path
    printed beside it), pe within 1e-5 of both; the 2^20 path, a
    warm block and 20 timed steps, K1's launches per rank, D1 per rank
    (no pair within cutoff + skin at a rebuild missing), Σ nloc and the
    tags, beside phase 17's one-card steps/s, the excluded pairs' residual
    on rank 0 at its last rebuild (K1 - ``excl_delta`` against K1's
    functional over a list without the specials, within TOL of max|f|,
    phase 16's check), then K1's variants against
    their twin on rank 0's inputs (``@molecular@slab``); NVE drift with
    topology at 32,769, Verlet (bonds 50/0.9, dt 0.001) under 1e-4 and
    r-RESPA (K 400, 4 inner steps, dt 0.004) under 2e-4, D1 per rank.
    Config 4 with its switch at 2^20 through 60 steps: two events that
    converge (the driver raises otherwise), each event's sweeps and its
    block's ms beside a plain block's, K5, K3 and K6 launched, D1 per
    rank.  The ``processors 2 1 1`` flagship deck at 32,768 (a grid the
    slabs cannot cut) on 2 ranks: the atom decomposition, K1 launched, the
    final state bit for bit one process's.  Returns {entry name: (result,
    launches, wrapper)} of the ``@molecular@slab`` entries."""
    import numpy as np
    import torch

    from lammps_ucg_dev_tpu_torch.compat.script import ScriptRunner
    from lammps_ucg_dev_tpu_torch.parallel import launch
    from lammps_ucg_dev_tpu_torch.tools import make_deck
    from lammps_ucg_dev_tpu_torch.tools import spatial_check as sc

    t0 = time.perf_counter()
    dims = (SLABS, 1)
    setup = dict(kind="run", style="molecular", n=TOPO_N, dims=dims,
                 steps=0, arrays=True)
    jobs = [setup,
            dict(kind="run", style="molecular", n=MOL_SLAB_N, dims=dims,
                 steps=20, timed=True, d1=True, residual=True, inputs=True),
            dict(kind="topo_drift", n=TOPO_N, respa_inner=1, dt=0.001,
                 bond_k=50.0, warm=10, dims=dims),
            dict(kind="topo_drift", n=TOPO_N, respa_inner=4, dt=0.004,
                 bond_k=400.0, warm=5, dims=dims),
            dict(kind="switch_events", n=SWITCH_SLAB_N, steps=60,
                 dims=dims)]
    ranks = launch.start(sc.run_jobs, SLABS, jobs, device="cuda",
                         timeout=600)
    d = DECK_DIR / "domain"
    one = DECK_DIR / "domain_one"
    path = make_deck.write_ucgld_deck(str(d), n=DOMAIN_N, nsteps=20,
                                      thermo_every=10)
    text = open(path).read()
    with open(path, "w") as fh:
        fh.write("processors 2 1 1\n" + text)
    dom_run = dict(kind="domain", style="ucgld", n=DOMAIN_N, steps=100,
                   dims=(2, 1))
    dom = launch.start(sc.run_jobs, 2, [dict(kind="deck", path=path,
                                             workdir=str(d), dims=(2, 1),
                                             arrays=True), dom_run],
                       device="cuda", timeout=600)
    # one process's references on the same card meanwhile: the kernel
    # path, and the float64 reference path with the specials left out
    ref = sc._single(setup, "cuda")
    ref64 = sc._single(dict(setup, kernel=False, dtype="float64"), "cuda")
    one_sim = sc.build(dict(dom_run, kind="run"), "cuda")
    one_sim.setup((0, dom_run["steps"]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one_sim.run(dom_run["steps"])
    torch.cuda.synchronize()
    one_steps_s = dom_run["steps"] / (time.perf_counter() - t1)
    del one_sim
    runner = ScriptRunner(workdir=str(one), log_callback=lambda m: None)
    runner.run_file(make_deck.write_ucgld_deck(str(one), n=DOMAIN_N,
                                               nsteps=20, thermo_every=10))
    ref_deck = sc.arrays_of(runner.state, runner.sim._fcarry)
    res = ranks.join()
    t_slabs = time.perf_counter() - t0
    r0 = res[0]
    bad = []

    def d1_ok(d1s):
        return all(x is not None and x["built_within_rc"] == 0
                   for x in d1s)

    # K1 sums the specials' large forces and excl_delta takes them off, so
    # each float32 side carries the cancellation's rounding in its own
    # order: one process's kernel path sits 1.344e-4 of max|f| from the
    # float64 reference path (the control, printed beside the reading)
    e = sc.compare_setup(setup, ref, r0[0])
    e64 = sc.compare_setup(setup, ref64, r0[0])
    one64 = sc.compare_setup(setup, ref64, ref)
    log(f"[slabs molecular setup n={TOPO_N}, {SLABS} gloo ranks on one "
        f"card] vs one process's kernel path: f {e['f']:.3e} of max|f|, pe "
        f"{e['pe']:.3e}; vs its float64 reference path: f {e64['f']:.3e}, "
        f"pe {e64['pe']:.3e} (the control, one process's kernel path "
        f"there: f {one64['f']:.3e}, pe {one64['pe']:.3e}); limits: f "
        f"{MOL_SETUP_TOL:g}, pe 1e-5; launches "
        f"{json.dumps(r0[0]['launches'])}")
    if e["f"] > MOL_SETUP_TOL or max(e["pe"], e64["pe"]) > 1e-5:
        bad.append(f"molecular setup {e} {e64} {one64}")
    mains = [r[1] for r in res]
    resid = mains[0]["residual"]
    worst = resid["residual"] / resid["fscale"]
    log(f"[slabs molecular excl residual n={MOL_SLAB_N}, rank 0 at its "
        f"last rebuild] K1 - excl_delta vs K1's functional over its list "
        f"without the specials: largest residual force "
        f"{resid['residual']:.3e} over {resid['atoms']} owned atoms with a "
        f"special partner; {worst:.3e} of max|f| (limit {TOL:g})")
    if worst > TOL or resid["overflow"]:
        bad.append(f"excluded pairs do not cancel on slabs: {worst}")
    m = mains[0]
    nloc = [x["nloc"] for x in mains]
    d1 = [x["d1"] for x in mains]
    k1 = [x["launches"].get("ucgld_pair", {}) for x in mains]
    log(f"[slabs molecular main n={MOL_SLAB_N}] 20 steps in "
        f"{m['seconds']:.3f} s = {m['steps_s']:.2f} steps/s on {SLABS} "
        f"gloo ranks sharing {card_name} (one card, phase 17: "
        f"{mol_steps_s:.2f}); temp {m['rows'][0]['temp']:.6f} etotal "
        f"{m['rows'][0]['etotal']:.6f}; Σ nloc {sum(nloc)} {nloc}; tags a "
        f"permutation {m['tags_ok']}; migrations {m['migrations']}; "
        f"dangerous builds {m['dangerous']}; D1 per rank {d1}; K1 launches "
        f"per rank {k1}; rank 0's exchanges, one more block timed "
        f"{json.dumps(m['comm'])}")
    if (sum(nloc) != MOL_SLAB_N or not m["tags_ok"] or not d1_ok(d1)
            or any(not x.get("full") or not x.get("noscores") for x in k1)
            or not finite_row(m["rows"][0])):
        bad.append("the molecular slab path failed its checks")
    holds = slab_holds(m["inputs"], f"slab rank 0 molecular n={MOL_SLAB_N}")
    drift = {"verlet": [r[2] for r in res], "respa": [r[3] for r in res]}
    log(f"[slabs topology drift n={TOPO_N}] Verlet (bonds 50/0.9, dt 0.001)"
        f" {drift['verlet'][0]['drift']:.6e}, r-RESPA (K 400, 4 inner, dt "
        f"0.004) {drift['respa'][0]['drift']:.6e} (limits 1e-4, 2e-4); D1 "
        f"per rank {[x['d1'] for x in drift['verlet'] + drift['respa']]}")
    if not (drift["verlet"][0]["drift"] < DRIFT_MAX
            and drift["respa"][0]["drift"] < 2e-4):
        bad.append(f"topology drift on slabs {drift}")
    if not d1_ok([x["d1"] for x in drift["verlet"] + drift["respa"]]):
        bad.append("topology drift D1")
    sw = [r[4] for r in res]
    s0 = sw[0]
    launched = s0["launches"]
    log(f"[slabs config 4 + cluster_switch n={SWITCH_SLAB_N}] 60 steps, "
        f"events at steps 20 and 40: sweeps {s0['sweeps']}, the event "
        f"blocks {[round(v, 1) for v in s0['event_block_ms']]} ms against "
        f"a plain block's {s0['block_ms']:.1f} ms (an event's cost: the "
        f"difference); stats {s0['stats']}; temp {s0['row']['temp']:.6f}; "
        f"launches {json.dumps(launched)}; D1 per rank "
        f"{[x['d1'] for x in sw]}")
    if (len(s0["sweeps"]) < 2 or not finite_row(s0["row"])
            or any(not launched.get(k) for k in ("cv_rho", "dbethe_pair",
                                                 "cv_force"))
            or not d1_ok([x["d1"] for x in sw])):
        bad.append(f"config 4 with its switch on slabs: {s0['sweeps']}")
    dres = dom.join()
    got = dres[0][0]
    same = all(np.array_equal(got["arrays"][k], ref_deck[k])
               for k in ref_deck)
    log(f"[atom decomposition UCG-LD n={DOMAIN_N}, 2 gloo ranks sharing "
        f"{card_name}] 100 steps through run: "
        f"{dres[0][1]['steps_s']:.2f} steps/s (one process on the card, "
        f"the same run: {one_steps_s:.2f}); launches per rank "
        f"{[r[1]['launches'] for r in dres]}")
    log(f"[deck processors 2 1 1 n={DOMAIN_N}, 2 gloo ranks] "
        f"{got['driver']}; {got['pair_path']}; launches "
        f"{json.dumps(got['launches'])}; final state bit for bit one "
        f"process's: {same}")
    if (got["driver"] != "DomainSimulation" or not same
            or not got["launches"].get("ucgld_pair")):
        bad.append("the atom decomposition deck")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(one, ignore_errors=True)
    log(f"[phase 27] {time.perf_counter() - t0:.1f} s (slabs "
        f"{t_slabs:.1f} s)")
    if bad:
        raise RuntimeError("the rest of the spatial drivers: "
                           + "; ".join(bad))
    out = {}
    for key, h in holds.items():
        name, var = key[:-1].split("[")
        n = m["launches"].get(name, {}).get(var, 0)
        if not n:
            raise RuntimeError(f"molecular {key} launched no time in its "
                               f"slab run: {m['launches']}")
        out[key + "@molecular@slab"] = (h, n, name)
    return out


def mixed_bank(device: str):
    """(bank, tp) of a 2-type Bethe system: plain type 1 and 2-state type
    2 (formal types 2, 3), 7 soft tables."""
    from lammps_ucg_dev_tpu_torch.flagship import soft_table
    from lammps_ucg_dev_tpu_torch.io.state_settings import parse_state_settings
    from lammps_ucg_dev_tpu_torch.models.typemap import TablePairBuilder

    st = parse_state_settings("2 3 2\n1 1\n2 2\n2 3\n0.0 0.4\n", "bethe")
    b = TablePairBuilder("linear", 1200, st)
    b.pair_coeff(1, 1, 1, 1, [(soft_table(1.0, 1500), 2.5)])
    b.pair_coeff(1, 2, 1, 2, [(soft_table(e, 1500), 2.5) for e in (0.8, 0.5)])
    b.pair_coeff(2, 2, 2, 2, [(soft_table(e, 1500), 2.5)
                              for e in (0.9, 0.55, 0.55, 0.3)])
    return b.build(device=device)


def mixed_bethe(device: str, n: int = 8192):
    """The :func:`mixed_bank` system at ρ 0.6 with assigned priors:
    (state, params, spec) for K2's multi-type variants."""
    import numpy as np

    from lammps_ucg_dev_tpu_torch.core.state import Box, SimState
    from lammps_ucg_dev_tpu_torch.models import pair_bethe
    from lammps_ucg_dev_tpu_torch.ops.kernel_select import select_pair_kernel

    rng = np.random.default_rng(5)
    bank, tp = mixed_bank(device)
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
