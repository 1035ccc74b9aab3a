"""How ``correct`` is decided: the numbers that set what the timed path
produced beside the plain reference, and their limits.

For one block of the window, drawn from the seed, the reference starts
from the program's state at the block's start (positions, velocities,
lambda and its velocity, the force carry, the generator's state) and
follows the block in float64 with its own pair list, tables and
integrator.  At the block's end it compares positions, velocities, lambda,
its velocity, the posterior, the forces on x and on lambda and the pair
energy.  With ``fix cluster_switch``, one event of the window, drawn from
the seed, is followed from the program's positions and types and its
accept draws, and the clusters and the new types are compared.  On slabs,
each rank's rows are gathered by the benchmark itself, and the program's
own end-of-run gather is compared with the benchmark's gather of the same
rows.

Each gap is a share of what the block moved or of the largest value, so
a block that leaves its state unchanged reads 1.  A gap is the largest over
the finite entries; the program's entries that are not finite are counted
apart (``nonfinite``, limit 0).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ucg_bench.reference import md, pair, switch, tables
from ucg_bench.reference.pairs import min_image

BENCH_DIR = Path(__file__).resolve().parent


def limits(config: str) -> dict:
    with open(BENCH_DIR / "configs" / config / "limits.json") as fh:
        return json.load(fh)["limits"]


def _amax(t) -> float:
    """The largest finite magnitude (0 where none); the non-finite entries
    are counted apart (``nonfinite``)."""
    t = t.abs()
    t = t[torch.isfinite(t)]
    return float(t.max()) if t.numel() else 0.0


def _rel(a, b, scale):
    s = float(scale)
    return _amax(a - b) / s if s > 0 else float("inf")


def _keep(d: dict, mask) -> dict:
    return {k: (v[mask] if torch.is_tensor(v) and v.dim() > 0
                and v.shape[0] == mask.shape[0] else v)
            for k, v in d.items()}


def block_gaps(prog_out: dict, ref: dict, inp: dict, L) -> dict:
    """The gaps of one block: ``prog_out`` the program's state and forces
    at its end, ``ref`` the reference's, ``inp`` the state at its start
    (all float64, tag order).  Beads the reference leaves undecided (a
    lambda at a wall or at the state threshold, and the beads around it)
    are not judged."""
    keep = ~ref["undecided"]
    prog_out, ref, inp = _keep(prog_out, keep), _keep(ref, keep), _keep(
        inp, keep)
    Lt = torch.as_tensor(L, dtype=torch.float64, device=inp["x"].device)
    moved_x = min_image(ref["x"] - inp["x"], Lt).abs().max()
    g = {"x_gap": _amax(min_image(prog_out["x"] - ref["x"], Lt))
         / float(moved_x)}
    for name, key in (("v_gap", "v"), ("lam_gap", "lam"),
                      ("vlam_gap", "vlam")):
        g[name] = _rel(prog_out[key], ref[key], (ref[key] - inp[key]).abs()
                       .max())
    g["f_gap"] = _rel(prog_out["f"], ref["f"], ref["f"].abs().max())
    g["lamforce_gap"] = _rel(prog_out["lamforce"], ref["lamforce"],
                             ref["lamforce"].abs().max())
    g["pe_gap"] = abs(float(prog_out["pe"]) - float(ref["pe"])) / abs(
        float(ref["pe"]))
    g["ucgp_gap"] = _amax(prog_out["ucgp"] - ref["ucgp"])
    g["nonfinite"] = sum(int((~torch.isfinite(prog_out[k])).sum()) for k in
                         ("x", "v", "lam", "vlam", "f", "lamforce", "ucgp",
                          "pe"))
    g["undecided"] = int((~keep).sum())
    return g


def reference_block(ph, inp: dict, gen_state, nsteps: int, L, dtype,
                    draw_dtype=torch.float32):
    """The reference's end of the block from ``inp`` in ``dtype``
    (float64 for the reference, bfloat16 for the control), as float64;
    the uniforms are drawn in ``draw_dtype``, the program's."""
    dev = inp["x"].device
    bank = tables.Bank.build(ph.tables, dtype, dev)
    style = pair.make(ph, bank, ph.T_start, dtype, dev)
    out = md.follow_block(ph, style, inp, gen_state, nsteps, L, dtype,
                          draw_dtype)
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in out.items()}


def event_gaps(ph, ev_in: dict, ev_out: dict, L, dtype=torch.float64):
    """Molecules of the seed's cluster, and beads' new types, that differ
    from the reference's among the molecules the reference decides."""
    typ, in_cluster, decided = switch.event(
        ph.switch, ev_in["x"].double(), ev_in["typ"], ev_in["mol"],
        ev_in["u"], L, dtype)
    prog_in = ev_out["in_cluster"].to(in_cluster.device)
    m = min(len(prog_in), len(in_cluster))
    bad_c = (prog_in[:m] != in_cluster[:m]) & decided[:m]
    mol = ev_in["mol"].long()
    bead_ok = decided[mol]
    bad_t = (ev_out["typ"].long() != typ) & bead_ok
    return {"event_cluster_mismatch": int(bad_c.sum()),
            "event_type_mismatch": int(bad_t.sum()),
            "event_undecided": int((~decided).sum())}


def judge(numbers: dict, lim: dict):
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit; a number that is not finite fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        if name not in lim:
            continue
        good = np.isfinite(value) and value <= lim[name]
        ok &= bool(good)
        rows.append((name, value, lim[name]))
    return ok, rows


def tag_sorted(d: dict) -> dict:
    order = torch.argsort(d["tag"].long())
    return {k: (v[order] if torch.is_tensor(v) and v.dim() > 0
                and v.shape[0] == order.shape[0] else v)
            for k, v in d.items()}


def as_double(d: dict) -> dict:
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in d.items()}
