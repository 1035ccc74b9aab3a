"""What the reference needs of a deck, read from the files the benchmark
wrote: the pair style with its tables and state settings, the timestep,
the masses, the neighbor settings and the fixes.  The pair style and each
fix are followed by a module found by name (``pair_styles/``, ``fixes/``);
only the grammar those modules and this one read is followed, and anything
else raises, so a deck the reference cannot follow is never judged by a
guess."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ucg_bench.reference import fixes, pair
from ucg_bench.reference.tables import linear_table, read_table


@dataclasses.dataclass
class Physics:
    style: str
    tables: list                # (innersq, delta, e, f/r) per table id
    tab4: np.ndarray            # (T+1, T+1, 2, 2) table ids
    cutsq: np.ndarray           # (T+1, T+1)
    n_states: np.ndarray        # (T+1,)
    mu: np.ndarray              # (F+1,) per formal type
    formal: np.ndarray          # (T+1, 2)
    use_density: np.ndarray     # (T+1,)
    use_entropy: np.ndarray     # (T+1,)
    cv_threshold: np.ndarray    # (T+1,)
    radius: np.ndarray          # (T+1,)
    masses: np.ndarray          # (T+1,)
    dt: float
    max_cutoff: float
    skin: float                 # neighbor skin
    integrator: str             # the fix style (``fixes/``)
    integrator_args: dict
    thermostat: str | None = None   # the lambda thermostat's fix style
    T_start: float = 0.0        # its target temperature, the pairs' kT
    T_stop: float = 0.0
    t_period: float = 0.0
    ucgstate: str | None = None     # None or "ld"
    switch: dict | None = None      # fix cluster_switch


def _settings(path: str, extra):
    """The state settings file; ``extra(d, it, i, arrays)``, the pair
    style's ``read_state_extra``, reads what its dialect adds after a UCG
    type's formal-type line ``d``."""
    lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
    it = iter(lines)
    na, nf, _ = (int(v) for v in next(it).split())
    ns = np.zeros(na + 1, np.int64)
    formal = np.zeros((na + 1, 2), np.int64)
    mu = np.zeros(nf + 1)
    arr = {"use_density": np.zeros(na + 1, np.int64),
           "use_entropy": np.zeros(na + 1, np.int64),
           "cv_threshold": np.zeros(na + 1), "radius": np.zeros(na + 1)}
    for i in range(1, na + 1):
        toks = next(it).split()
        ns[i] = int(toks[1])
        if ns[i] == 1:
            formal[i] = i
            continue
        d = next(it).split()
        formal[i] = int(d[0]), int(d[1])
        if extra is not None:
            extra(d, it, i, arr)
        m = next(it).split()
        mu[formal[i, 0]], mu[formal[i, 1]] = float(m[0]), float(m[1])
    return ns, formal, mu, arr


def _masses(data_path: str) -> np.ndarray:
    with open(data_path) as fh:
        head = []
        for ln in fh:
            if ln.startswith("Atoms"):
                break
            head.append(ln.split("#")[0].strip())
    ntypes = next(int(s.split()[0]) for s in head if s.endswith("atom types"))
    k = head.index("Masses")
    m = np.zeros(ntypes + 1)
    for s in head[k + 1:]:
        if s:
            t, v = s.split()[:2]
            m[int(t)] = float(v)
    return m


def read(script_path: str) -> Physics:
    wd = os.path.dirname(script_path)
    cmds = [ln.split("#")[0].split() for ln in open(script_path)]
    cmds = [c for c in cmds if c]
    kw = {}                     # Physics fields the commands set
    coeffs = []
    data = pst = None
    for c in cmds:
        name, a = c[0], c[1:]
        if name == "pair_style":
            pst = a
            if len(a) > 4:
                raise ValueError(f"pair_style keywords {a[4:]} not followed")
        elif name == "pair_coeff":
            coeffs.append(a)
        elif name == "read_data":
            data = os.path.join(wd, a[0])
        elif name == "timestep":
            kw["dt"] = float(a[0])
        elif name == "neighbor":
            kw["skin"] = float(a[0])
        elif name == "neigh_modify":
            opts = dict(zip(a[::2], a[1::2]))
            if opts.get("check", "yes") != "yes" or set(opts) - {"every",
                                                                 "check"}:
                raise ValueError(f"neigh_modify {a} not followed")
        elif name == "fix":
            kw.update(fixes.module(a[2]).parse(a[3:], wd))
    style, tabstyle, tablength = pst[0], pst[1], int(pst[2])
    smod = pair.style_module(style)
    if tabstyle != "linear":
        raise ValueError(f"pair_style {style} {tabstyle} not followed")
    if "integrator" not in kw:
        raise ValueError("a deck with no integrator fix is not followed")
    ns, formal, mu, arr = _settings(os.path.join(wd, pst[3]),
                                    getattr(smod, "read_state_extra", None))
    T = len(ns) - 1
    F = len(mu) - 1
    tables, tabindex = [], np.full((F + 1, F + 1), -1, np.int64)
    cuts = []
    for c in coeffs:
        i, j, nsi, nsj = (int(v) for v in c[:4])
        rest = c[4:]
        k = 0
        for si in range(nsi):
            for sj in range(nsj):
                fname, key, cut = rest[3 * k], rest[3 * k + 1], float(
                    rest[3 * k + 2])
                k += 1
                r, e, f, rlo = read_table(os.path.join(wd, fname), key)
                tables.append(linear_table(r, e, f, rlo, tablength, cut))
                cuts.append(cut)
                tabindex[formal[i, si], formal[j, sj]] = len(tables) - 1
    for a in range(1, F + 1):            # the upper triangle wins
        for b in range(a, F + 1):
            if tabindex[a, b] >= 0:
                tabindex[b, a] = tabindex[a, b]
            elif tabindex[b, a] >= 0:
                tabindex[a, b] = tabindex[b, a]
    tab4 = np.zeros((T + 1, T + 1, 2, 2), np.int64)
    cutsq = np.zeros((T + 1, T + 1))
    for i in range(1, T + 1):
        for j in range(1, T + 1):
            for si in range(2):
                for sj in range(2):
                    tab4[i, j, si, sj] = tabindex[
                        formal[i, min(si, ns[i] - 1)],
                        formal[j, min(sj, ns[j] - 1)]]
            cutsq[i, j] = cuts[tab4[i, j, 0, 0]] ** 2
    return Physics(
        style=style, tables=tables, tab4=tab4, cutsq=cutsq, n_states=ns,
        mu=mu, formal=formal, **arr, masses=_masses(data),
        max_cutoff=max(cuts), **kw)
