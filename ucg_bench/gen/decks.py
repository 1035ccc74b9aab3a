"""The deck generator: one configuration's input deck, written from a seed.

A configuration (``configs/<name>/config.json`` and its deck template) and a
traffic mix (``traffic/<name>.json``) are data; this module is the one
generator that reads them.  It writes, into ``outdir``:

* the table file: soft cosine tables ``eps (1 + cos(pi r / rc))`` on a
  uniform r grid (the deck writers' ``soft_table``), one section a keyword;
* the side files the configuration lists verbatim (state settings, rates,
  contacts);
* the data file: a jittered simple-cubic lattice at the configuration's
  density, types drawn by their fractions (a bead the configuration pins
  keeps its type), lambda and the discrete state as the configuration says
  (``atom_style ucg`` rows);
* the input script, the template with the settings and the seeds filled in.

``--seed`` sets, through ``numpy.random.SeedSequence``, the lattice jitter,
the types, lambda and the states, and the integer seeds of ``velocity
create``, the Langevin fix and ``fix cluster_switch``.  The same seed writes
the same bytes; the sizes never depend on it.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_config(name: str) -> dict:
    path = BENCH_DIR / "configs" / name / "config.json"
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["_dir"] = str(path.parent)
    return cfg


def load_traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def seeds_of(seed: int) -> dict:
    """The integer seeds a deck takes, and the data generator's own."""
    ss = np.random.SeedSequence(int(seed))
    data_ss, = ss.spawn(1)
    vel, lang, switch = (int(v) for v in
                         ss.generate_state(3, dtype=np.uint32))
    return {"data": data_ss, "velocity_seed": vel + 1,
            "langevin_seed": lang + 1, "switch_seed": switch + 1}


def soft_table_text(keyword: str, eps: float, rc: float, n: int,
                    rlo: float) -> str:
    r = np.linspace(rlo, rc, n)
    e = eps * (1.0 + np.cos(np.pi * r / rc))
    f = eps * np.pi / rc * np.sin(np.pi * r / rc)
    rows = "\n".join(f"{k + 1} {r[k]:.12g} {e[k]:.12g} {f[k]:.12g}"
                     for k in range(n))
    return f"{keyword}\nN {n} R {rlo:.12g} {rc:.12g}\n\n{rows}\n\n"


def lattice(n: int, L: float, jitter: float, rng) -> np.ndarray:
    m = int(np.ceil(n ** (1 / 3)))
    a = L / m
    k = np.arange(n)
    grid = np.stack([k // (m * m), (k // m) % m, k % m], axis=1)
    return (grid + 0.5) * a + rng.normal(0.0, jitter, (n, 3))


def _data_text(cfg: dict, n: int, L: float, rng) -> str:
    at = cfg["atoms"]
    x = lattice(n, L, at["lattice_jitter"], rng)
    fr = at["type_fractions"]
    types = np.asarray(sorted(int(t) for t in fr))
    if len(types) == 1:
        typ = np.full(n, types[0])
    else:
        cum = np.cumsum([fr[str(t)] for t in types])
        typ = types[np.searchsorted(cum, rng.uniform(size=n) * cum[-1],
                                    side="right").clip(0, len(types) - 1)]
    for tag, t in at.get("pinned_types", {}).items():
        typ[int(tag) - 1] = int(t)
    if "lambda_uniform" in at:
        lam = rng.uniform(*at["lambda_uniform"], n)
    else:
        lam = np.full(n, float(at["lambda_fixed"]))
    st = ((lam > 0.5).astype(int) if at.get("state_from_lambda")
          else np.full(n, int(at["state_fixed"])))
    ml = at["lam_mass"]
    head = [at["title"], "", f"{n} atoms", f"{at['n_types']} atom types", "",
            f"0 {L:.10g} xlo xhi", f"0 {L:.10g} ylo yhi",
            f"0 {L:.10g} zlo zhi", "", "Masses", ""]
    head += [f"{t} {m}" for t, m in sorted(at["masses"].items(),
                                           key=lambda kv: int(kv[0]))]
    head += ["", "Atoms # ucg", ""]
    rows = [f"{k + 1} {k + 1} {t} 0.0 {a:.10g} {b:.10g} {c:.10g} {s} "
            f"{lm:.6f} {ml}"
            for k, (t, a, b, c, s, lm) in enumerate(zip(
                typ.tolist(), x[:, 0].tolist(), x[:, 1].tolist(),
                x[:, 2].tolist(), st.tolist(), lam.tolist()))]
    return "\n".join(head + rows) + "\n"


def write_deck(cfg: dict, traffic: dict, seed: int, outdir: str,
               n_atoms: int | None = None) -> dict:
    """Write the cell's deck into ``outdir``.  Returns the script's path, the
    seconds the writing took and the seeds.  ``n_atoms`` overrides the
    traffic's size (the CPU tests' small decks)."""
    t0 = time.perf_counter()
    os.makedirs(outdir, exist_ok=True)
    s = cfg["settings"]
    n = int(n_atoms or traffic["n_atoms"])
    seeds = seeds_of(seed)
    rng = np.random.default_rng(seeds["data"])
    L = (n / s["rho"]) ** (1 / 3)

    tb = cfg["tables"]
    with open(os.path.join(outdir, tb["file"]), "w") as fh:
        for kw, eps in tb["soft_cosine_eps"].items():
            fh.write(soft_table_text(kw, eps, s["rc"], tb["points"],
                                     tb["rlo"]))
    for name, text in cfg.get("files", {}).items():
        with open(os.path.join(outdir, name), "w") as fh:
            fh.write(text)
    with open(os.path.join(outdir, "system.data"), "w") as fh:
        fh.write(_data_text(cfg, n, L, rng))

    procs = traffic.get("processors")
    fill = dict(s, velocity_seed=seeds["velocity_seed"],
                langevin_seed=seeds["langevin_seed"],
                switch_seed=seeds["switch_seed"],
                processors=("" if not procs else
                            "processors " + " ".join(map(str, procs))))
    with open(os.path.join(cfg["_dir"], cfg["template"])) as fh:
        script = fh.read().format(**fill)
    path = os.path.join(outdir, cfg["script"])
    with open(path, "w") as fh:
        fh.write(script)
    return {"script": path, "write_s": time.perf_counter() - t0,
            "seeds": {k: v for k, v in seeds.items() if k != "data"},
            "n_atoms": n, "box_length": L}
