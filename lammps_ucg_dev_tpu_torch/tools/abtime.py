"""Same-call timing of the tile-walk kernels (K1, K7, K2, K5, K6, K8) built
from several source trees, on one set of inputs, in turns.

    python -m lammps_ucg_dev_tpu_torch.tools.abtime TAG=CSRC [TAG=CSRC ...]
        [--n 1048576] [--reps 20] [--only K5,K6]

Each CSRC is a directory holding ``ucgld_pair.cu``, ``density_cv.cu``,
``ucgld_ablation.cu``, ``bethe_pair.cu``, ``ucgld_cluster.cu`` and their
headers (this package's ``csrc/``, or a copy of another tree's), optionally
followed by ``:FLAG,FLAG``, extra nvcc flags for that tag.  The sources of
the kernels timed (``--only``, default all) are built for every tag at
once with ``cuda_lib.NVCC_FLAGS`` into ``_build/ab/``; this package's
wrappers then launch each tag's build in turn on the same inputs: K1 in
its three variants and K7 at L0–L4 on the flagship fluid, K2 fast and full
on the Bethe system (config 3) after setup, K5 and K6 fast and full (the
paths' g-form, ``mder``) on the P3 and P4 systems after setup, and K8 on
the cluster path's inputs, all at ``--n`` beads.  The builds must share
this tree's C entry points up to the stream (K8's occupied list and the
others' periodic flags come after it, so builds from before them ignore
them).

Prints the card's name and power limit and each build's ptxas lines, then
one line per kernel: each tag's mean ms over its two turns (the tags in
order, then reversed; ``--reps`` launches a turn, CUDA events) and the
largest difference of each tag's output from the first tag's, relative to
the first tag's largest magnitude.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import subprocess
from pathlib import Path

import torch

from lammps_ucg_dev_tpu_torch import flagship
from lammps_ucg_dev_tpu_torch.ops import clusters, cuda_lib
from lammps_ucg_dev_tpu_torch.ops import hopper_ablation as ha
from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
from lammps_ucg_dev_tpu_torch.ops import hopper_cluster as hc
from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
from lammps_ucg_dev_tpu_torch.tools.kbench import staged
from lammps_ucg_dev_tpu_torch.tools.timing import card, cuda_ms

P, I = ctypes.c_void_p, ctypes.c_int
# (kernels, wrapper module, source, C entry point, its argument types)
ENTRIES = ((("K1",), hp, "ucgld_pair", "ucgld_pair_launch",
            [P] * 8 + [I] * 10 + [P, I]),
           (("K5", "K6"), hcv, "density_cv", "density_cv_launch",
            [P] * 8 + [I] * 10 + [P, I]),
           (("K7",), ha, "ucgld_ablation", "ucgld_ablation_launch",
            [P] * 7 + [I] * 7 + [P]),
           (("K2",), hb, "bethe_pair", "bethe_pair_launch",
            [P] * 8 + [I] * 12 + [P, I]),
           (("K8",), hc, "ucgld_cluster", "ucgld_cluster_launch",
            [P] * 6 + [I] * 3 + [P] * 2 + [I]))


def build(tags: dict, only: set) -> dict:
    """{tag: {source: CDLL}} from {tag: (csrc directory, extra flags)}, the
    sources of the kernels in ``only``: one nvcc per source and tag, all
    started together."""
    out = cuda_lib.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags) in tags.items():
        for kernels, _, name, _, _ in ENTRIES:
            if not only & set(kernels):
                continue
            so = out / f"{name}-{tag}.so"
            cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o",
                   str(so), str(Path(src) / f"{name}.cu")]
            procs[tag, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {tag: {} for tag in tags}
    for (tag, name), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{log}")
        for line in cuda_lib.ptxas_summary(log):
            print(f"{tag} ptxas: {line}", flush=True)
        libs[tag][name] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def launching(libs: dict):
    """The wrappers launch the kernels of ``libs`` ({source: CDLL})."""
    saved = {}
    for _, mod, name, entry, argtypes in ENTRIES:
        if name not in libs:
            continue
        fn = getattr(libs[name], entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        saved[mod] = mod._lib
        mod._lib = (lambda fn=fn: fn)
    try:
        yield
    finally:
        for mod, lib in saved.items():
            mod._lib = lib


def compare(label: str, call, libs: dict, reps: int) -> None:
    tags = list(libs)
    ms = {t: [] for t in tags}
    outs = {}
    for t in tags + tags[::-1]:
        with launching(libs[t]):
            ms[t].append(cuda_ms(call, reps, warmup=3))
            out = call()
        outs[t] = out[0] if isinstance(out, tuple) else out
    torch.cuda.synchronize()
    ref = outs[tags[0]]
    scale = max(float(ref.abs().max()), 1e-30)
    times = "  ".join(f"{t} {sum(v) / len(v):.4f} "
                      f"({'/'.join(f'{x:.4f}' for x in v)})"
                      for t, v in ms.items())
    diffs = "; ".join(
        f"{t} rel {float((outs[t] - ref).abs().max()) / scale:.1e}"
        for t in tags[1:])
    print(f"{label:14s} {times}  {diffs}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tags", nargs="+", help="TAG=CSRC[:FLAG,FLAG]")
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="K1,K7,K2,K5,K6,K8",
                    help="comma-separated kernels to time")
    a = ap.parse_args(argv)
    only = set(a.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("abtime: no CUDA device")
    tags = {}
    for arg in a.tags:
        tag, _, rest = arg.partition("=")
        src, _, flags = rest.partition(":")
        tags[tag] = (src, [f for f in flags.split(",") if f])
    libs = build(tags, only)
    print(card(), flush=True)

    if only & {"K1", "K7"}:
        sim = flagship.build_sim(n=a.n, reneigh_every=20)
        state, cl = staged(sim)
        p = sim.pair_params
        variants = ((False, False), (False, True), (True, True))
        for observe, scores in variants if "K1" in only else ():
            args, kw = hp.kernel_inputs(state, cl, p, p.cheb, observe,
                                        scores)
            compare(f"K1 {hp.variant(observe, scores)}",
                    lambda: hp.ucgld_pair(*args, **kw), libs, a.reps)
        args, kw = ha.kernel_inputs(state, cl, p, p.cheb)
        for level in ha.LEVELS if "K7" in only else ():
            compare(f"K7 L{level}", lambda: ha.ucgld_ablation(*args, **kw,
                                                              level=level),
                    libs, a.reps)
        del sim, state, cl

    if "K2" in only:
        sim = flagship.build_bethe_sim(n=a.n)
        sim.setup((0, 10))
        state, cl = staged(sim)
        p = sim.pair_params
        for observe in (False, True):
            args, kw = hb.kernel_inputs(state, cl, p, p.cheb, observe)
            compare(f"K2 {hb.variant(observe)}",
                    lambda: hb.bethe_pair(*args, **kw), libs, a.reps)
        del sim, state, cl

    density = (("P3", flagship.build_density_sim),
               ("P4", flagship.build_rleucg_sim))
    for style, builder in density if only & {"K5", "K6"} else ():
        sim = builder(n=a.n)
        sim.setup((0, 10))
        state, cl = staged(sim)
        p = sim.pair_params
        cutsq = (p.tp.cutsq if isinstance(p, hd.BetheDensityParams)
                 else p.cutsq)[1, 1]
        if "K5" in only:
            args, kw = hcv.cv_inputs(state, cl, p.cv_rad, cutsq,
                                     p.bank.innersq[0], None)
            compare(f"{style} K5", lambda: hcv.cv_rho(*args, **kw), libs,
                    a.reps)
        w = torch.randn(state.n_atoms, device=state.device,
                        generator=torch.Generator(
                            device=state.device).manual_seed(3))
        args, kw = hcv.cv_inputs(state, cl, p.cv_rad, cutsq,
                                 p.bank.innersq[0], w)
        for observe in (False, True) if "K6" in only else ():
            compare(f"{style} K6 {'full' if observe else 'fast'}",
                    lambda: hcv.cv_force(*args, **kw, gform="mder",
                                         observe=observe), libs, a.reps)
        del sim, state, cl

    if "K8" not in only:
        return 0
    sim = flagship.build_cluster_sim(n=a.n)
    state = sim.state
    state = dataclasses.replace(state, x=state.box.wrap(state.x))
    cl = clusters.build(state.x, state.box, sim.nbr_spec)
    args, kw = hc.kernel_inputs(state, cl, sim.pair_params,
                                sim.pair_params.cheb)
    compare("K8 full", lambda: hc.ucgld_cluster(*args, **kw,
                                                occupied=cl.occupied),
            libs, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
