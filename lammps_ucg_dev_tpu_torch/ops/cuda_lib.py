"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries land in ``lammps_ucg_dev_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source text, every shared header
(``csrc/*.cuh``) and the flags, so a changed source or header rebuilds and
an unchanged one loads at once.  Nothing here runs at import time: the first
kernel launch builds.  :func:`build` starts one ``nvcc`` per source, all at
once, for callers that want every kernel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class NativeLib:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an existing build was loaded
    log: str                 # nvcc's output (-Xptxas -v register report)


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels build only where "
                       "the CUDA toolkit is installed")


def build_key(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


# dlopen is process-wide, so the loaded libraries are too
_LOADED: dict[str, NativeLib] = {}


def _paths(name: str):
    key = build_key(name)
    return BUILD_DIR / f"{name}-{key}.so", BUILD_DIR / f"{name}-{key}.log"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, tmp path, start time) or None."""
    so, _ = _paths(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
         str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, started) -> float:
    if started is None:
        return 0.0
    proc, tmp, t0 = started
    out, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    so, log_path = _paths(name)
    log_path.write_text(out)
    os.replace(tmp, so)       # atomic: a concurrent loader sees all or none
    return seconds


def _open(name: str, seconds: float) -> NativeLib:
    so, log_path = _paths(name)
    log = log_path.read_text() if log_path.exists() else ""
    nl = NativeLib(lib=ctypes.CDLL(str(so)), path=so, build_seconds=seconds,
                   log=log)
    _LOADED[name] = nl
    return nl


def build(names) -> dict[str, NativeLib]:
    """Build (one nvcc per source, all running together) and load every
    ``csrc/<name>.cu`` of ``names``."""
    todo = [n for n in names if n not in _LOADED]
    started = {n: _start(n) for n in todo}
    try:
        seconds = {n: _finish(n, started[n]) for n in todo}
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    for n in todo:
        _open(n, seconds[n])
    return {n: _LOADED[n] for n in names}


def load(name: str) -> NativeLib:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return build([name])[name]


def ptxas_summary(log_text: str) -> list[str]:
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` report: the
    kernel with its template arguments, registers, shared memory and
    spill bytes."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I.*E)?E[vPN]", m.group(1))
            targs = re.findall(r"L[bi](\d+)E", k.group(2) or "") if k else []
            name = (k.group(1) if k else m.group(1)) + (
                f"<{','.join(targs)}>" if targs else "")
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} B "
                       f"static smem, {spill}")
            name = None
    return out
