"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries land in ``lammps_ucg_dev_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source text and the flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


# dlopen is process-wide, so the loaded libraries are too
_LOADED: dict[str, NativeLib] = {}


def load(name: str) -> NativeLib:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    log_path = BUILD_DIR / f"{name}-{key}.log"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp.so"
        t0 = time.perf_counter()
        r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{r.stderr}")
        log_path.write_text(r.stdout + r.stderr)
        os.replace(tmp, so)       # atomic: a concurrent loader sees all or none
    log = log_path.read_text() if log_path.exists() else ""
    nl = NativeLib(lib=ctypes.CDLL(str(so)), path=so, build_seconds=seconds,
                   log=log)
    _LOADED[name] = nl
    return nl
