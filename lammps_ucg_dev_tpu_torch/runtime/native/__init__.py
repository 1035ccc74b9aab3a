"""Loader for the native C++ I/O runtime (``ucgio.cpp``; port of
``lammps_ucg_dev_tpu/runtime/native/__init__.py``).

The shared library is built with ``g++`` at its first use into
``lammps_ucg_dev_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a
hash of the source and the flags, and written through a temporary name so
that concurrent processes never load a half-written file.  Without a
toolchain :func:`get_lib` returns None and the pure-Python I/O paths run;
``get_lib() is not None`` tells which writer a dump used.  Nothing is built
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ucgio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libucgio-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """The loaded ctypes library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.ucgio_write_dump_frame.restype = ctypes.c_int
        lib.ucgio_write_dump_frame.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_char_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ucgio_parse_rows.restype = ctypes.c_long
        lib.ucgio_parse_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_dump_frame(path: str, append: bool, step: int, box_lo, box_hi,
                     bounds: str, header: str, block: np.ndarray,
                     int_mask) -> bool:
    """``block``: (ncols, natoms) float64, one row per dump column.
    Returns True when the native path wrote the frame."""
    lib = get_lib()
    if lib is None:
        return False
    block = np.ascontiguousarray(block, dtype=np.float64)
    ncols, natoms = block.shape
    lo = np.ascontiguousarray(box_lo, dtype=np.float64)
    hi = np.ascontiguousarray(box_hi, dtype=np.float64)
    im = np.ascontiguousarray(int_mask, dtype=np.int32)
    rc = lib.ucgio_write_dump_frame(
        path.encode(), int(append), int(step), natoms, ncols, _dptr(lo),
        _dptr(hi), bounds.encode(), header.encode(), _dptr(block),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return rc == 0


def parse_rows(text: bytes, nrows: int, maxcols: int):
    """Parse ``nrows`` whitespace-numeric lines from ``text`` (blank and
    comment lines skipped).  Returns (rows (nrows, maxcols) float64, ncols
    (nrows,) int32), or None without the library or when fewer rows
    parse."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.zeros((nrows, maxcols), dtype=np.float64)
    ncols = np.zeros(nrows, dtype=np.int32)
    got = lib.ucgio_parse_rows(
        text, len(text), nrows, maxcols, _dptr(rows),
        ncols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if got != nrows:
        return None
    return rows, ncols
