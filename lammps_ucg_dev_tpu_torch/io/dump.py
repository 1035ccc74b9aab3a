"""Dump (trajectory) writer/reader with the UCG per-atom columns (port of
``lammps_ucg_dev_tpu/io/dump.py``; the same bytes for the same state).

Writer mirrors the patched ``dump_custom`` (dump_custom.cpp:1672-1690,
3552-3575): columns may include ``ucgstate``, ``ucgl``, ``ucgp`` alongside the
stock id/mol/type/q/x/y/z/... set, with ``dump_modify thresh``-style row
filters.  The reference's threshold dispatch for ``ucgp`` is dead code
(its enum branch repeats UCGSTATE, dump_custom.cpp:1199-1204 — catalogued
deviation); here all three UCG attributes threshold correctly.

A frame takes one host copy of the fields it names: the columns are
stacked in float64 on the state's device (exact for the int32 and float32
fields) and moved to the host at once, so a frame of 2^20 beads costs one
device→host transfer, not one per column.  Thresholds compare in each
field's own dtype, as numpy does on the JAX package's host arrays.  Frames
are written in storage order with their ids.

Reader mirrors the patched ``read_dump``/``reader_native``
(read_dump.cpp:823-909, reader_native.cpp:423-433): snapshots are matched by
atom id and can re-ingest ``ucgstate/ucgl/ucgp`` for rerun-style state
assignment.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.io.data import host

_OPS = {
    "<": np.less, "<=": np.less_equal, ">": np.greater,
    ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal,
}

# dump column -> (SimState field, component or None)
_FIELDS = {
    "id": ("tag", None), "mol": ("mol", None), "type": ("typ", None),
    "q": ("q", None), "x": ("x", 0), "y": ("x", 1), "z": ("x", 2),
    "vx": ("v", 0), "vy": ("v", 1), "vz": ("v", 2),
    "ix": ("image", 0), "iy": ("image", 1), "iz": ("image", 2),
    "ucgstate": ("ucgstate", None), "ucgl": ("ucgl", None),
    "ucgp": ("ucgp", None), "ucgvl": ("ucgvl", None),
    "ucgml": ("ucgml", None),
}
_INT_COLS = {"id", "mol", "type", "ix", "iy", "iz", "ucgstate"}


def frame_columns(state, names) -> tuple[dict, dict]:
    """The named dump columns with one device→host copy.  Returns
    ({name: float64 column}, {name: column in its field's dtype})."""
    names = list(dict.fromkeys(names))
    cols, dtypes = [], []
    for name in names:
        if name not in _FIELDS:
            raise ValueError(f"unknown dump column {name!r}")
        field, comp = _FIELDS[name]
        t = getattr(state, field)
        cols.append(t if comp is None else t[:, comp])
        dtypes.append(torch.empty((), dtype=t.dtype).numpy().dtype)
    block = torch.stack([c.to(torch.float64) for c in cols]).cpu().numpy()
    as64 = {name: block[i] for i, name in enumerate(names)}
    native = {name: block[i].astype(dtypes[i])
              for i, name in enumerate(names)}
    return as64, native


@dataclasses.dataclass
class DumpWriter:
    """lammpstrj-format custom dump with optional row thresholds.
    ``frames`` and ``native_frames`` count the frames written and those the
    native writer wrote."""

    path: str
    columns: tuple = ("id", "mol", "type", "x", "y", "z",
                      "ucgstate", "ucgl", "ucgp")
    thresholds: list = dataclasses.field(default_factory=list)
    append: bool = False
    frames: int = 0
    native_frames: int = 0

    def __post_init__(self):
        if not self.append:
            open(self.path, "w").close()

    def modify_thresh(self, attr: str, op: str, value: float):
        """dump_modify thresh <attr> <op> <value> (dump_custom.cpp:2150-2155)."""
        if op not in _OPS:
            raise ValueError(f"unknown threshold operator {op!r}")
        self.thresholds.append((attr, op, float(value)))

    def write(self, state, step: int | None = None) -> bool:
        """Append one frame; returns True when the native writer wrote it."""
        from lammps_ucg_dev_tpu_torch.runtime import native

        as64, typed = frame_columns(
            state, list(self.columns) + [a for a, _, _ in self.thresholds])
        n = state.x.shape[0]
        keep = np.ones(n, dtype=bool)
        for attr, op, val in self.thresholds:
            keep &= _OPS[op](typed[attr], val)
        lo = host(state.box.lo)
        hi = host(state.box.hi)
        per = state.box.periodic
        step = int(state.step) if step is None else step
        bflags = " ".join("pp" if p else "ff" for p in per)
        self.frames += 1

        int_mask = [1 if c in _INT_COLS else 0 for c in self.columns]
        block = np.stack([as64[c][keep] for c in self.columns])
        if native.write_dump_frame(
                self.path, append=True, step=step, box_lo=lo, box_hi=hi,
                bounds=bflags, header=" ".join(self.columns), block=block,
                int_mask=int_mask):
            self.native_frames += 1
            return True

        cols = [typed[c][keep] for c in self.columns]
        with open(self.path, "a") as fh:
            fh.write("ITEM: TIMESTEP\n%d\n" % step)
            fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % int(keep.sum()))
            fh.write(f"ITEM: BOX BOUNDS {bflags}\n")
            for d in range(3):
                fh.write(f"{lo[d]:.15g} {hi[d]:.15g}\n")
            fh.write("ITEM: ATOMS " + " ".join(self.columns) + "\n")
            for row in zip(*cols):
                fh.write(" ".join(
                    str(int(v)) if isinstance(v, (np.integer,)) else f"{v:.9g}"
                    for v in row) + "\n")
        return False


@dataclasses.dataclass
class Snapshot:
    step: int
    n_atoms: int
    box_lo: np.ndarray
    box_hi: np.ndarray
    fields: dict      # column name -> array (file row order)

    def by_id(self, name: str, n_total: int, default=0.0):
        """Scatter a column into id-indexed order (read_dump matching)."""
        out = np.full(n_total, default, dtype=float)
        ids = self.fields["id"].astype(int)
        out[ids - 1] = self.fields[name]
        return out


def _rows(lines, start: int, n: int, ncols: int) -> np.ndarray:
    """n rows of numbers: the native parser when it loads and every row
    has ``ncols`` fields, else Python's float()."""
    from lammps_ucg_dev_tpu_torch.runtime import native

    if n and ncols:
        out = native.parse_rows("".join(lines[start:start + n]).encode(), n,
                                ncols)
        if out is not None and np.all(out[1] == ncols):
            return out[0]
    return np.asarray(
        [[float(v) for v in lines[start + k].split()] for k in range(n)])


def read_dump(path: str):
    """Parse all snapshots of a lammpstrj file."""
    snaps = []
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("ITEM: TIMESTEP"):
            i += 1
            continue
        step = int(lines[i + 1])
        n = int(lines[i + 3])
        lo = np.zeros(3)
        hi = np.zeros(3)
        for d in range(3):
            toks = lines[i + 5 + d].split()
            lo[d], hi[d] = float(toks[0]), float(toks[1])
        header = lines[i + 8].split()[2:]
        rows = _rows(lines, i + 9, n, len(header))
        fields = {name: rows[:, c] if n else np.zeros(0)
                  for c, name in enumerate(header)}
        snaps.append(Snapshot(step, n, lo, hi, fields))
        i += 9 + n
    return snaps


def apply_snapshot(state, snap: Snapshot, fields=("x", "y", "z"),
                   wrapped: bool = True):
    """read_dump/rerun semantics: overwrite state arrays from a snapshot,
    matching atoms by id (read_dump.cpp:823-909).  ``fields`` may include
    x/y/z, vx/vy/vz, ucgstate/ucgl/ucgp.  The new arrays land on the
    state's device in its dtypes."""
    n = state.n_atoms
    dev = state.device
    upd = {}
    get = lambda f: snap.by_id(f, n)

    def put(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=dev)

    if any(f in fields for f in ("x", "y", "z")):
        x = host(state.x).copy()
        for d, f in enumerate(("x", "y", "z")):
            if f in fields:
                x[:, d] = get(f)
        upd["x"] = put(x, state.x)
    if any(f in fields for f in ("vx", "vy", "vz")):
        v = host(state.v).copy()
        for d, f in enumerate(("vx", "vy", "vz")):
            if f in fields:
                v[:, d] = get(f)
        upd["v"] = put(v, state.v)
    for f in ("ucgl", "ucgp", "ucgvl", "ucgml"):
        if f in fields:
            upd[f] = put(get(f), state.ucgl)
    if "ucgstate" in fields:
        upd["ucgstate"] = put(get("ucgstate").astype(int), state.ucgstate)
    if "type" in fields:
        upd["typ"] = put(get("type").astype(int), state.typ)
    return dataclasses.replace(state, **upd)
