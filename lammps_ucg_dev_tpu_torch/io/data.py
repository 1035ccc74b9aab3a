"""LAMMPS data-file reader/writer for ``atom_style ucg`` (port of
``lammps_ucg_dev_tpu/io/data.py``; numpy on the host, the same bytes).

Field layout follows AtomVecUCG (atom_vec_ucg.cpp:87-90):
    Atoms:      id molecule type q x y z ucgstate ucgl ucgml [ix iy iz]
    Velocities: id vx vy vz ucgvl
plus the standard header (counts, types, box bounds) and Masses section.
``read_data`` also accepts plain ``full``/``molecular``/``atomic`` layouts so
non-UCG decks load (UCG fields take their data_atom_post defaults:
λ clamped to [0,1], state to {0,1}, ucgp = -1 sentinel,
atom_vec_ucg.cpp:145-170).

Bond/angle/dihedral/improper sections are parsed and retained for topology
completeness (the reference atom style allows them; its pair styles ignore
them).  A tilted box (``xy xz yz``) is parsed into ``box_tilt`` and
written back from the box's ``tilt``.  ``write_data`` takes the port's
SimState (tensors on any device).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataFile:
    n_atoms: int = 0
    n_types: int = 0
    box_lo: np.ndarray = None
    box_hi: np.ndarray = None
    box_tilt: np.ndarray = None      # (xy, xz, yz) or None (orthogonal)
    masses: np.ndarray = None          # (ntypes+1,)
    ids: np.ndarray = None
    mol: np.ndarray = None
    typ: np.ndarray = None
    q: np.ndarray = None
    x: np.ndarray = None
    image: np.ndarray = None
    v: np.ndarray = None
    ucgstate: np.ndarray = None
    ucgl: np.ndarray = None
    ucgml: np.ndarray = None
    ucgvl: np.ndarray = None
    bonds: np.ndarray = None           # (nb, 4): id type a1 a2
    angles: np.ndarray = None
    dihedrals: np.ndarray = None
    impropers: np.ndarray = None
    atom_style: str = "ucg"


_SECTION_NAMES = {
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
    "Dihedral Coeffs", "Improper Coeffs",
}


def host(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _strip(line: str) -> str:
    return line.split("#")[0].strip()


def read_data(path: str, atom_style: str = "ucg") -> DataFile:
    with open(path) as fh:
        lines = fh.readlines()

    df = DataFile(atom_style=atom_style)
    df.box_lo = np.zeros(3)
    df.box_hi = np.ones(3)
    counts = {}

    # ---- header (everything before the first section keyword) -------------
    i = 1  # first line is a comment/title
    while i < len(lines):
        s = _strip(lines[i])
        first_words = s.split("#")[0].strip()
        section = None
        for name in _SECTION_NAMES:
            if first_words == name or first_words.startswith(name + " "):
                section = name
                break
        if section:
            break
        if s:
            toks = s.split()
            if s.endswith("atoms"):
                df.n_atoms = int(toks[0])
            elif s.endswith("atom types"):
                df.n_types = int(toks[0])
            elif s.endswith(("bonds", "angles", "dihedrals", "impropers",
                             "bond types", "angle types", "dihedral types",
                             "improper types")):
                counts[" ".join(toks[1:])] = int(toks[0])
            elif s.endswith("xlo xhi"):
                df.box_lo[0], df.box_hi[0] = float(toks[0]), float(toks[1])
            elif s.endswith("ylo yhi"):
                df.box_lo[1], df.box_hi[1] = float(toks[0]), float(toks[1])
            elif s.endswith("zlo zhi"):
                df.box_lo[2], df.box_hi[2] = float(toks[0]), float(toks[1])
            elif s.endswith("xy xz yz"):
                df.box_tilt = np.array([float(toks[0]), float(toks[1]),
                                        float(toks[2])])
        i += 1

    n = df.n_atoms
    df.masses = np.ones(df.n_types + 1)
    df.masses[0] = 0.0   # index 0 unused (types are 1-based)
    df.ids = np.arange(1, n + 1, dtype=np.int64)
    df.mol = np.zeros(n, np.int64)
    df.typ = np.ones(n, np.int64)
    df.q = np.zeros(n)
    df.x = np.zeros((n, 3))
    df.image = np.zeros((n, 3), np.int64)
    df.v = np.zeros((n, 3))
    df.ucgstate = np.zeros(n, np.int64)
    df.ucgl = np.zeros(n)
    df.ucgml = np.ones(n)
    df.ucgvl = np.zeros(n)

    def read_section(start: int, nrows: int, maxcols: int = 16):
        """Parse nrows numeric lines into a (nrows, maxcols) float matrix +
        per-row field counts.  Uses the native C++ parser when available
        (runtime/native/ucgio.cpp), pure Python otherwise.  Returns
        (rows, ncols, next_line_index)."""
        from lammps_ucg_dev_tpu_torch.runtime import native

        blob = "\n".join(lines[start:start + nrows + 64])
        out = native.parse_rows(blob.encode(), nrows, maxcols)
        # advance the line cursor past nrows non-blank lines either way
        k = start
        taken = 0
        py_rows = []
        while taken < nrows and k < len(lines):
            s = _strip(lines[k])
            if s:
                taken += 1
                if out is None:
                    py_rows.append(s.split())
            k += 1
        if out is not None:
            return out[0], out[1], k
        rows = np.zeros((nrows, maxcols))
        ncols = np.zeros(nrows, np.int32)
        for r, toks in enumerate(py_rows):
            vals = [float(v) for v in toks[:maxcols]]
            rows[r, : len(vals)] = vals
            ncols[r] = len(vals)
        return rows, ncols, k

    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        name = s
        if name == "Masses":
            rows, _, i = read_section(i + 1, df.n_types, 2)
            df.masses[rows[:, 0].astype(int)] = rows[:, 1]
        elif name.startswith("Atoms"):
            rows, ncols, i = read_section(i + 1, n, 16)
            k = rows[:, 0].astype(np.int64) - 1          # by atom id
            df.ids[k] = rows[:, 0].astype(np.int64)
            if atom_style in ("ucg", "full", "molecular"):
                df.mol[k] = rows[:, 1].astype(np.int64)
                df.typ[k] = rows[:, 2].astype(np.int64)
                c = 3
                if atom_style in ("ucg", "full"):
                    df.q[k] = rows[:, 3]
                    c = 4
            else:  # atomic
                df.typ[k] = rows[:, 1].astype(np.int64)
                c = 2
            df.x[k] = rows[:, c:c + 3]
            c += 3
            if atom_style == "ucg":
                df.ucgstate[k] = rows[:, c].astype(np.int64)
                df.ucgl[k] = rows[:, c + 1]
                df.ucgml[k] = rows[:, c + 2]
                c += 3
            has_img = ncols >= c + 3
            if np.any(has_img):
                df.image[k[has_img]] = rows[has_img, c:c + 3].astype(np.int64)
        elif name == "Velocities":
            rows, ncols, i = read_section(i + 1, n, 8)
            k = rows[:, 0].astype(np.int64) - 1
            df.v[k] = rows[:, 1:4]
            if atom_style == "ucg":
                has_vl = ncols >= 5
                df.ucgvl[k[has_vl]] = rows[has_vl, 4]
        elif name in ("Bonds", "Angles", "Dihedrals", "Impropers"):
            width = {"Bonds": 4, "Angles": 5, "Dihedrals": 6,
                     "Impropers": 6}[name]
            nrows = counts.get(name.lower(), 0)
            rows, ncols, i = read_section(i + 1, nrows, width)
            arr = (np.round(rows[:, :width]).astype(np.int64)
                   if nrows else np.zeros((0, width), np.int64))
            setattr(df, name.lower(), arr)
        else:
            # unknown/coeff section: skip until next blank-line-delimited block
            i += 1
            while i < len(lines) and _strip(lines[i]):
                i += 1
        i += 1

    # data_atom_post clamps (atom_vec_ucg.cpp:145-170)
    df.ucgl = np.clip(df.ucgl, 0.0, 1.0)
    df.ucgstate = np.clip(df.ucgstate, 0, 1)
    return df


def write_data(path: str, state, system, comment: str = "",
               topology: "DataFile | None" = None) -> None:
    """Write a ucg-style data file from a SimState (+ System for masses).

    ``topology``: the parsed :class:`DataFile` whose bond/angle/dihedral/
    improper sections should round-trip (LAMMPS ``write_data`` re-emits the
    molecular topology; atom tags are stable, so the original rows stay
    valid)."""
    x = host(state.x)
    v = host(state.v)
    n = x.shape[0]
    lo = host(state.box.lo)
    hi = host(state.box.hi)
    tilt = state.box.tilt
    topo_rows = []
    if topology is not None:
        for name, rows in (("Bonds", topology.bonds),
                           ("Angles", topology.angles),
                           ("Dihedrals", topology.dihedrals),
                           ("Impropers", topology.impropers)):
            if rows is not None and len(rows):
                topo_rows.append((name, np.asarray(rows, np.int64)))
    with open(path, "w") as fh:
        fh.write(f"LAMMPS data file via lammps_ucg_dev_tpu {comment}\n\n")
        fh.write(f"{n} atoms\n{system.ntypes} atom types\n")
        for name, rows in topo_rows:
            kind = name.lower()
            fh.write(f"{len(rows)} {kind}\n"
                     f"{int(rows[:, 1].max())} {kind[:-1]} types\n")
        fh.write("\n")
        fh.write(f"{lo[0]:.15g} {hi[0]:.15g} xlo xhi\n")
        fh.write(f"{lo[1]:.15g} {hi[1]:.15g} ylo yhi\n")
        fh.write(f"{lo[2]:.15g} {hi[2]:.15g} zlo zhi\n")
        if tilt is not None:
            t = host(tilt)
            fh.write(f"{t[0]:.15g} {t[1]:.15g} {t[2]:.15g} xy xz yz\n")
        fh.write("\n")
        fh.write("Masses\n\n")
        for t in range(1, system.ntypes + 1):
            fh.write(f"{t} {system.masses[t]:.15g}\n")
        fh.write("\nAtoms # ucg\n\n")
        tag = host(state.tag)
        mol = host(state.mol)
        typ = host(state.typ)
        q = host(state.q)
        us = host(state.ucgstate)
        ul = host(state.ucgl)
        um = host(state.ucgml)
        im = host(state.image)
        for k in range(n):
            fh.write(
                f"{tag[k]} {mol[k]} {typ[k]} {q[k]:.15g} "
                f"{x[k, 0]:.15g} {x[k, 1]:.15g} {x[k, 2]:.15g} "
                f"{us[k]} {ul[k]:.15g} {um[k]:.15g} "
                f"{im[k, 0]} {im[k, 1]} {im[k, 2]}\n"
            )
        fh.write("\nVelocities\n\n")
        uvl = host(state.ucgvl)
        for k in range(n):
            fh.write(
                f"{tag[k]} {v[k, 0]:.15g} {v[k, 1]:.15g} {v[k, 2]:.15g} "
                f"{uvl[k]:.15g}\n"
            )
        for name, rows in topo_rows:
            fh.write(f"\n{name}\n\n")
            for r in rows:
                fh.write(" ".join(str(int(c)) for c in r) + "\n")
