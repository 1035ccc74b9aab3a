"""LAMMPS pair-table file reader/writer.

File grammar (matching stock-LAMMPS ``pair_style table`` files, as parsed by the
reference's embedded copy: ``PairTable_UCGLD::read_table`` /
``param_extract`` at UCG/pair_table_ucgld.cpp:897-1102):

    # comment lines
    KEYWORD                      <- section name, matched exactly
    N 1000 R 1.0 10.0 FPRIME 1.2 2.3      <- parameter line (R|RSQ|BITMAP, FPRIME optional)
    <blank>
    1 1.0  e(1.0)  f(1.0)
    2 ...

Multiple sections per file are allowed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RLINEAR, RSQ, BMP, RNONE = 1, 2, 3, 0

_EPSILONR = 1.0e-6


@dataclasses.dataclass
class RawTable:
    """Table values as read from file (before spline/binning)."""

    r: np.ndarray
    e: np.ndarray
    f: np.ndarray
    rflag: int = RNONE
    rlo: float = 0.0
    rhi: float = 0.0
    fpflag: int = 0
    fplo: float = 0.0
    fphi: float = 0.0
    keyword: str = ""

    @property
    def ninput(self) -> int:
        return len(self.r)


def _parse_params(line: str) -> dict:
    toks = line.split()
    out = {"ninput": 0, "rflag": RNONE, "fpflag": 0}
    i = 0
    while i < len(toks):
        w = toks[i]
        if w == "N":
            out["ninput"] = int(toks[i + 1]); i += 2
        elif w in ("R", "RSQ", "BITMAP"):
            out["rflag"] = {"R": RLINEAR, "RSQ": RSQ, "BITMAP": BMP}[w]
            out["rlo"] = float(toks[i + 1])
            out["rhi"] = float(toks[i + 2])
            i += 3
        elif w == "FPRIME":
            out["fpflag"] = 1
            out["fplo"] = float(toks[i + 1])
            out["fphi"] = float(toks[i + 2])
            i += 3
        else:
            raise ValueError(f"Invalid keyword {w!r} in pair table parameters")
    if out["ninput"] == 0:
        raise ValueError("Pair table parameters did not set N")
    return out


def read_table_file(path: str, keyword: str) -> RawTable:
    """Read one named section from a LAMMPS table file."""
    with open(path) as fh:
        lines = fh.readlines()

    # find section start: a line whose first word == keyword
    idx = None
    for i, ln in enumerate(lines):
        s = ln.split("#")[0].strip()
        if not s:
            continue
        if s.split()[0] == keyword:
            idx = i
            break
    if idx is None:
        raise ValueError(f"Did not find keyword {keyword!r} in table file {path}")

    params = _parse_params(lines[idx + 1].split("#")[0])
    n = params["ninput"]

    r = np.empty(n)
    e = np.empty(n)
    f = np.empty(n)
    # skip one line after the parameter line (blank separator), then read n rows,
    # tolerating interspersed blank lines
    row = 0
    j = idx + 2
    while row < n:
        j += 1
        if j >= len(lines):
            raise ValueError(f"Data missing when parsing pair table {keyword!r}")
        s = lines[j].split("#")[0].strip()
        if not s:
            continue
        toks = s.split()
        r[row] = float(toks[1])
        e[row] = float(toks[2])
        f[row] = float(toks[3])
        row += 1

    tb = RawTable(
        r=r, e=e, f=f, rflag=params["rflag"],
        rlo=params.get("rlo", 0.0), rhi=params.get("rhi", 0.0),
        fpflag=params["fpflag"], fplo=params.get("fplo", 0.0),
        fphi=params.get("fphi", 0.0), keyword=keyword,
    )

    # recompute r if an R/RSQ spacing is declared (read_table, :954-973)
    if tb.rflag == RLINEAR:
        rnew = tb.rlo + (tb.rhi - tb.rlo) * np.arange(n) / (n - 1)
        tb.r = rnew
    elif tb.rflag == RSQ:
        rsq = tb.rlo**2 + (tb.rhi**2 - tb.rlo**2) * np.arange(n) / (n - 1)
        tb.r = np.sqrt(rsq)
    elif tb.rflag == BMP:
        raise NotImplementedError(
            "BITMAP-spaced table files are not supported yet; use R/RSQ tables"
        )
    return tb


def check_force_consistency(tb: RawTable) -> int:
    """Count interior points where f is inconsistent with -dE/dr by the secant
    test (read_table, :986-1002). Returns number of flagged points."""
    r, e, f = tb.r, tb.e, tb.f
    fleft = -(e[1:-1] - e[:-2]) / (r[1:-1] - r[:-2])
    fright = -(e[2:] - e[1:-1]) / (r[2:] - r[1:-1])
    fm = f[1:-1]
    bad = ((fm < fleft) & (fm < fright)) | ((fm > fleft) & (fm > fright))
    return int(np.sum(bad))


def write_table_file(path: str, sections: dict, mode: str = "w") -> None:
    """Write sections {keyword: RawTable-like or (r, e, f)} to a table file."""
    with open(path, mode) as fh:
        fh.write("# LAMMPS tabulated potential (written by lammps_ucg_dev_tpu)\n\n")
        for kw, tb in sections.items():
            if isinstance(tb, tuple):
                r, e, f = tb
                tb = RawTable(r=np.asarray(r), e=np.asarray(e), f=np.asarray(f))
            fh.write(f"{kw}\n")
            n = tb.ninput
            if tb.rflag == RLINEAR:
                fh.write(f"N {n} R {tb.rlo:.15g} {tb.rhi:.15g}\n\n")
            elif tb.rflag == RSQ:
                fh.write(f"N {n} RSQ {tb.rlo:.15g} {tb.rhi:.15g}\n\n")
            else:
                fh.write(f"N {n}\n\n")
            for i in range(n):
                fh.write(f"{i + 1} {tb.r[i]:.15g} {tb.e[i]:.15g} {tb.f[i]:.15g}\n")
            fh.write("\n")
