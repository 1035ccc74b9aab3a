"""Pair tables from the deck's files: the LAMMPS table-file grammar, the
cubic spline fit of the file's points, and LINEAR binning in r² with its
interpolation (pair_table_ucgld.cpp:897-1102, 1105-1245, 1375-1428 of the
reference package).  Plain numpy on the host for the build, plain torch for
the lookup; nothing of the program is imported."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NATURAL = 0.99e30


def read_table(path: str, keyword: str):
    """(r, e, f) of one section of a table file with ``N n R rlo rhi``
    parameters; r is re-spaced uniformly as the reference does."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    k = next(i for i, ln in enumerate(lines)
             if ln.split("#")[0].split()[:1] == [keyword])
    toks = lines[k + 1].split()
    n = int(toks[toks.index("N") + 1])
    rlo, rhi = (float(v) for v in toks[toks.index("R") + 1:
                                        toks.index("R") + 3])
    rows = []
    j = k + 2
    while len(rows) < n:
        j += 1
        s = lines[j].split("#")[0].split()
        if s:
            rows.append([float(v) for v in s[1:4]])
    rows = np.asarray(rows)
    r = rlo + (rhi - rlo) * np.arange(n) / (n - 1)
    return r, rows[:, 1], rows[:, 2], rlo


def spline(x, y, yp1, ypn):
    """Second derivatives of the cubic spline through (x, y) with end
    slopes yp1, ypn (Numerical Recipes' ``spline``)."""
    n = len(x)
    y2 = np.empty(n)
    u = np.empty(n)
    if yp1 > _NATURAL:
        y2[0] = u[0] = 0.0
    else:
        y2[0] = -0.5
        u[0] = (3.0 / (x[1] - x[0])) * ((y[1] - y[0]) / (x[1] - x[0]) - yp1)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        d = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
             - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * d / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    if ypn > _NATURAL:
        qn = un = 0.0
    else:
        qn = 0.5
        un = (3.0 / (x[-1] - x[-2])) * (ypn - (y[-1] - y[-2])
                                         / (x[-1] - x[-2]))
    y2[-1] = (un - qn * u[-2]) / (qn * y2[-2] + 1.0)
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def splint(xa, ya, y2a, x):
    khi = np.clip(np.searchsorted(xa, x, side="left"), 1, len(xa) - 1)
    klo = khi - 1
    h = xa[khi] - xa[klo]
    a = (xa[khi] - x) / h
    b = (x - xa[klo]) / h
    return (a * ya[klo] + b * ya[khi]
            + ((a ** 3 - a) * y2a[klo] + (b ** 3 - b) * y2a[khi]) * h * h
            / 6.0)


def linear_table(r, e, f, rlo: float, tablength: int, cut: float):
    """(innersq, delta, e, f/r) of a LINEAR table of ``tablength`` points in
    r² from rlo² to cut², from the spline of the file's points."""
    e2 = spline(r, e, -f[0], -f[-1])
    fplo = (f[1] - f[0]) / (r[1] - r[0])
    fphi = (f[-1] - f[-2]) / (r[-1] - r[-2])
    f2 = spline(r, f, fplo, fphi)
    innersq = rlo * rlo
    delta = (cut * cut - innersq) / (tablength - 1)
    rr = np.sqrt(innersq + np.arange(tablength) * delta)
    return innersq, delta, splint(r, e, e2, rr), splint(r, f, f2, rr) / rr


@dataclasses.dataclass
class Bank:
    """Every table of a pair style, stacked: ``(T, L)`` values and per-table
    ``innersq`` and ``1/delta``."""

    e: torch.Tensor
    f: torch.Tensor
    innersq: torch.Tensor
    invdelta: torch.Tensor

    @staticmethod
    def build(tables, dtype, device) -> "Bank":
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return Bank(e=t([tb[2] for tb in tables]),
                    f=t([tb[3] for tb in tables]),
                    innersq=t([tb[0] for tb in tables]),
                    invdelta=t([1.0 / tb[1] for tb in tables]))

    def interp(self, tid: torch.Tensor, rsq: torch.Tensor):
        """(e, f(r)/r) of tables ``tid`` at ``rsq``: linear in r² between
        bins, the bin index clamped to the table (LINEAR)."""
        L = self.e.shape[1]
        xbin = (rsq - self.innersq[tid]) * self.invdelta[tid]
        it = torch.clamp(xbin, 0, L - 2).to(torch.int64)
        frac = xbin - it.to(xbin.dtype)
        e0, e1 = self.e[tid, it], self.e[tid, it + 1]
        f0, f1 = self.f[tid, it], self.f[tid, it + 1]
        return e0 + frac * (e1 - e0), f0 + frac * (f1 - f0)
