"""Tabulated-potential substrate (port of ``lammps_ucg_dev_tpu/ops/table.py``).

Host-side table construction in numpy float64 (identical to the JAX
package, so both packages start from the same binned values) and an
on-device :class:`TableBank` of stacked ``(T, L)`` tensors whose ``interp``
is a gather + FMA over any batch shape.  Semantics follow the reference's
``PairTable_UCGLD::compute_table`` (``UCG/pair_table_ucgld.cpp:1105-1245``):
tables are binned uniformly in r² between ``inner²`` and ``cut²``; the
stored ``f`` is f(r)/r so that the vector force is ``fpair * (xi - xj)``.

Only the LINEAR interpolant is ported.  LOOKUP, SPLINE and BITMAP raise
``NotImplementedError`` (listed in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import resolve_device
from lammps_ucg_dev_tpu_torch.io.table_io import BMP, RSQ, RawTable
from lammps_ucg_dev_tpu_torch.ops.spline import spline, splint

LOOKUP, LINEAR, SPLINE, BITMAP = "lookup", "linear", "spline", "bitmap"


@dataclasses.dataclass
class BuiltTable:
    """One table after spline fit + r²-binning (host, float64)."""

    cut: float
    innersq: float
    delta: float
    invdelta: float
    e: np.ndarray
    f: np.ndarray           # f(r)/r
    de: np.ndarray
    df: np.ndarray


def spline_table(tb: RawTable):
    """Fit e(r), f(r) splines over the raw input (spline_table, :1047-1065)."""
    e2file = spline(tb.r, tb.e, -tb.f[0], -tb.f[-1])
    if tb.fpflag:
        fplo, fphi = tb.fplo, tb.fphi
    else:
        fplo = (tb.f[1] - tb.f[0]) / (tb.r[1] - tb.r[0])
        fphi = (tb.f[-1] - tb.f[-2]) / (tb.r[-1] - tb.r[-2])
    f2file = spline(tb.r, tb.f, fplo, fphi)
    return e2file, f2file


def build_table(tb: RawTable, tabstyle: str, tablength: int,
                cut: float) -> BuiltTable:
    """Bin one raw table in r² (compute_table, :1105-1245), LINEAR only."""
    if tabstyle != LINEAR:
        raise NotImplementedError(
            f"table style {tabstyle!r} is not ported yet (LINEAR only)")
    if tb.rflag == BMP:
        raise NotImplementedError(
            "BITMAP-spaced table FILES are not supported")
    if tb.ninput <= 1:
        raise ValueError("Invalid pair table length")
    rlo = tb.rlo if tb.rflag else tb.r[0]
    rhi = tb.rhi if tb.rflag else tb.r[-1]
    if cut <= rlo or cut > rhi:
        raise ValueError(
            f"Pair table cutoff {cut} outside of table range [{rlo}, {rhi}]")
    if rlo <= 0.0:
        raise ValueError("Invalid pair table lower boundary")

    # match = don't respline when final r values equal file values (:818-822)
    match = tb.ninput == tablength and tb.rflag == RSQ and tb.rhi == cut

    tlm1 = tablength - 1
    inner = tb.rlo if tb.rflag else tb.r[0]
    innersq = inner * inner
    delta = (cut * cut - innersq) / tlm1
    rsq = innersq + np.arange(tablength) * delta
    r = np.sqrt(rsq)
    if match:
        e = tb.e.copy()
        f = tb.f / r
    else:
        e2file, f2file = spline_table(tb)
        e = splint(tb.r, tb.e, e2file, r)
        f = splint(tb.r, tb.f, f2file, r) / r
    de = np.zeros(tablength)
    df = np.zeros(tablength)
    de[:tlm1] = e[1:] - e[:-1]
    df[:tlm1] = f[1:] - f[:-1]
    return BuiltTable(cut, innersq, delta, 1.0 / delta, e, f, de, df)


@dataclasses.dataclass(frozen=True)
class TableBank:
    """All tables of a pair style, stacked on the device."""

    style: str
    nbins: int               # stored entries per table
    innersq: torch.Tensor    # (T,)
    invdelta: torch.Tensor   # (T,)
    delta: torch.Tensor      # (T,)
    cutsq: torch.Tensor      # (T,)
    e: torch.Tensor          # (T, L)
    f: torch.Tensor          # (T, L) — f(r)/r
    de: torch.Tensor         # (T, L)
    df: torch.Tensor         # (T, L)
    uniform: bool = False    # all tables share (innersq, delta, L)

    @property
    def n_tables(self) -> int:
        return self.e.shape[0]

    @staticmethod
    def from_built(tables: list[BuiltTable], style: str,
                   dtype=torch.float32, device="cuda") -> "TableBank":
        """The bank of ``tables`` on ``device`` (the card unless told
        ``device="cpu"``; raises without CUDA)."""
        device = resolve_device(device)
        if style != LINEAR:
            raise NotImplementedError(
                f"table style {style!r} is not ported yet (LINEAR only)")
        L = max(len(t.e) for t in tables)

        def stack(get):
            out = np.zeros((len(tables), L), dtype=np.float64)
            for i, t in enumerate(tables):
                a = get(t)
                out[i, :len(a)] = a
            return torch.as_tensor(out, dtype=dtype, device=device)

        def vec(get):
            return torch.as_tensor(np.asarray([get(t) for t in tables],
                                              np.float64),
                                   dtype=dtype, device=device)

        inn = np.asarray([t.innersq for t in tables])
        dlt = np.asarray([t.delta for t in tables])
        uniform = (
            len({len(t.e) for t in tables}) == 1
            and bool(np.all(np.abs(inn - inn[0])
                            <= 1e-12 * max(1.0, abs(inn[0]))))
            and bool(np.all(np.abs(dlt - dlt[0]) <= 1e-12 * dlt[0])))
        return TableBank(
            style=style, nbins=L,
            innersq=vec(lambda t: t.innersq),
            invdelta=vec(lambda t: t.invdelta),
            delta=vec(lambda t: t.delta),
            cutsq=vec(lambda t: t.cut * t.cut),
            e=stack(lambda t: t.e), f=stack(lambda t: t.f),
            de=stack(lambda t: t.de), df=stack(lambda t: t.df),
            uniform=uniform)

    def interp(self, t: torch.Tensor, rsq: torch.Tensor):
        """LINEAR interpolation of (energy, f(r)/r) for table ids ``t`` at
        squared distances ``rsq`` (matching batch shapes).

        Returns (e, fpair, oob_low, oob_high); out-of-range entries are
        clamped to the boundary bin (callers mask pairs beyond the cutoff).
        """
        L = self.nbins
        inn = self.innersq[t]
        xbin = (rsq - inn) * self.invdelta[t]
        # clamp in float before the int cast: identical to clip(int(xbin))
        # for every finite value, and defined for masked far-away lanes
        it = torch.clamp(xbin, 0, L - 2).to(torch.int64)
        frac = xbin - it.to(xbin.dtype)
        e = self.e[t, it] + frac * self.de[t, it]
        fp = self.f[t, it] + frac * self.df[t, it]
        return e, fp, rsq < inn, xbin >= (L - 1)
