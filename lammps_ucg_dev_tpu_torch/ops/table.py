"""Tabulated-potential substrate (port of ``lammps_ucg_dev_tpu/ops/table.py``).

Host-side table construction in numpy float64 (identical to the JAX
package, so both packages start from the same binned values) and an
on-device :class:`TableBank` of stacked ``(T, L)`` tensors whose ``interp``
is a gather + FMA over any batch shape.  Semantics follow the reference's
``PairTable_UCGLD::compute_table`` (``UCG/pair_table_ucgld.cpp:1105-1344``):
LOOKUP, LINEAR and SPLINE tables are binned uniformly in r² between
``inner²`` and ``cut²``; BITMAP tables bin by the float32 bit pattern of
r²; the stored ``f`` is f(r)/r so that the vector force is
``fpair * (xi - xj)``.

BITMAP-spaced table FILES are not supported, as in the JAX package (R and
RSQ files work with every tabstyle, bitmap included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import resolve_device
from lammps_ucg_dev_tpu_torch.io.table_io import BMP, RSQ, RawTable
from lammps_ucg_dev_tpu_torch.ops.spline import spline, splint

LOOKUP, LINEAR, SPLINE, BITMAP = "lookup", "linear", "spline", "bitmap"

_SECANT = 0.1


@dataclasses.dataclass
class BuiltTable:
    """One table after spline fit + r²-binning (host, float64)."""

    cut: float
    innersq: float
    delta: float
    invdelta: float
    deltasq6: float
    e: np.ndarray
    f: np.ndarray           # f(r)/r
    de: np.ndarray | None = None
    df: np.ndarray | None = None
    e2: np.ndarray | None = None
    f2: np.ndarray | None = None
    # BITMAP extras (float-bit binning; pair_table_ucgld.cpp:1252-1344)
    rsq: np.ndarray | None = None
    drsq: np.ndarray | None = None   # 1 / (rsq[i+1] - rsq[i]), periodic
    nmask: int = 0
    nshiftbits: int = 0


def _f32_bits(x: float) -> int:
    """Bit pattern of float(x) as a (signed) int32 — the reference's
    ``union_int_float_t`` (assignment to ``.f`` narrows double → float)."""
    return int(np.float64(x).astype(np.float32).view(np.int32))


def _bits_f32(i: int) -> float:
    return float(np.array(i, np.int64).astype(np.uint32).view(np.float32))


def init_bitmap(inner: float, outer: float, ntablebits: int):
    """Stock ``Pair::init_bitmap`` (the reference calls it at
    pair_table_ucgld.cpp:1260): choose exponent/mantissa bit splits so
    2^ntablebits bins cover [inner², outer²] in float32 bit space; returns
    (masklo, maskhi, nmask, nshiftbits)."""
    if ntablebits > 32:
        raise ValueError("Too many total bits for bitmapped lookup table")
    if inner >= outer:
        raise ValueError("Table inner cutoff >= outer cutoff")

    nlowermin = 1
    while not (2.0 ** nlowermin <= inner * inner
               and 2.0 ** (nlowermin + 1) > inner * inner):
        if 2.0 ** nlowermin <= inner * inner:
            nlowermin += 1
        else:
            nlowermin -= 1

    nexpbits = 0
    required_range = outer * outer / 2.0 ** nlowermin
    available_range = 2.0
    while available_range < required_range:
        nexpbits += 1
        available_range = 2.0 ** (2.0 ** nexpbits)

    nmantbits = ntablebits - nexpbits
    nshiftbits = 24 - (nmantbits + 1)          # FLT_MANT_DIG = 24
    if nshiftbits < 0:
        raise ValueError("Too many mantissa bits for bitmapped lookup table")
    nmask = (1 << (ntablebits + nshiftbits)) - 1
    maskhi = _f32_bits(outer * outer) & ~nmask
    masklo = _f32_bits(inner * inner) & ~nmask
    return masklo, maskhi, nmask, nshiftbits


def spline_table(tb: RawTable):
    """Fit e(r), f(r) splines over the raw input (spline_table, :1047-1065);
    returns (e2file, f2file, fplo, fphi)."""
    e2file = spline(tb.r, tb.e, -tb.f[0], -tb.f[-1])
    if tb.fpflag:
        fplo, fphi = tb.fplo, tb.fphi
    else:
        fplo = (tb.f[1] - tb.f[0]) / (tb.r[1] - tb.r[0])
        fphi = (tb.f[-1] - tb.f[-2]) / (tb.r[-1] - tb.r[-2])
    f2file = spline(tb.r, tb.f, fplo, fphi)
    return e2file, f2file, fplo, fphi


def _check_range(tb: RawTable, cut: float):
    """(rlo, rhi) of the raw table, after the reference's range checks."""
    if tb.ninput <= 1:
        raise ValueError("Invalid pair table length")
    rlo = tb.rlo if tb.rflag else tb.r[0]
    rhi = tb.rhi if tb.rflag else tb.r[-1]
    if cut <= rlo or cut > rhi:
        raise ValueError(
            f"Pair table cutoff {cut} outside of table range [{rlo}, {rhi}]")
    if rlo <= 0.0:
        raise ValueError("Invalid pair table lower boundary")
    return rlo, rhi


def build_table(tb: RawTable, tabstyle: str, tablength: int,
                cut: float) -> BuiltTable:
    """Bin one raw table in r² (compute_table, :1105-1245).  For BITMAP,
    ``tablength`` is the number of index BITS (2^tablength bins,
    :1252-1344)."""
    if tb.rflag == BMP:
        raise NotImplementedError(
            "BITMAP-spaced table FILES are not supported; R/RSQ input files "
            "work with every tabstyle including bitmap")
    if tabstyle == BITMAP:
        return _build_bitmap(tb, tablength, cut)
    if tabstyle not in (LOOKUP, LINEAR, SPLINE):
        raise ValueError(f"Unknown table style {tabstyle!r}")
    _check_range(tb, cut)

    # match = don't respline when final r values equal file values (:818-822)
    match = (tabstyle == LINEAR and tb.ninput == tablength
             and tb.rflag == RSQ and tb.rhi == cut)
    if not match:
        e2file, f2file, _, _ = spline_table(tb)

    tlm1 = tablength - 1
    inner = tb.rlo if tb.rflag else tb.r[0]
    innersq = inner * inner
    delta = (cut * cut - innersq) / tlm1
    invdelta = 1.0 / delta

    if tabstyle == LOOKUP:
        r = np.sqrt(innersq + (np.arange(tlm1) + 0.5) * delta)
        e = splint(tb.r, tb.e, e2file, r)
        f = splint(tb.r, tb.f, f2file, r) / r
        return BuiltTable(cut, innersq, delta, invdelta, 0.0, e, f)

    rsq = innersq + np.arange(tablength) * delta
    r = np.sqrt(rsq)
    if match:
        e = tb.e.copy()
        f = tb.f / r
    else:
        e = splint(tb.r, tb.e, e2file, r)
        f = splint(tb.r, tb.f, f2file, r)
        if tabstyle == LINEAR:
            f = f / r

    if tabstyle == LINEAR:
        de = np.zeros(tablength)
        df = np.zeros(tablength)
        de[:tlm1] = e[1:] - e[:-1]
        df[:tlm1] = f[1:] - f[:-1]
        return BuiltTable(cut, innersq, delta, invdelta, 0.0, e, f, de, df)

    # SPLINE: e spline in r² with endpoint slopes de/d(r²) = -f / 2r
    # (:1208-1214)
    deltasq6 = delta * delta / 6.0
    ep0 = -f[0] / (2.0 * np.sqrt(innersq))
    epn = -f[tlm1] / (2.0 * cut)
    e2 = spline(rsq, e, ep0, epn)
    # f/r spline in r² with secant endpoint slopes (:1221-1241)
    if tb.fpflag:
        fp0 = ((tb.fplo / np.sqrt(innersq) - f[0] / innersq)
               / (2.0 * np.sqrt(innersq)))
    else:
        rsq1 = innersq
        rsq2 = rsq1 + _SECANT * delta
        fp0 = (splint(tb.r, tb.f, f2file, np.sqrt(rsq2)) / np.sqrt(rsq2)
               - f[0] / np.sqrt(rsq1)) / (_SECANT * delta)
    if tb.fpflag and cut == tb.r[-1]:
        fpn = (tb.fphi / cut - f[tlm1] / (cut * cut)) / (2.0 * cut)
    else:
        rsq2 = cut * cut
        rsq1 = rsq2 - _SECANT * delta
        fpn = (f[tlm1] / np.sqrt(rsq2)
               - splint(tb.r, tb.f, f2file, np.sqrt(rsq1)) / np.sqrt(rsq1)
               ) / (_SECANT * delta)
    fr = f / r
    f2 = spline(rsq, fr, fp0, fpn)
    return BuiltTable(cut, innersq, delta, invdelta, deltasq6, e, fr,
                      e2=e2, f2=f2)


def _build_bitmap(tb: RawTable, ntablebits: int, cut: float) -> BuiltTable:
    """Bitmapped linear tables: 2^N bins whose edges are float32 bit
    patterns (compute_table BITMAP branch, pair_table_ucgld.cpp:1252-1344).
    Bins wrap periodically in masked-bit index space; per-bin (rsq, 1/Δrsq)
    replace the uniform (innersq, invdelta) of LINEAR."""
    rlo, _ = _check_range(tb, cut)
    e2file, f2file, _, _ = spline_table(tb)
    inner = rlo
    masklo, maskhi, nmask, nshiftbits = init_bitmap(inner, cut, ntablebits)
    ntable = 1 << ntablebits

    idx_bits = np.arange(ntable, dtype=np.int64) << nshiftbits
    f_lo = ((idx_bits | masklo).astype(np.uint32).view(np.float32)
            .astype(np.float64))
    f_hi = ((idx_bits | maskhi).astype(np.uint32).view(np.float32)
            .astype(np.float64))
    rsq_t = np.where(f_lo < inner * inner, f_hi, f_lo)
    r = np.sqrt(np.float32(rsq_t).astype(np.float64))   # sqrtf, :1282
    e = splint(tb.r, tb.e, e2file, r)
    f = splint(tb.r, tb.f, f2file, r) / r
    innersq = float(np.min(rsq_t))                       # minrsq, :1294

    de = np.empty(ntable)
    df = np.empty(ntable)
    drsq = np.empty(ntable)
    de[:-1] = e[1:] - e[:-1]
    df[:-1] = f[1:] - f[:-1]
    drsq[:-1] = 1.0 / (rsq_t[1:] - rsq_t[:-1])
    # periodic closure between index ntable-1 and 0 (:1304-1308)
    de[-1] = e[0] - e[-1]
    df[-1] = f[0] - f[-1]
    drsq[-1] = 1.0 / (rsq_t[0] - rsq_t[-1])

    # the largest-r bin interpolates to cut² exactly (:1312-1343)
    itablemin = int(np.argmin(rsq_t))
    itablemax = (itablemin - 1) % ntable
    edge = _bits_f32(int(np.int64(itablemax << nshiftbits) | maskhi))
    if edge < cut * cut:
        # the reference narrows cut² through the float union (rsq_lookup.f)
        # before both the spline query and the drsq denominator (:1335-1341)
        cutsq32 = float(np.float32(cut * cut))
        rc = np.sqrt(cutsq32)
        e_tmp = float(splint(tb.r, tb.e, e2file, np.asarray([rc]))[0])
        f_tmp = float(splint(tb.r, tb.f, f2file, np.asarray([rc]))[0] / rc)
        de[itablemax] = e_tmp - e[itablemax]
        df[itablemax] = f_tmp - f[itablemax]
        drsq[itablemax] = 1.0 / (cutsq32 - rsq_t[itablemax])

    return BuiltTable(cut, innersq, 0.0, 0.0, 0.0, e, f, de, df,
                      rsq=rsq_t, drsq=drsq, nmask=nmask,
                      nshiftbits=nshiftbits)


@dataclasses.dataclass(frozen=True)
class TableBank:
    """All tables of a pair style, stacked on the device.  The JAX package
    keeps the channels packed ``(T*L, C)`` for the TPU's one-take gather;
    here each channel is its own ``(T, L)`` tensor (the same values)."""

    style: str
    nbins: int               # stored entries per table
    innersq: torch.Tensor    # (T,)
    invdelta: torch.Tensor   # (T,)
    delta: torch.Tensor      # (T,)
    cutsq: torch.Tensor      # (T,)
    e: torch.Tensor          # (T, L)
    f: torch.Tensor          # (T, L) — f(r)/r
    de: torch.Tensor         # (T, L); zeros for LOOKUP and SPLINE
    df: torch.Tensor         # (T, L)
    deltasq6: torch.Tensor   # (T,) SPLINE's delta²/6, else 0
    uniform: bool = False    # LINEAR, all tables sharing (innersq, delta, L)
    e2: torch.Tensor | None = None         # (T, L) SPLINE only
    f2: torch.Tensor | None = None         # (T, L) SPLINE only
    rsq: torch.Tensor | None = None        # (T, L) BITMAP bin edges
    drsq: torch.Tensor | None = None       # (T, L) BITMAP 1 / bin width
    nmask: torch.Tensor | None = None      # (T,) int32, BITMAP
    nshiftbits: torch.Tensor | None = None  # (T,) int32, BITMAP

    @property
    def n_tables(self) -> int:
        return self.e.shape[0]

    @staticmethod
    def from_built(tables: list[BuiltTable], style: str,
                   dtype=torch.float32, device="cuda") -> "TableBank":
        """The bank of ``tables`` on ``device`` (the card unless told
        ``device="cpu"``; raises without CUDA)."""
        device = resolve_device(device)
        if style not in (LOOKUP, LINEAR, SPLINE, BITMAP):
            raise NotImplementedError(f"table style {style!r}")
        L = max(len(t.e) for t in tables)

        def stack(get):
            out = np.zeros((len(tables), L), dtype=np.float64)
            for i, t in enumerate(tables):
                a = get(t)
                if a is not None:
                    out[i, :len(a)] = a
            return torch.as_tensor(out, dtype=dtype, device=device)

        def vec(get, dt=dtype):
            return torch.as_tensor(np.asarray([get(t) for t in tables]),
                                   dtype=dt, device=device)

        inn = np.asarray([t.innersq for t in tables])
        dlt = np.asarray([t.delta for t in tables])
        uniform = (
            style == LINEAR
            and len({len(t.e) for t in tables}) == 1
            and bool(np.all(np.abs(inn - inn[0])
                            <= 1e-12 * max(1.0, abs(inn[0]))))
            and bool(np.all(np.abs(dlt - dlt[0]) <= 1e-12 * dlt[0])))
        spl, bmp = style == SPLINE, style == BITMAP
        return TableBank(
            style=style, nbins=L,
            innersq=vec(lambda t: t.innersq),
            invdelta=vec(lambda t: t.invdelta),
            delta=vec(lambda t: t.delta),
            cutsq=vec(lambda t: t.cut * t.cut),
            e=stack(lambda t: t.e), f=stack(lambda t: t.f),
            de=stack(lambda t: t.de), df=stack(lambda t: t.df),
            uniform=uniform,
            deltasq6=vec(lambda t: t.deltasq6),
            e2=stack(lambda t: t.e2) if spl else None,
            f2=stack(lambda t: t.f2) if spl else None,
            rsq=stack(lambda t: t.rsq) if bmp else None,
            drsq=stack(lambda t: t.drsq) if bmp else None,
            nmask=vec(lambda t: t.nmask, torch.int32) if bmp else None,
            nshiftbits=(vec(lambda t: t.nshiftbits, torch.int32) if bmp
                        else None))

    def interp(self, t: torch.Tensor, rsq: torch.Tensor):
        """Interpolation of (energy, f(r)/r) for table ids ``t`` at squared
        distances ``rsq`` (matching batch shapes), in the bank's style
        (pair_table_ucgld.cpp:226-268).

        Returns (e, fpair, oob_low, oob_high); out-of-range entries are
        clamped to the boundary bin (callers mask pairs beyond the cutoff).
        Bin indices clamp in float before the int cast: identical to the
        JAX package's clip(int(xbin)) for every finite value, and defined
        for masked far-away lanes.
        """
        L = self.nbins
        inn = self.innersq[t]
        if self.style == BITMAP:
            # float32-bit binning (:252-258): mask the bit pattern, shift
            # to the index, interpolate against the bin's lower edge.  The
            # lookup value is the f32-narrowed rsq (the reference's
            # rsq_lookup.f) in the index and the fraction alike; below the
            # inner cutoff the masked index would alias to a mid-table bin,
            # so the lookup clamps to innersq (oob_low still reports it).
            rs32 = torch.maximum(rsq, inn).to(torch.float32)
            # the masked pattern is non-negative: >> is the logical shift
            it = ((rs32.view(torch.int32) & self.nmask[t])
                  >> self.nshiftbits[t]).long()
            frac = (rs32.to(rsq.dtype) - self.rsq[t, it]) * self.drsq[t, it]
            e = self.e[t, it] + frac * self.de[t, it]
            fp = self.f[t, it] + frac * self.df[t, it]
            return e, fp, rsq < inn, torch.zeros_like(rsq, dtype=torch.bool)
        xbin = (rsq - inn) * self.invdelta[t]
        if self.style == LOOKUP:
            it = torch.clamp(xbin, 0, L - 1).to(torch.int64)
            return self.e[t, it], self.f[t, it], rsq < inn, xbin >= L
        it = torch.clamp(xbin, 0, L - 2).to(torch.int64)
        if self.style == LINEAR:
            frac = xbin - it.to(xbin.dtype)
            e = self.e[t, it] + frac * self.de[t, it]
            fp = self.f[t, it] + frac * self.df[t, it]
            return e, fp, rsq < inn, xbin >= (L - 1)
        # SPLINE: the cubic spline in r² over bins it and it + 1
        b = xbin - it.to(xbin.dtype)
        a = 1.0 - b
        d6 = self.deltasq6[t]
        wa = a * a * a - a
        wb = b * b * b - b
        i1 = it + 1
        e = (a * self.e[t, it] + b * self.e[t, i1]
             + (wa * self.e2[t, it] + wb * self.e2[t, i1]) * d6)
        fp = (a * self.f[t, it] + b * self.f[t, i1]
              + (wa * self.f2[t, it] + wb * self.f2[t, i1]) * d6)
        return e, fp, rsq < inn, xbin >= (L - 1)
