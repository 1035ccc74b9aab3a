"""Chebyshev compression of binned pair tables for the hand-written pair
kernel (port of ``lammps_ucg_dev_tpu/ops/chebtab.py``).

A degree-(D-1) Chebyshev fit per (table, channel) turns the table lookup
into ~2D FMAs per pair with no memory indirection.  The fit targets each
style's exact interpolant (LINEAR, SPLINE or BITMAP; LOOKUP's staircase
does not fit), so kernel-vs-table differences are bounded by the reported
fit error.  ``fit_bank`` runs in numpy float64 on the same
values as the JAX package, so its coefficients are bit-identical to JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from numpy.polynomial import chebyshev as C

from lammps_ucg_dev_tpu_torch.ops.table import (BITMAP, LINEAR, SPLINE,
                                                TableBank)


@dataclasses.dataclass
class ChebBank:
    """Chebyshev coefficients for all tables' (e, f) channels.

    coeffs: (2*T, D) — rows [e_0..e_{T-1}, f_0..f_{T-1}]; domain [lo, hi]
    in rsq shared by all tables (shared-domain banks only).  ``kernel_rows``
    caches the kernel's coefficient layouts (see ops/hopper_pair.py)."""

    coeffs: torch.Tensor
    lo: torch.Tensor           # () rsq domain start (= innersq)
    hi: torch.Tensor           # () rsq domain end (= cut²)
    max_abs_err: torch.Tensor  # (2*T,)
    max_rel_err: torch.Tensor  # (2*T,)
    degree: int = 16
    kernel_rows: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _shared_domain(bank: TableBank):
    """(lo, hi) of the rsq domain when every table shares it, else None.
    LINEAR/SPLINE: a shared (innersq, delta) uniform binning; BITMAP: a
    shared (innersq, cut²) and bit grid.  LOOKUP's staircase never fits."""
    if bank.style not in (LINEAR, SPLINE, BITMAP):
        return None
    inn = _np(bank.innersq)
    if not np.all(np.abs(inn - inn[0]) <= 1e-12 * max(1.0, abs(inn[0]))):
        return None
    if bank.style == BITMAP:
        cut = _np(bank.cutsq)
        if not np.all(np.abs(cut - cut[0]) <= 1e-12 * cut[0]):
            return None
        nm = bank.nmask.cpu().numpy()
        if not np.all(nm == nm[0]):       # the same bit grid in every table
            return None
        return float(inn[0]), float(cut[0])
    dlt = _np(bank.delta)
    if not np.all(np.abs(dlt - dlt[0]) <= 1e-12 * dlt[0]):
        return None
    return float(inn[0]), float(inn[0] + (bank.nbins - 1) * dlt[0])


def fittable(bank: TableBank) -> bool:
    """Whether the Chebyshev compression applies to this bank (the quality
    gate on ``max_rel_err`` still decides per fit): LINEAR, SPLINE, or
    BITMAP with a shared rsq domain."""
    return _shared_domain(bank) is not None


def _sample_channels(bank: TableBank, t: int, rsq: np.ndarray):
    """Host f64 evaluation of table ``t``'s (e, f/r) at dense rsq — the
    exact function TableBank.interp computes for each style, so the fit's
    error bounds the kernel against the reference path."""
    inn = float(_np(bank.innersq)[t])
    L = bank.nbins
    e_arr, f_arr = _np(bank.e)[t], _np(bank.f)[t]
    if bank.style == BITMAP:
        # float32-bit binning, as interp's BITMAP branch
        rs32 = np.maximum(rsq, inn).astype(np.float32)
        nmask = int(bank.nmask[t])
        nshift = int(bank.nshiftbits[t])
        it = np.right_shift(np.bitwise_and(rs32.view(np.int32), nmask),
                            nshift)
        frac = (rs32.astype(np.float64) - _np(bank.rsq)[t, it]) \
            * _np(bank.drsq)[t, it]
        return (e_arr[it] + frac * _np(bank.de)[t, it],
                f_arr[it] + frac * _np(bank.df)[t, it])
    delta = float(_np(bank.delta)[t])
    xb = (rsq - inn) / delta
    it = np.clip(xb.astype(int), 0, L - 2)
    frac = xb - it
    if bank.style == SPLINE:
        e2, f2 = _np(bank.e2)[t], _np(bank.f2)[t]
        d6 = float(_np(bank.deltasq6)[t])
        b = frac
        a = 1.0 - b
        wa = a * a * a - a
        wb = b * b * b - b
        e = a * e_arr[it] + b * e_arr[it + 1] + (wa * e2[it]
                                                 + wb * e2[it + 1]) * d6
        f = a * f_arr[it] + b * f_arr[it + 1] + (wa * f2[it]
                                                 + wb * f2[it + 1]) * d6
        return e, f
    de, df = _np(bank.de)[t], _np(bank.df)[t]
    return e_arr[it] + frac * de[it], f_arr[it] + frac * df[it]


def fit_bank(bank: TableBank, degree: int | None = None, oversample: int = 4,
             dtype=torch.float32, rel_tol: float = 1e-5) -> ChebBank:
    """Fit every table's e and f/r channels of a shared-domain LINEAR,
    SPLINE or BITMAP bank.

    degree=None auto-selects the smallest degree in {5, 6, 8, 12, 16, 20,
    24} whose max relative fit error is below ``rel_tol``, else the largest
    — callers gate on ``max_rel_err`` anyway."""
    if degree is None:
        last = None
        for d in (5, 6, 8, 12, 16, 20, 24):
            last = fit_bank(bank, degree=d, oversample=oversample,
                            dtype=dtype)
            if float(last.max_rel_err.max()) < rel_tol:
                return last
        return last
    dom = _shared_domain(bank)
    if dom is None:
        raise ValueError("ChebBank requires a shared-domain LINEAR, SPLINE, "
                         "or BITMAP TableBank")
    innersq, hi = dom
    T = bank.n_tables
    rsq = np.linspace(innersq, hi, oversample * bank.nbins)
    u = 2.0 * (rsq - innersq) / (hi - innersq) - 1.0
    coeffs = np.zeros((2 * T, degree))
    max_abs = np.zeros(2 * T)
    max_rel = np.zeros(2 * T)
    for t in range(T):
        for c, y in enumerate(_sample_channels(bank, t, rsq)):
            ch = C.chebfit(u, y, degree - 1)
            err = np.abs(C.chebval(u, ch) - y)
            row = c * T + t
            coeffs[row] = ch
            max_abs[row] = err.max()
            max_rel[row] = err.max() / (np.abs(y).max() + 1e-300)

    def tt(a):
        return torch.as_tensor(a, dtype=dtype, device=bank.e.device)

    return ChebBank(coeffs=tt(coeffs), lo=tt(innersq), hi=tt(hi),
                    max_abs_err=tt(max_abs), max_rel_err=tt(max_rel),
                    degree=degree)
