"""Host-side cubic-spline machinery for table construction.

Reimplements (in NumPy, at table-setup time only) the Numerical-Recipes-style
spline fit used by the reference's embedded table substrate:
``PairTable_UCGLD::spline`` (UCG/pair_table_ucgld.cpp:1375-1404)
and ``splint`` (:1408-1428).  These run on the host once per table; the device
only ever sees the precomputed binned arrays.
"""

from __future__ import annotations

import numpy as np

_NATURAL = 0.99e30


def spline(x: np.ndarray, y: np.ndarray, yp1: float, ypn: float) -> np.ndarray:
    """Second-derivative coefficients for a cubic spline through (x, y).

    ``yp1``/``ypn`` are the endpoint first derivatives; values > 0.99e30 select
    a natural (zero-curvature) boundary, matching the reference convention.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
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
        ui = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
        u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p

    if ypn > _NATURAL:
        qn = un = 0.0
    else:
        qn = 0.5
        un = (3.0 / (x[n - 1] - x[n - 2])) * (
            ypn - (y[n - 1] - y[n - 2]) / (x[n - 1] - x[n - 2])
        )

    y2[n - 1] = (un - qn * u[n - 2]) / (qn * y2[n - 2] + 1.0)
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def splint(xa: np.ndarray, ya: np.ndarray, y2a: np.ndarray, x) -> np.ndarray:
    """Evaluate the cubic spline at point(s) ``x`` (vectorized)."""
    xa = np.asarray(xa, dtype=np.float64)
    ya = np.asarray(ya, dtype=np.float64)
    y2a = np.asarray(y2a, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))

    khi = np.clip(np.searchsorted(xa, x, side="left"), 1, len(xa) - 1)
    # match the reference's bisection: klo/khi bracket x with xa[klo] <= x
    klo = khi - 1
    h = xa[khi] - xa[klo]
    a = (xa[khi] - x) / h
    b = (x - xa[klo]) / h
    y = (
        a * ya[klo]
        + b * ya[khi]
        + ((a**3 - a) * y2a[klo] + (b**3 - b) * y2a[khi]) * (h * h) / 6.0
    )
    return y if y.shape != (1,) else y[0]
