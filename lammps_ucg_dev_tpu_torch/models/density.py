"""Local-density collective-variable machinery shared by the density styles
(P3 ``table_ucg_bethe_density`` and P4 ``table_rleucg_interface``); port of
``lammps_ucg_dev_tpu/models/density.py``.

Proximity (smoothed counting) function and the sigmoid state-probability
threshold (UCG/pair_table_rleucg_interface.cpp:90-100,164-173; identical
copies in pair_table_ucg_bethe_density.cpp:107-127):

    w(r)    = 0.5 (1 - tanh((r - R) / 0.1 R))          proximity
    |w'(r)| = 0.5 (1 - tanh²) / (0.1 R)                the reference's
              positive-convention derivative magnitude (dw/dr is its negative)
    p(ρ)    = 0.5 + 0.5 tanh((ρ - ρ*) / 0.1 ρ*)        threshold probability
    ∂p/∂ρ   = 0.5 (1 - tanh²) / (0.1 ρ*)

(ρ*, R) are per-type arrays, so any type may use the density CV.
"""

from __future__ import annotations

import torch


def proximity(r: torch.Tensor, radius) -> torch.Tensor:
    t = torch.tanh((r - radius) / (0.1 * radius))
    return 0.5 * (1.0 - t)


def proximity_der(r: torch.Tensor, radius) -> torch.Tensor:
    """Positive-convention derivative magnitude 0.5 (1 - tanh²)/(0.1 R)
    (``compute_proximity_function_der``); the actual dw/dr is its
    negative."""
    t = torch.tanh((r - radius) / (0.1 * radius))
    return 0.5 * (1.0 - t * t) / (0.1 * radius)


def threshold_prob_and_partial(cv: torch.Tensor, cv_threshold):
    t = torch.tanh((cv - cv_threshold) / (0.1 * cv_threshold))
    prob = 0.5 + 0.5 * t
    partial = 0.5 * (1.0 - t * t) / (0.1 * cv_threshold)
    return prob, partial
