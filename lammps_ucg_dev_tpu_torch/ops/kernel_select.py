"""Auto-selection of the hand-written pair kernel path (port of
``lammps_ucg_dev_tpu/ops/kernel_select.py``): ``table_ucgld`` through K1,
``table_ucg_bethe`` through K2, ``table_ucg_bethe_density`` through K5, K3
and K6, ``table_rleucg_interface`` through K5, K4 and K6.

Eligibility (all must hold; otherwise the style's reference pair path,
``models/pair_*.py``, on an nsq neighbor list stays in force):

* a CUDA device — the JAX package selects its kernel only on a TPU;
  ``force=True`` skips this check (tests, where the wrapper then runs the
  kernel's plain twin on CPU tensors);
* float32 state (the kernel computes in f32);
* the style's ``supports*`` gate (ops/hopper_pair.py, hopper_bethe.py,
  hopper_density.py, hopper_rleucg.py);
* an orthogonal box with at least 3x3 columns (``colpack.measure_spec``);
* a Chebyshev fit of the table bank (LINEAR, SPLINE or BITMAP; LOOKUP's
  staircase does not fit) with ``max_rel_err < rel_tol``.

Topology composes with the kernel path, so selection ignores it (the JAX
package's ``kernel_select.py:24-33``): bonded terms add to the pair pass
(``models/bonded.py``), special exclusions are computed by the kernels
and subtracted through the style's ``excl_delta`` (the density styles'
entries take the lists and subtract pass by pass: ``sim.excl_route``),
and
the ``cluster_switch`` event builds its own contact list
(``Simulation._cswitch_event``), so config-4 decks keep their kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def select_pair_kernel(params, state, cutoff: float, skin: float,
                       rel_tol: float = 1e-4, force: "bool | None" = None):
    """Returns (pair_fn, spec, params) for the kernel path, or None.
    ``force=True`` skips the device check; ``force=False`` disables
    selection outright."""
    from lammps_ucg_dev_tpu_torch.models.pair_bethe import BetheParams
    from lammps_ucg_dev_tpu_torch.models.pair_bethe_density import (
        BetheDensityParams)
    from lammps_ucg_dev_tpu_torch.models.pair_rleucg import RLEUCGParams
    from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
    from lammps_ucg_dev_tpu_torch.ops import chebtab, colpack
    from lammps_ucg_dev_tpu_torch.ops import hopper_bethe as hb
    from lammps_ucg_dev_tpu_torch.ops import hopper_cv as hcv
    from lammps_ucg_dev_tpu_torch.ops import hopper_density as hd
    from lammps_ucg_dev_tpu_torch.ops import hopper_pair as hp
    from lammps_ucg_dev_tpu_torch.ops import hopper_rleucg as hr

    # style: (gate, pair function, per-type proximity radius or None)
    styles = {UCGLDParams: (hp.supports, hp.compute_style, None),
              BetheParams: (hb.supports_bethe, hb.compute_style_bethe, None),
              BetheDensityParams: (hd.supports_density,
                                   hd.compute_style_density,
                                   hd.radius_by_type),
              RLEUCGParams: (hr.supports_rleucg, hr.compute_style_rleucg,
                             hr.radius_by_type)}
    if force is False or type(params) not in styles:
        return None
    if state.x.dtype != torch.float32:
        return None
    if force is None and not state.x.is_cuda:
        return None
    if state.box.is_triclinic:
        return None
    supports, style_fn, radii = styles[type(params)]
    if not supports(params):
        return None
    L = state.box.lengths.cpu().numpy().astype(np.float64)
    lo = state.box.lo.cpu().numpy().astype(np.float64)
    x = state.x.cpu().numpy().astype(np.float64)
    try:
        spec = colpack.measure_spec(np.mod(x - lo, L), L, cutoff, skin)
    except ValueError:
        return None
    cheb = chebtab.fit_bank(params.bank)
    if float(cheb.max_rel_err.max()) >= rel_tol:
        return None
    extra = ({} if radii is None else
             {"cv_rad": hcv.radius_table(radii(params), state.device)})
    return style_fn, spec, dataclasses.replace(params, cheb=cheb, chunk=0,
                                               **extra)
