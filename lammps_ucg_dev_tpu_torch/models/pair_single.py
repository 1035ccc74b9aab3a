"""``Pair::single()`` analogue — per-pair energy/force queries (port of
``lammps_ucg_dev_tpu/models/pair_single.py``).

Every reference pair style implements ``single(i, j, itype, jtype, rsq,
factor_coul, factor_lj, fforce)`` (pair_table_ucgld.cpp:1474-1520,
pair_table_ucg_bethe.cpp:1670, pair_table_ucg_bethe_density.cpp:1743,
pair_table_rleucg_interface.cpp:1394).  All four share the stock
``pair_table`` body: they evaluate the FIRST table registered for
(itype, jtype) — the (si=0, sj=0) state combination — at ``rsq``,
ignoring λ/state mixing.  This is what backs LAMMPS ``compute pair/local``,
``compute group/group``, and energy-window queries.

:func:`single` is the vectorized equivalent; :func:`single_mixed` is an
extension the reference lacks: the λ-mixed (UCG-LD) energy and force for
explicit per-pair λ weights, matching the hot-loop mixing
(pair_table_ucgld.cpp:507-509).

Semantics notes vs the reference:

* the reference ``error->one``\\ s on rsq outside [inner², cut²]; here the
  out-of-bounds masks come back instead (callers can raise).
* ``factor_lj`` (special-bonds scaling) multiplies both outputs, as in the
  reference.
"""

from __future__ import annotations

import torch

from lammps_ucg_dev_tpu_torch.models import common
from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.table import TableBank


def _on(bank: TableBank, a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=bank.e.device)


def single(bank: TableBank, tp: UCGTypeParams, itype, jtype, rsq,
           factor_lj=1.0):
    """Stock-table ``single()``: energy/force of the (0,0)-combo table.

    Args are broadcastable arrays: ``itype/jtype`` 1-based actual types,
    ``rsq`` squared distances.  Returns ``(phi, fforce, oob_lo, oob_hi)``
    with ``fforce = factor_lj * f(r)/r`` (the reference's force/|r| value)
    and ``phi = factor_lj * e(r)``.
    """
    itype = _on(bank, itype, torch.int64)
    jtype = _on(bank, jtype, torch.int64)
    rsq = _on(bank, rsq, bank.e.dtype)
    itype, jtype, rsq = torch.broadcast_tensors(itype, jtype, rsq)
    t = common.take2d(tp.tab4, itype, jtype)[..., 0, 0]
    e, fp, lo, hi = bank.interp(t, rsq)
    return factor_lj * e, factor_lj * fp, lo, hi


def single_mixed(bank: TableBank, tp: UCGTypeParams, itype, jtype, rsq,
                 lam_i, lam_j, factor_lj=1.0):
    """λ-mixed per-pair query (extension): E = Σ wi[s] wj[s'] u_ss'(r) with
    w = [1-λ, λ] for UCG types and [1, 0] otherwise — the UCG-LD hot-loop
    mixing (pair_table_ucgld.cpp:507-509) for a standalone (i, j) pair.

    Returns ``(emix, fmix, oob_lo, oob_hi)``; fmix = mixed f(r)/r.
    """
    dt = bank.e.dtype
    itype = _on(bank, itype, torch.int64)
    jtype = _on(bank, jtype, torch.int64)
    rsq = _on(bank, rsq, dt)
    lam_i = _on(bank, lam_i, dt)
    lam_j = _on(bank, lam_j, dt)
    itype, jtype, rsq, lam_i, lam_j = torch.broadcast_tensors(
        itype, jtype, rsq, lam_i, lam_j)
    t4 = common.take2d(tp.tab4, itype, jtype)           # (..., 2, 2)
    e4, fp4, lo, hi = bank.interp(t4, rsq[..., None, None])
    wi = common.lambda_weights(tp, itype, lam_i)
    wj = common.lambda_weights(tp, jtype, lam_j)
    emix = torch.einsum("...s,...t,...st->...", wi, wj, e4)
    fmix = torch.einsum("...s,...t,...st->...", wi, wj, fp4)
    return (factor_lj * emix, factor_lj * fmix,
            torch.any(lo.flatten(-2), dim=-1), torch.any(hi.flatten(-2), dim=-1))
