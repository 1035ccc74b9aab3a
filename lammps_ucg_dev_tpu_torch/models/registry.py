"""Style registry — name → (compute fn, params builder), mirroring the
reference's ``PairStyle(...)``/``FixStyle(...)`` macro registrations
(e.g. pair_table_ucgld.h:16, fix_nve_ucgld.h:16) in a functional form (port
of ``lammps_ucg_dev_tpu/models/registry.py``).  The computes are the
reference pair paths; the deck runner (``compat/script.py``) builds its
pair style through ``pair_style`` and swaps in a kernel path through
``ops/kernel_select.select_pair_kernel``.

    compute, make = registry.pair_style("table_ucg_bethe")
"""

from __future__ import annotations

from lammps_ucg_dev_tpu_torch.fixes import (cluster_switch, integrate,
                                            langevin, ucgstate)
from lammps_ucg_dev_tpu_torch.models import (pair_bethe, pair_bethe_density,
                                             pair_rleucg, pair_ucgld)

PAIR_STYLES = {
    "table_ucgld": (pair_ucgld.compute, pair_ucgld.UCGLDParams),
    "table_ucg_bethe": (pair_bethe.compute, pair_bethe.make_params),
    "table_ucg_bethe_density": (pair_bethe_density.compute,
                                pair_bethe_density.make_params),
    "table_rleucg_interface": (pair_rleucg.compute, pair_rleucg.make_params),
}

# the dialect of each pair style's ``ucg.settings`` file
# (io/state_settings.parse_state_settings)
PAIR_DIALECTS = {
    "table_ucgld": "ucgld",
    "table_ucg_bethe": "bethe",
    "table_ucg_bethe_density": "bethe_density",
    "table_rleucg_interface": "rleucg",
}

FIX_STYLES = {
    "nve/ucgld": integrate.IntegratorCfg,
    "nve/ucgld/wall/hard": integrate.IntegratorCfg,
    "nve": integrate.IntegratorCfg,
    "ucgld/langevin": langevin.LangevinCfg,
    "langevin": langevin.VLangevinCfg,
    "ucgstate": ucgstate.UCGStateCfg,
    "cluster_switch": cluster_switch.make_params,
}


def pair_style(name: str):
    try:
        return PAIR_STYLES[name]
    except KeyError:
        raise ValueError(
            f"unknown pair style {name!r}; available: {sorted(PAIR_STYLES)}"
        ) from None


def fix_style(name: str):
    try:
        return FIX_STYLES[name]
    except KeyError:
        raise ValueError(
            f"unknown fix style {name!r}; available: {sorted(FIX_STYLES)}"
        ) from None
