"""LAMMPS-compatible unit systems.

The reference package relies on the stock-LAMMPS ``Force`` constants
(``force->boltz``, ``force->ftm2v``, ``force->mvv2e``; see e.g.
``UCG/fix_nve_ucgld.cpp:38`` and
``UCG/fix_ucgld_langevin.cpp:164-171``).  This module provides
the same constants for the unit systems the reference is used with.

Values follow the published LAMMPS ``update.cpp`` unit tables.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    name: str
    boltz: float    # Boltzmann constant in energy/temperature units
    mvv2e: float    # mass * velocity^2 -> energy
    ftm2v: float    # force / mass * time -> velocity
    nktv2p: float   # N k T / volume -> pressure
    qqr2e: float    # q^2 / r -> energy (Coulomb prefactor)
    qe2f: float     # charge * E-field -> force
    dt_default: float


_SYSTEMS = {
    "lj": UnitSystem(
        name="lj", boltz=1.0, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
        qqr2e=1.0, qe2f=1.0, dt_default=0.005,
    ),
    "real": UnitSystem(
        name="real",
        boltz=0.0019872067,
        mvv2e=48.88821291 * 48.88821291,
        ftm2v=1.0 / 48.88821291 / 48.88821291,
        nktv2p=68568.415,
        qqr2e=332.06371,
        qe2f=23.060549,
        dt_default=1.0,
    ),
    "metal": UnitSystem(
        name="metal",
        boltz=8.617343e-5,
        mvv2e=1.0364269e-4,
        ftm2v=1.0 / 1.0364269e-4,
        nktv2p=1.6021765e6,
        qqr2e=14.399645,
        qe2f=1.0,
        dt_default=0.001,
    ),
    "si": UnitSystem(
        name="si", boltz=1.3806504e-23, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
        qqr2e=8.9876e9, qe2f=1.0, dt_default=1.0e-8,
    ),
    "cgs": UnitSystem(
        name="cgs", boltz=1.3806504e-16, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
        qqr2e=1.0, qe2f=1.0, dt_default=1.0e-8,
    ),
}


def get(name: str) -> UnitSystem:
    try:
        return _SYSTEMS[name]
    except KeyError:
        raise ValueError(
            f"Unknown unit system {name!r}; supported: {sorted(_SYSTEMS)}"
        ) from None


LJ = _SYSTEMS["lj"]
REAL = _SYSTEMS["real"]
METAL = _SYSTEMS["metal"]
