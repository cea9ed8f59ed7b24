"""LAMMPS-compatible unit systems (only ``real`` is used by the reference decks).

The constant-potential solver works in "charge units": the A matrix has units
of 1/length, b has units of charge/length, and applied potentials in volts are
converted with ``EVSCALE = qe2f / qqr2e`` exactly as the reference does
(reference: fix_conp.cpp:412 ``evscale = force->qe2f/force->qqr2e``).

Values match LAMMPS 27May2021 ``update.cpp`` (units real).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    name: str
    boltz: float     # Boltzmann constant [energy/K]
    mvv2e: float     # mass*velocity^2 -> energy
    ftm2v: float     # force*time/mass -> velocity
    qqr2e: float     # charge^2/distance -> energy (Coulomb constant)
    qe2f: float      # charge*electric field -> force
    dt_default: float

    @property
    def evscale(self) -> float:
        """Volts -> internal potential units (reference: fix_conp.cpp:412)."""
        return self.qe2f / self.qqr2e


# LAMMPS `units real`: distances in Angstrom, time in fs, energy kcal/mol,
# charge in multiples of e, temperature K, electric field V/Angstrom.
REAL = Units(
    name="real",
    boltz=0.0019872067,
    mvv2e=48.88821291 * 48.88821291,
    ftm2v=1.0 / (48.88821291 * 48.88821291),
    qqr2e=332.06371,
    qe2f=23.060549,
    dt_default=1.0,
)

# LAMMPS `units metal`: Angstrom, ps, eV.
METAL = Units(
    name="metal",
    boltz=8.617343e-5,
    mvv2e=1.0364269e-4,
    ftm2v=1.0 / 1.0364269e-4,
    qqr2e=14.399645,
    qe2f=1.0,
    dt_default=0.001,
)

UNITS = {"real": REAL, "metal": METAL}


def get_units(name: str) -> Units:
    try:
        return UNITS[name]
    except KeyError:
        raise ValueError(f"unsupported unit system {name!r}; use one of {list(UNITS)}")
