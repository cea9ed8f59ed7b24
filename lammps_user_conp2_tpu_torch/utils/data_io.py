"""Contents of a LAMMPS data file (atom_style full) as numpy arrays.

Only the container is ported so far; the file parser and the deck
transforms (replicate, change_box, mirror) of the JAX package's
``utils/data_io.py`` are still to come.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LammpsData:
    """Parsed contents of a LAMMPS data file (atom ids remapped to 0-based,
    sorted by tag; ``tag`` preserves the original ids)."""
    natoms: int
    natomtypes: int
    box_lo: np.ndarray          # (3,)
    box_hi: np.ndarray          # (3,)
    tag: np.ndarray             # (N,) int64 original atom ids
    mol: np.ndarray             # (N,) int64
    type: np.ndarray            # (N,) int64, 1-based LAMMPS types
    q: np.ndarray               # (N,) float64
    x: np.ndarray               # (N, 3) float64
    v: np.ndarray               # (N, 3) float64
    mass_by_type: np.ndarray    # (ntypes+1,) float64, index 0 unused
    pair_coeffs: np.ndarray     # (ntypes+1, 2) [eps, sigma] per type (or zeros)
    pair_coeffs_ij: np.ndarray | None   # (ntypes+1, ntypes+1, 2) explicit, or None
    bond_coeffs: np.ndarray     # (nbondtypes+1, 2) [K, r0]
    angle_coeffs: np.ndarray    # (nangletypes+1, 2) [K, theta0_deg]
    bonds: np.ndarray           # (NB, 3) int64 [type, i, j] 0-based atom idx
    angles: np.ndarray          # (NA, 4) int64 [type, i, j, k]

    @property
    def box(self) -> tuple:
        d = self.box_hi - self.box_lo
        return (float(d[0]), float(d[1]), float(d[2]))
