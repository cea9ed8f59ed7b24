"""Workloads: (System, MDConfig, ConpConfig) ready for
``setup_conp`` / ``build_engine``.

Only the self-contained synthetic capacitor is ported; the reference decks
(dilute, il_onelayer, ...) need the data-file parser, which is still to
come.
"""

from __future__ import annotations

import numpy as np

from .models.system import build_system
from .utils.config import ConpConfig, FFMode, MDConfig, Mode, ThermostatConfig
from .utils.data_io import LammpsData


def synthetic(n_elyte: int = 64, nele_side: int = 4, *, lz: float = 30.0,
              lxy: float = 12.0):
    """Self-contained parallel-plate capacitor (no reference files needed):
    two square electrode walls + a lattice of +-1 LJ ions between them.
    Deterministic construction; electrodes come first in the atom order."""
    ne = nele_side * nele_side
    a = lxy / nele_side
    xs = []
    # left wall at z=2, right wall at z=lz-2
    for side, z in ((0, 2.0), (1, lz - 2.0)):
        for i in range(nele_side):
            for j in range(nele_side):
                xs.append([a * (i + 0.5), a * (j + 0.5), z])
    # ion lattice in between (alternating charges)
    m = int(np.ceil(n_elyte ** (1.0 / 3.0)))
    count = 0
    for i in range(m):
        for j in range(m):
            for k in range(m):
                if count >= n_elyte:
                    break
                xs.append([
                    lxy * (i + 0.5) / m,
                    lxy * (j + 0.5) / m,
                    6.0 + (lz - 12.0) * (k + 0.5) / m,
                ])
                count += 1
    x = np.array(xs)
    nat = len(x)
    typ = np.concatenate([np.full(2 * ne, 3), 1 + (np.arange(n_elyte) % 2)])
    q = np.concatenate([np.zeros(2 * ne),
                        np.where(np.arange(n_elyte) % 2 == 0, 1.0, -1.0)])
    mol = np.concatenate([np.full(ne, 1), np.full(ne, 2),
                          3 + np.arange(n_elyte)])
    data = LammpsData(
        natoms=nat, natomtypes=3,
        box_lo=np.zeros(3), box_hi=np.array([lxy, lxy, lz]),
        tag=np.arange(1, nat + 1), mol=mol, type=typ, q=q, x=x,
        v=np.zeros((nat, 3)),
        mass_by_type=np.array([0.0, 23.0, 35.5, 12.0]),
        pair_coeffs=np.array([[0, 0], [0.1, 2.5], [0.1, 3.4], [0.05, 3.4]]),
        pair_coeffs_ij=None,
        bond_coeffs=np.zeros((1, 2)), angle_coeffs=np.zeros((1, 2)),
        bonds=np.zeros((0, 3), np.int64), angles=np.zeros((0, 4), np.int64),
    )
    groups = {"sol": typ != 3, "ele": typ == 3}
    system = build_system(
        data, units="real", periodic=(True, True, False), mix="arithmetic",
        ele_left=[1], ele_right=[2], groups=groups)
    md = MDConfig(
        units="real", dt=1.0, cutoff=5.0, kspace_accuracy=1e-4, slab=3.0,
        thermostats=(ThermostatConfig("sol", 300.0, 300.0, 100.0),),
    )
    cfg = ConpConfig(mode=Mode.CONP, nevery=1, eta=1.979, target=1.0,
                     ff=FFMode.NORMAL)
    return system, md, cfg


def near_wall_positions(system, *, margin: float = 5.0, jitter: float = 0.05,
                        seed: int = 0) -> np.ndarray:
    """x0 with the electrolyte z coordinates mapped linearly onto
    [margin, lz - margin], plus a Gaussian jitter of ``jitter`` Angstrom on
    every electrolyte coordinate (numpy ``default_rng(seed)``).

    ``synthetic`` keeps every ion more than a cutoff away from the walls, so
    at x0 the electrode real-space rows and the Gaussian correction are
    exactly zero; these positions put ions within the cutoff of both
    walls."""
    x = np.array(system.x0, np.float64)
    ely = ~system.ele_mask
    lz = system.box[2]
    z = x[ely, 2]
    x[ely, 2] = margin + (z - z.min()) / (z.max() - z.min()) * (lz - 2 * margin)
    rng = np.random.default_rng(seed)
    x[ely] += jitter * rng.standard_normal((int(ely.sum()), 3))
    return x
