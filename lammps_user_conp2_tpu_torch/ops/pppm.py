"""PPPM grid and g_ewald selection (host only).

Only ``set_grid_and_gewald`` is ported so far: the CONP setup takes its
g_ewald from the LAMMPS pppm pipeline (pppm.cpp set_grid_global +
adjust_gewald) when none is given.  The mesh solver itself (spread,
Poisson solve, gather) is still to come.
"""

from __future__ import annotations

import math

import numpy as np

# Deserno & Holm ik-differentiation error coefficients (LAMMPS pppm.cpp acons)
ACONS = np.zeros((8, 7))
ACONS[1][0] = 2.0 / 3.0
ACONS[2][:2] = [1.0 / 50.0, 5.0 / 294.0]
ACONS[3][:3] = [1.0 / 588.0, 7.0 / 1440.0, 21.0 / 3872.0]
ACONS[4][:4] = [1.0 / 4320.0, 3.0 / 1936.0, 7601.0 / 2271360.0, 143.0 / 28800.0]
ACONS[5][:5] = [1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
                517231.0 / 106536960.0, 106640677.0 / 11737571328.0]
ACONS[6][:6] = [691.0 / 68140800.0, 13.0 / 57600.0, 47021.0 / 35512320.0,
                9694607.0 / 2095994880.0, 733191589.0 / 59609088000.0,
                326190917.0 / 11700633600.0]
ACONS[7][:7] = [1.0 / 345600.0, 3617.0 / 35512320.0, 745739.0 / 838397952.0,
                56399353.0 / 12773376000.0, 25091609.0 / 1560084480.0,
                1755948832039.0 / 36229939200000.0, 4887769399.0 / 37838389248.0]


def estimate_ik_error(h: float, prd: float, natoms: int, q2: float,
                      g_ewald: float, order: int) -> float:
    s = sum(ACONS[order][m] * (h * g_ewald) ** (2 * m) for m in range(order))
    return (q2 * (h * g_ewald) ** order
            * math.sqrt(g_ewald * prd * math.sqrt(2 * math.pi) * s / natoms)
            / (prd * prd))


def factorable(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def next_factorable(n: int) -> int:
    while not factorable(n):
        n += 1
    return n


def set_grid_and_gewald(*, box, accuracy_abs, natoms, q2, cutoff, order=5,
                        slab_volfactor=1.0, g_ewald=None, grid=None):
    """LAMMPS pppm.cpp set_grid_global + adjust_gewald, exactly.

    Returns (g_ewald, (nx, ny, nz_lammps), estimated_accuracy).  The z error
    estimate uses the physical zprd even under slab (LAMMPS behavior,
    validated vs tests/dilute/persist.log)."""
    xprd, yprd, zprd = box
    natoms = max(natoms, 1)
    if g_ewald is None:
        g0 = accuracy_abs * math.sqrt(natoms * cutoff * xprd * yprd * zprd) / (2.0 * q2)
        if g0 >= 1.0:
            g0 = (1.35 - 0.15 * math.log(accuracy_abs)) / cutoff
        else:
            g0 = math.sqrt(-math.log(g0)) / cutoff
    else:
        g0 = g_ewald

    if grid is None:
        ns = []
        for prd in (xprd, yprd, zprd):
            n = max(2, int(prd / (4.0 / g0)))
            while estimate_ik_error(prd / n, prd, natoms, q2, g0, order) > accuracy_abs:
                n += 1
            ns.append(next_factorable(n))
        nx, ny, nz = ns
    else:
        nx, ny, nz = grid

    def df_rspace(g):
        return (2.0 * q2 * math.exp(-g * g * cutoff * cutoff)
                / math.sqrt(natoms * cutoff * xprd * yprd * zprd))

    def df_kspace(g):
        l = [estimate_ik_error(p / n, p, natoms, q2, g, order)
             for p, n in ((xprd, nx), (yprd, ny), (zprd, nz))]
        return math.sqrt(sum(v * v for v in l)) / math.sqrt(3.0)

    g = g0
    if g_ewald is None:
        for _ in range(100):
            f = df_rspace(g) - df_kspace(g)
            h = 1e-6
            fp = (df_rspace(g + h) - df_kspace(g + h) - f) / h
            g -= f / fp
            if abs(df_rspace(g) - df_kspace(g)) < 1e-5:   # LAMMPS SMALL stop
                break
    est = math.sqrt(df_rspace(g) ** 2 + df_kspace(g) ** 2)
    return g, (nx, ny, nz), est
