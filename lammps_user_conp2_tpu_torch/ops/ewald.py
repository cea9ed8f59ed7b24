"""Classic Ewald setup (host) and the slab correction.

k-vectors are enumerated once on the host with the reference's
accuracy-driven kmax search (km_ewald.cpp:97-113, rms at km_ewald.cpp:277-283)
and Green's-function weights ``ug_k = (4 pi / V) exp(-k^2/4g^2)/k^2``
(km_ewald.cpp:366-381).  The per-step k-space sums run in factored form
(``ops/ewald_factored.py``).

The half-space enumeration convention matches LAMMPS: each +-k pair appears
once with an implicit factor 2 (carried in ``2*ug`` / ``ug_tot``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def ewald_rms(km: int, prd: float, natoms: int, q2: float, g_ewald: float) -> float:
    """Standard Ewald k-space RMS force error estimate
    (KSpaceModuleEwald::rms, km_ewald.cpp:277-283)."""
    natoms = max(natoms, 1)
    return (
        2.0 * q2 * g_ewald / prd
        * math.sqrt(1.0 / (math.pi * km * natoms))
        * math.exp(-(math.pi ** 2) * km * km / (g_ewald ** 2 * prd ** 2))
    )


def determine_g_ewald_box(accuracy: float, cutoff: float, natoms: int, q2: float,
                          xprd: float, yprd: float, zprd: float) -> float:
    """g_ewald from the LAMMPS formula (ewald.cpp:init / pppm.cpp:set_grid_global).

    ``accuracy`` is absolute (relative accuracy * two-charge force);
    ``q2 = qsqsum * qqr2e``."""
    natoms = max(natoms, 1)
    g = accuracy * math.sqrt(natoms * cutoff * xprd * yprd * zprd) / (2.0 * q2)
    if g >= 1.0:
        g = (1.35 - 0.15 * math.log(accuracy)) / cutoff
    else:
        g = math.sqrt(-math.log(g)) / cutoff
    return g


@dataclasses.dataclass(frozen=True)
class EwaldKSpace:
    """Static k-space tables (host numpy).

    ``kvecs`` holds the half-space k-vectors in Cartesian units (K, 3);
    ``ug`` the Green's weights; ``ug_tot = sum(2*ug)``."""
    g_ewald: float
    volume: float           # slab-corrected volume (V * slab_volfactor)
    slabflag: bool
    slab_volfactor: float
    box: tuple              # (xprd, yprd, zprd) -- physical box
    kxmax: int
    kymax: int
    kzmax: int
    kvecs: np.ndarray       # (K, 3) float64, Cartesian 2*pi*n/L
    ug: np.ndarray          # (K,)  float64
    ug_tot: float

    @property
    def kcount(self) -> int:
        return self.kvecs.shape[0]


def setup_ewald(*, box: tuple, accuracy_abs: float, g_ewald: float,
                natoms: int, q2: float, slabflag: bool = False,
                slab_volfactor: float = 1.0) -> EwaldKSpace:
    """Accuracy-driven kmax search + half-space k enumeration
    (KSpaceModuleEwald::conp_setup km_ewald.cpp:63-132, make_kvecs_ewald
    km_ewald.cpp:285-364)."""
    xprd, yprd, zprd = box
    zprd_slab = zprd * slab_volfactor if slabflag else zprd
    volume = xprd * yprd * zprd_slab
    unitk = np.array([2 * math.pi / xprd, 2 * math.pi / yprd, 2 * math.pi / zprd_slab])

    kmaxes = []
    for prd in (xprd, yprd, zprd_slab):
        km = 1
        while ewald_rms(km, prd, natoms, q2, g_ewald) > accuracy_abs:
            km += 1
        kmaxes.append(km)
    kxmax, kymax, kzmax = kmaxes

    gsqmx = max(
        (unitk[0] * kxmax) ** 2,
        (unitk[1] * kymax) ** 2,
        (unitk[2] * kzmax) ** 2,
    ) * 1.00001

    # Half-space enumeration: one of each +-pair. The set {(k,l,m)} with
    # (k>0) or (k==0 and l>0) or (k==0 and l==0 and m>0), |k_cart|^2 <= gsqmx.
    ks = np.arange(0, kxmax + 1)
    ls = np.arange(-kymax, kymax + 1)
    ms = np.arange(-kzmax, kzmax + 1)
    K, L, M = np.meshgrid(ks, ls, ms, indexing="ij")
    K, L, M = K.ravel(), L.ravel(), M.ravel()
    half = (K > 0) | ((K == 0) & (L > 0)) | ((K == 0) & (L == 0) & (M > 0))
    kc = np.stack([K * unitk[0], L * unitk[1], M * unitk[2]], axis=1)
    sqk = (kc ** 2).sum(axis=1)
    sel = half & (sqk <= gsqmx)
    kvecs = kc[sel]
    sqk = sqk[sel]
    # sort by |k| for a stable summation order
    order = np.argsort(sqk, kind="stable")
    kvecs = kvecs[order]
    sqk = sqk[order]

    preu = 4.0 * math.pi / volume
    ug = preu * np.exp(-0.25 * sqk / g_ewald ** 2) / sqk
    ug_tot = float((2.0 * ug).sum())

    return EwaldKSpace(
        g_ewald=g_ewald, volume=volume, slabflag=slabflag,
        slab_volfactor=slab_volfactor, box=(xprd, yprd, zprd),
        kxmax=kxmax, kymax=kymax, kzmax=kzmax, kvecs=kvecs, ug=ug,
        ug_tot=ug_tot,
    )


def slab_correction_energy_forces(x, q, volume):
    """Yeh-Berkowitz EW3DC slab correction (kspace_modify slab).

    E = (2 pi / V) M_z^2, F_z_i = -(4 pi / V) q_i M_z (neutral systems).
    ``volume`` must already include the slab volfactor."""
    mz = torch.sum(q * x[:, 2])
    e = 2.0 * math.pi / volume * mz * mz
    fz = -(4.0 * math.pi / volume) * q * mz
    f = torch.zeros_like(x)
    f[:, 2] = fz
    return e, f
