"""erfc kernels matching the reference's polynomial approximants.

The reference uses the Abramowitz & Stegun 7.1.26 polynomial with the
constants EWALD_P/A1..A5 (fix_conp.cpp:53-60) and clamps the argument at
ERFC_MAX=5.8 (erfc(5.8) ~ 2^-52).  The same polynomial (not ``erfc``)
keeps A-matrix and b-vector entries equal to the reference's to double
roundoff, and the same clamp keeps its effective real-space cutoff
(fix_conp.cpp:1237-1238).  The CUDA kernels in ``csrc/`` evaluate the same
formulas.
"""

from __future__ import annotations

import torch

EWALD_F = 1.12837917        # 2/sqrt(pi)
EWALD_P = 0.3275911
A1 = 0.254829592
A2 = -0.284496736
A3 = 1.421413741
A4 = -1.453152027
A5 = 1.061405429
ERFC_MAX = 5.8


def erfcr_sqrt(a2_r2):
    """erfc(sqrt(a2_r2)) / sqrt(a2_r2), clamped to 0 beyond ERFC_MAX^2
    (FixConp::erfcr_sqrt, fix_conp.cpp:1446-1454).  For a pair term this is
    erfc(a*r)/(a*r); multiply by ``a`` to get erfc(a*r)/r."""
    safe = torch.clamp(a2_r2, min=1e-30)
    a_r = torch.sqrt(safe)
    expm2 = torch.exp(-safe)
    t = 1.0 / (1.0 + EWALD_P * a_r)
    val = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2 / a_r
    return torch.where(a2_r2 < ERFC_MAX * ERFC_MAX, val, torch.zeros_like(val))


def ferfcr_sqrt(a2_r2):
    """erfc(sqrt)/sqrt + (2/sqrt(pi))*exp(-a2_r2), clamped: the force kernel
    (FixConp::ferfcr_sqrt, fix_conp.cpp:1456-1465)."""
    safe = torch.clamp(a2_r2, min=1e-30)
    a_r = torch.sqrt(safe)
    expm2 = torch.exp(-safe)
    t = 1.0 / (1.0 + EWALD_P * a_r)
    erfcr = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2 / a_r
    val = erfcr + EWALD_F * expm2
    return torch.where(a2_r2 < ERFC_MAX * ERFC_MAX, val, torch.zeros_like(val))
