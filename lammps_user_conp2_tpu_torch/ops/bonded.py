"""Harmonic bond and angle forces (LAMMPS bond_style/angle_style harmonic).

E_bond = K (r - r0)^2 ; E_angle = K (theta - theta0)^2  (no 1/2 factors,
LAMMPS convention).  Static topology tensors; one index_add gathers every
contribution.
"""

from __future__ import annotations

import math

import torch

from .pairs import min_image


def bonded_forces(x, bonds, bond_coeffs, angles, angle_coeffs, *, box,
                  periodic):
    """Bond + angle forces.  bonds (NB,3) [type, i, j] and angles (NA,4)
    [type, i, j, k] are int64 tensors (j the central atom); coefficient
    tables [K, r0] and [K, theta0_deg].  Returns (f, e_bond+e_angle)."""
    nb = bonds.shape[0]
    na = angles.shape[0]
    if nb == 0 and na == 0:
        return torch.zeros_like(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device)
    rows = []
    vals = []
    e = torch.zeros((), dtype=x.dtype, device=x.device)
    if nb:
        bt, i, j = bonds[:, 0], bonds[:, 1], bonds[:, 2]
        k = bond_coeffs[bt, 0]
        r0 = bond_coeffs[bt, 1]
        dx = min_image(x[i] - x[j], box, periodic)
        r = torch.sqrt(torch.sum(dx * dx, dim=-1))
        dr = r - r0
        e = e + torch.sum(k * dr * dr)
        fmag = torch.where(r > 0, -2.0 * k * dr / r, torch.zeros_like(r))
        fij = fmag[:, None] * dx
        rows += [i, j]
        vals += [fij, -fij]
    if na:
        at = angles[:, 0]
        i, j, k = angles[:, 1], angles[:, 2], angles[:, 3]
        ka = angle_coeffs[at, 0]
        t0 = angle_coeffs[at, 1] * (math.pi / 180.0)
        d1 = min_image(x[i] - x[j], box, periodic)
        d2 = min_image(x[k] - x[j], box, periodic)
        r1sq = torch.sum(d1 * d1, dim=-1)
        r2sq = torch.sum(d2 * d2, dim=-1)
        r1 = torch.sqrt(r1sq)
        r2 = torch.sqrt(r2sq)
        c = torch.clamp(torch.sum(d1 * d2, dim=-1) / (r1 * r2), -1.0, 1.0)
        # LAMMPS angle_harmonic guards sin near zero (SMALL=0.001)
        s = torch.clamp(torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)),
                        min=0.001)
        dtheta = torch.arccos(c) - t0
        e = e + torch.sum(ka * dtheta * dtheta)
        a = -2.0 * ka * dtheta / s
        a11 = a * c / r1sq
        a12 = -a / (r1 * r2)
        a22 = a * c / r2sq
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        rows += [i, k, j]
        vals += [f1, f3, -(f1 + f3)]
    f = torch.zeros_like(x).index_add(0, torch.cat(rows),
                                      torch.cat(vals, dim=0))
    return f, e
