"""Harmonic bond and angle forces (LAMMPS bond_style/angle_style harmonic).

E_bond = K (r - r0)^2 ; E_angle = K (theta - theta0)^2  (no 1/2 factors,
LAMMPS convention).  Static topology tensors.  Each atom's force is the
sum of the terms acting on it, taken in one fixed order through a table
built once per topology (``term_table``): a scatter with atomics would add
them in an order that changes from run to run on the card.
"""

from __future__ import annotations

import math

import torch

from .pairs import min_image


def term_rows(bonds, angles):
    """(M,) int64: the atom each term of ``bonded_terms`` acts on, in term
    order (the bonds' i rows, their j rows, then the angles' i, k and j
    rows)."""
    b = torch.as_tensor(bonds).reshape(-1, 3)
    a = torch.as_tensor(angles).reshape(-1, 4)
    return torch.cat([b[:, 1], b[:, 2], a[:, 1], a[:, 3], a[:, 2]]).long()


def term_table(bonds, angles, natoms):
    """(natoms, D) int64 table of the fixed-order force sum, on the device
    of ``bonds``: row a lists, in term order, the positions of the terms
    acting on atom a (``term_rows``), padded with the position M of the
    zero row appended after the M terms.  D is the largest number of terms
    on one atom (at least 1).  Built on the host: call it once per
    topology, before any CUDA-graph capture."""
    rows = term_rows(bonds, angles).cpu()
    m = rows.numel()
    counts = torch.bincount(rows, minlength=natoms)
    order = torch.argsort(rows, stable=True)
    atom = rows[order]
    slot = torch.arange(m) - (torch.cumsum(counts, 0) - counts)[atom]
    table = torch.full((natoms, max(int(counts.max()) if m else 0, 1)), m,
                       dtype=torch.int64)
    table[atom, slot] = order
    return table.to(torch.as_tensor(bonds).device)


def bonded_terms(x, bonds, bond_coeffs, angles, angle_coeffs, *, box,
                 periodic):
    """(vals (M, 3), e_bond+e_angle): each term's force on the atom
    ``term_rows`` names, in term order; bonds (NB,3) [type, i, j] and
    angles (NA,4) [type, i, j, k] are int64 tensors (j the central atom);
    coefficient tables [K, r0] and [K, theta0_deg]."""
    nb = bonds.shape[0]
    na = angles.shape[0]
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
        vals += [f1, f3, -(f1 + f3)]
    if not vals:
        return x.new_zeros((0, 3)), e
    return torch.cat(vals, dim=0), e


def bonded_forces(x, bonds, bond_coeffs, angles, angle_coeffs, *, box,
                  periodic, table=None):
    """Bond + angle forces (``bonded_terms``), each atom's terms summed in
    term order through ``table``, the topology's ``term_table`` (built
    here when None: a trip to the host, so the engine keeps its own).
    Returns (f, e_bond+e_angle)."""
    if bonds.shape[0] == 0 and angles.shape[0] == 0:
        return torch.zeros_like(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device)
    vals, e = bonded_terms(x, bonds, bond_coeffs, angles, angle_coeffs,
                           box=box, periodic=periodic)
    if table is None:
        table = term_table(bonds, angles, x.shape[0]).to(x.device)
    zero = torch.zeros((1, 3), dtype=x.dtype, device=x.device)
    return torch.cat([vals, zero])[table].sum(1), e
