"""SHAKE / RATTLE holonomic constraints (LAMMPS fix shake semantics).

The ionic-liquid decks constrain the 3-site BMI cation (bond types 1, 2
and the 180-degree angle: ``fix bmishake bmi shake 0.0001 10 0 t 1 2 3 b 1
2 a 1``), making each cation a rigid linear rotor.  An angle constraint
becomes the 1-3 distance by the law of cosines (LAMMPS shake3angle).

The constraints are grouped at setup into their disjoint clusters (at most
4 atoms and 6 constraints, the LAMMPS cluster shapes) by union-find on the
host; the cluster tables go to the device once, as buffers of
:class:`ShakeConstraints`.  ``shake_positions`` and ``rattle_velocities``
(``ops/kernels/shake_kernel.py``) run a fixed 12 Gauss-Seidel sweeps over
each cluster's constraint slots: the K7/K8 CUDA kernels on the card, the
plain PyTorch versions on the CPU.  ``ShakeConfig.tol`` and ``maxiter``
are not read, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.kernels.shake_kernel import free_rows, pack_records
from ..ops.pairs import min_image
from ..utils.device import DEFAULT_DTYPE, resolve_device

MAX_CLUSTER_ATOMS = 4
MAX_CLUSTER_CONSTRAINTS = 6


class ShakeConstraints(nn.Module):
    """Cluster-batched constraint tables, as device buffers.

    atoms (M, K) int32 global rows (padding repeats column 0); amask (M, K)
    bool valid; ci, cj (M, C) int32 cluster-local columns of each
    constraint's pair; dist2 (M, C) target squared distances (1 in
    padding); cmask (M, C) bool; invm (M, K) inverse masses (0 in padding).
    ``pair_atoms`` (ncons, 2) stays on the host.  For the K7/K8 kernels,
    built once here: ``rec`` (M, W) int32, the packed cluster records, and
    ``code``, the slot code all clusters share or -1
    (``shake_kernel.pack_records``); ``free_rows`` int32, the rows of the
    ``natoms`` atoms in no cluster (``shake_kernel.free_rows``)."""

    def __init__(self, atoms, amask, ci, cj, dist2, cmask, invm, pair_atoms,
                 *, natoms, dtype, device):
        super().__init__()
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        b = lambda a: torch.as_tensor(a, dtype=torch.bool, device=device)
        self.register_buffer("atoms", i32(atoms))
        self.register_buffer("amask", b(amask))
        self.register_buffer("ci", i32(ci))
        self.register_buffer("cj", i32(cj))
        self.register_buffer("dist2", f(dist2))
        self.register_buffer("cmask", b(cmask))
        self.register_buffer("invm", f(invm))
        rec, self.code = pack_records(atoms, amask, ci, cj, dist2, cmask,
                                      invm)
        self.register_buffer("rec", i32(rec))
        self.register_buffer("free_rows", i32(free_rows(atoms, amask,
                                                        natoms)))
        # the plain versions' write-back: the flat (M*K) entries of the
        # valid columns and their atom rows, int64
        flat = np.flatnonzero(np.asarray(amask))
        self.register_buffer("valid_flat", torch.as_tensor(
            flat, dtype=torch.int64, device=device))
        self.register_buffer("valid_rows", torch.as_tensor(
            np.asarray(atoms).reshape(-1)[flat], dtype=torch.int64,
            device=device))
        self.natoms = natoms
        self.pair_atoms = np.asarray(pair_atoms, np.int64)
        self.ncons = len(self.pair_atoms)

    def n_in_group(self, gmask) -> int:
        """Constraints removed from a group's DOF count: a constraint counts
        when BOTH its atoms are in the group."""
        gmask = np.asarray(gmask)
        p = self.pair_atoms
        return int((gmask[p[:, 0]] & gmask[p[:, 1]]).sum())

    @property
    def nclusters(self) -> int:
        return self.atoms.shape[0]


def build_constraints(system, shake_cfg, *, dtype=DEFAULT_DTYPE,
                      device=None):
    """The cluster tables from the topology and a ShakeConfig (bond types,
    angle types, group), on ``device`` (None: the card); None when there is
    nothing to constrain."""
    if shake_cfg is None:
        return None
    device = resolve_device(device)
    gmask = system.groups[shake_cfg.group]
    pairs = []
    d0 = []
    bond_r0 = {int(t): system.bond_coeffs[t, 1]
               for t in range(len(system.bond_coeffs))}
    bonded = {}
    for (t, i, j) in system.bonds:
        if int(t) in shake_cfg.btypes and gmask[i] and gmask[j]:
            pairs.append((int(i), int(j)))
            d0.append(bond_r0[int(t)])
        bonded[(int(i), int(j))] = bond_r0[int(t)]
        bonded[(int(j), int(i))] = bond_r0[int(t)]
    for (t, i, j, k) in system.angles:
        if int(t) in shake_cfg.atypes and gmask[i] and gmask[j] and gmask[k]:
            r1 = bonded[(int(i), int(j))]
            r2 = bonded[(int(j), int(k))]
            th = system.angle_coeffs[int(t), 1] * math.pi / 180.0
            pairs.append((int(i), int(k)))
            d0.append(math.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * math.cos(th)))
    if not pairs:
        return None

    # connected components of the constraint graph -> clusters
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    for (i, j) in pairs:
        parent.setdefault(i, i)
        parent.setdefault(j, j)
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    clusters = {}
    for idx, (i, _) in enumerate(pairs):
        clusters.setdefault(find(i), []).append(idx)

    K = max(len({a for c in cons for a in pairs[c]})
            for cons in clusters.values())
    C = max(len(cons) for cons in clusters.values())
    if K > MAX_CLUSTER_ATOMS or C > MAX_CLUSTER_CONSTRAINTS:
        raise ValueError(f"shake cluster too large (K={K}, C={C}); LAMMPS "
                         "supports <=4 atoms per cluster")
    M = len(clusters)
    atoms = np.zeros((M, K), np.int64)
    amask = np.zeros((M, K), bool)
    ci = np.zeros((M, C), np.int64)
    cj = np.zeros((M, C), np.int64)
    dist2 = np.ones((M, C))
    cmask = np.zeros((M, C), bool)
    for m, cons in enumerate(clusters.values()):
        local = []
        for c in cons:
            for a in pairs[c]:
                if a not in local:
                    local.append(a)
        atoms[m, :len(local)] = local
        atoms[m, len(local):] = local[0]        # pad with the first atom
        amask[m, :len(local)] = True
        for s, c in enumerate(cons):
            i, j = pairs[c]
            ci[m, s] = local.index(i)
            cj[m, s] = local.index(j)
            dist2[m, s] = d0[c] ** 2
            cmask[m, s] = True
    invm = np.where(amask, 1.0 / system.mass[atoms], 0.0)
    return ShakeConstraints(atoms, amask, ci, cj, dist2, cmask, invm, pairs,
                            natoms=system.natoms, dtype=dtype, device=device)


def constraint_residuals(cons: ShakeConstraints, x, *, box,
                         periodic) -> list:
    """Per constraint slot, max |r^2 - d^2| / d^2 over the clusters at x
    (slots in build order: the bonds, then the angles' 1-3 distances)."""
    a = cons.atoms.long()
    rows = torch.arange(a.shape[0], device=a.device)
    out = []
    for s in range(cons.ci.shape[1]):
        xi = x[a[rows, cons.ci[:, s].long()]]
        xj = x[a[rows, cons.cj[:, s].long()]]
        d = min_image(xi - xj, box, periodic).double()
        r2 = torch.sum(d * d, dim=1)
        d2 = cons.dist2[:, s].double()
        err = torch.where(cons.cmask[:, s], (r2 - d2).abs() / d2,
                          torch.zeros_like(r2))
        out.append(float(err.max()))
    return out
