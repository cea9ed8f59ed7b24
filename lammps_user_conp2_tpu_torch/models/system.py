"""System (static topology/metadata) and MDState (dynamic tensors and the
derived per-step structures: the Verlet list and the mesh tile binning).

Electrode membership is static, so every index map is a fixed host array
computed once (the reference's per-reneighbor ele2tag cross-maps,
fix_conp.h:164-188, disappear).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.data_io import LammpsData
from ..utils.units import get_units


@dataclasses.dataclass
class MDState:
    """Dynamic simulation state, all tensors on the engine's device."""
    x: torch.Tensor          # (N, 3) positions
    v: torch.Tensor          # (N, 3) velocities
    q: torch.Tensor          # (N,) charges (electrode entries re-solved per step)
    f: torch.Tensor          # (N, 3) forces of the current step
    step: int
    nhc_xi: torch.Tensor     # (n_thermostats, tchain) thermostat positions
    nhc_vxi: torch.Tensor    # (n_thermostats, tchain) thermostat velocities
    scalar_out: torch.Tensor  # () the fix scalar f_e
    energy: torch.Tensor     # () potential energy of the current configuration
    nbr: Optional[object] = None   # ops.neighbors.NeighborList (Verlet path)
    tasg: Optional[object] = None  # ops.pppm.TileAssign (persistent mesh tiles)
    # the step as a () int64 tensor on the state's device, advanced with
    # ``step`` by every step, eager or replayed: what callable targets and
    # zmirror's period read inside the step's CUDA graphs
    step_t: Optional[torch.Tensor] = None


@dataclasses.dataclass
class System:
    """Host-side static description: topology, groups, coefficients.
    All arrays numpy."""
    units_name: str
    box_lo: np.ndarray
    box_hi: np.ndarray
    periodic: tuple            # (bool, bool, bool); z False for `boundary p p f`
    tag: np.ndarray
    mol: np.ndarray
    type: np.ndarray           # (N,) 1-based
    mass: np.ndarray           # (N,) per-atom mass
    q0: np.ndarray             # (N,) initial charges
    x0: np.ndarray
    v0: np.ndarray
    bonds: np.ndarray          # (NB, 3) [type, i, j]
    angles: np.ndarray         # (NA, 4) [type, i, j, k]
    bond_coeffs: np.ndarray
    angle_coeffs: np.ndarray
    lj_eps: np.ndarray         # (ntypes+1, ntypes+1) mixed tables
    lj_sigma: np.ndarray
    groups: dict               # name -> bool mask
    ele_left_mask: np.ndarray   # bool (N,)
    ele_right_mask: np.ndarray  # bool (N,)
    mobile_mask: np.ndarray     # atoms integrated (non-electrode typically)

    @property
    def natoms(self) -> int:
        return len(self.tag)

    @property
    def ntypes(self) -> int:
        return self.lj_eps.shape[0] - 1

    @property
    def box(self) -> tuple:
        d = self.box_hi - self.box_lo
        return (float(d[0]), float(d[1]), float(d[2]))

    @property
    def ele_mask(self) -> np.ndarray:
        return self.ele_left_mask | self.ele_right_mask

    @property
    def elecheck(self) -> np.ndarray:
        """+1 left electrode, -1 right, 0 electrolyte (fix_conp.cpp:599-605)."""
        return (self.ele_left_mask.astype(np.int32)
                - self.ele_right_mask.astype(np.int32))

    def units(self):
        return get_units(self.units_name)


def mix_pair_coeffs(data: LammpsData, mix: str = "arithmetic"):
    """Build (ntypes+1, ntypes+1) eps/sigma tables.

    Explicit PairIJ-style coefficients take precedence; otherwise per-type
    Pair Coeffs are mixed (`pair_modify mix arithmetic`: geometric eps,
    arithmetic sigma)."""
    nt = data.natomtypes
    eps = np.zeros((nt + 1, nt + 1))
    sig = np.zeros((nt + 1, nt + 1))
    if data.pair_coeffs_ij is not None:
        eps = data.pair_coeffs_ij[:, :, 0].copy()
        sig = data.pair_coeffs_ij[:, :, 1].copy()
    for i in range(1, nt + 1):
        for j in range(1, nt + 1):
            if eps[i, j] == 0.0 and sig[i, j] == 0.0:
                ei, si = data.pair_coeffs[i]
                ej, sj = data.pair_coeffs[j]
                eps[i, j] = np.sqrt(ei * ej)
                if mix == "arithmetic":
                    sig[i, j] = 0.5 * (si + sj)
                elif mix == "geometric":
                    sig[i, j] = np.sqrt(si * sj)
                else:
                    raise ValueError(f"unknown mix {mix}")
    return eps, sig


def build_system(
    data: LammpsData,
    *,
    units: str = "real",
    periodic: tuple = (True, True, True),
    mix: str = "arithmetic",
    pair_coeff_overrides: Optional[list] = None,   # [(i, j, eps, sigma), ...]
    ele_left: Optional[np.ndarray] = None,         # molecule-id list or mask
    ele_right: Optional[np.ndarray] = None,
    groups: Optional[dict] = None,
) -> System:
    eps, sig = mix_pair_coeffs(data, mix)
    if pair_coeff_overrides:
        for (i, j, e, s) in pair_coeff_overrides:
            eps[i, j] = eps[j, i] = e
            sig[i, j] = sig[j, i] = s

    def as_mask(spec):
        if spec is None:
            return np.zeros(data.natoms, bool)
        spec = np.asarray(spec)
        if spec.dtype == bool:
            return spec
        return np.isin(data.mol, spec)

    lmask = as_mask(ele_left)
    rmask = as_mask(ele_right)
    if lmask.any() and (lmask == rmask).all():
        # one-electrode setup: the reference detects group1 == group2
        # (fix_conp.cpp:295) and defers the projection until after setq
        rmask = np.zeros_like(rmask)
    elif (lmask & rmask).any():
        raise ValueError("an atom is in both electrode groups")

    return System(
        units_name=units,
        box_lo=data.box_lo.copy(),
        box_hi=data.box_hi.copy(),
        periodic=periodic,
        tag=data.tag.copy(),
        mol=data.mol.copy(),
        type=data.type.copy(),
        mass=data.mass_by_type[data.type],
        q0=data.q.copy(),
        x0=data.x.copy(),
        v0=data.v.copy(),
        bonds=data.bonds.copy(),
        angles=data.angles.copy(),
        bond_coeffs=data.bond_coeffs.copy(),
        angle_coeffs=data.angle_coeffs.copy(),
        lj_eps=eps,
        lj_sigma=sig,
        groups=dict(groups or {}),
        ele_left_mask=lmask,
        ele_right_mask=rmask,
        mobile_mask=~(lmask | rmask),
    )


def reorder_atoms(system: System, perm: np.ndarray) -> System:
    """Return a System with atoms permuted by ``perm`` (new row k = old row
    perm[k]).  Topology indices are remapped; tags travel with their atoms."""
    perm = np.asarray(perm)
    n = len(perm)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    bonds = system.bonds.copy()
    if len(bonds):
        bonds[:, 1:] = inv[bonds[:, 1:]]
    angles = system.angles.copy()
    if len(angles):
        angles[:, 1:] = inv[angles[:, 1:]]
    return dataclasses.replace(
        system,
        tag=system.tag[perm], mol=system.mol[perm], type=system.type[perm],
        mass=system.mass[perm], q0=system.q0[perm], x0=system.x0[perm],
        v0=system.v0[perm], bonds=bonds, angles=angles,
        groups={k: np.asarray(v)[perm] for k, v in system.groups.items()},
        ele_left_mask=system.ele_left_mask[perm],
        ele_right_mask=system.ele_right_mask[perm],
        mobile_mask=system.mobile_mask[perm],
    )


def electrodes_first(system: System) -> System:
    """Stable-reorder atoms so the electrode group occupies rows [0, Ne):
    every per-step electrode access becomes a slice instead of a gather."""
    ele = np.asarray(system.ele_mask)
    ne = int(ele.sum())
    if ne == 0 or bool(ele[:ne].all()):
        return system
    return reorder_atoms(system, np.argsort(~ele, kind="stable"))


def exclusion_lists(system: System):
    """Compact special-bond exclusions: (excl_idx, excl_val) of shape (N, m).

    excl_idx[i] lists atoms whose pair factor with i differs from 1.0
    (padded with N); excl_val holds the factor (0.0 for LAMMPS default
    special_bonds)."""
    n = system.natoms
    ex = [dict() for _ in range(n)]
    adj = [set() for _ in range(n)]
    for (_, i, j) in system.bonds:
        ex[i][int(j)] = 0.0
        ex[j][int(i)] = 0.0
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    # 1-3 pairs from bond connectivity (LAMMPS special_bonds semantics)
    for j in range(n):
        nb = sorted(adj[j])
        for ai in range(len(nb)):
            for bi in range(ai + 1, len(nb)):
                a, b = nb[ai], nb[bi]
                ex[a][b] = 0.0
                ex[b][a] = 0.0
    # angles additionally (covers angle-defined triples not sharing bonds)
    for (_, i, j, k) in system.angles:
        for (a, b) in ((i, j), (j, k), (i, k)):
            ex[int(a)][int(b)] = 0.0
            ex[int(b)][int(a)] = 0.0
    m = max(1, max(len(e) for e in ex) if n else 1)
    idx = np.full((n, m), n, np.int32)
    val = np.zeros((n, m))
    for i, e in enumerate(ex):
        for c, (j, v) in enumerate(sorted(e.items())):
            idx[i, c] = j
            val[i, c] = v
    return idx, val
