"""Workloads: (System, MDConfig, ConpConfig) ready for
``setup_conp`` / ``build_engine``.

* ``synthetic``: the self-contained parallel-plate capacitor of LJ ions.
* ``il_onelayer`` / ``il_twolayer`` / ``cond`` / ``zmirror``: the
  ionic-liquid reference decks (BMI-PF6 between graphene electrodes,
  SHAKE on the cation), every trial, read from a LAMMPS data file:
  ``data_path``, or the deck's ``data`` under ``ref_tests()``.  The trials
  cover CONP, CONQ and COND, the NORMAL slab, FFIELD with the external or
  the feedback efield, the NOSLAB doubled cell, EHGO with a callable
  target and the zmirror fix.
* ``write_il_data``: a synthetic data file with the il decks' counts and
  ids, which every one of these decks reads, for the tests and the card
  runs while the decks' own data files are not in the repository.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .models.system import build_system, electrodes_first
from .utils import data_io
from .utils.config import (ConpConfig, EhgoConfig, FFMode, KSpaceStyle,
                           MDConfig, Mode, PairMode, ShakeConfig,
                           ThermostatConfig, ZMirrorConfig)
from .utils.data_io import LammpsData
from .utils.units import get_units


def ref_tests() -> str:
    """The reference decks' directory (one subdirectory per deck, each with
    its ``data`` file): ``$CONP_REF_TESTS`` as it is when a deck is read
    (it points the port and the JAX package at the same place), else
    ``reference/tests`` beside the package."""
    return os.environ.get(
        "CONP_REF_TESTS",
        str(Path(__file__).resolve().parents[1] / "reference" / "tests"))


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


def near_sheet_positions(system, *, gap: float = 2.0, count: int = 8,
                         sep: float = 5.0) -> np.ndarray:
    """x0 with up to ``count`` one-atom electrolyte molecules (the il
    decks' anions) next to each electrode moved in z to ``gap`` Angstrom off
    that electrode's innermost sheet, x and y kept.  They are taken nearest
    the sheet first, skipping any within ``sep`` of one already taken in x
    and y, so that no two land on one another.

    The il decks keep every ion more than 4 A from the sheets, beyond the
    clamped Gaussian of the CONP correction (eta r < 5.8: r < 2.93 A at eta
    1.979), so at x0 every correction term is 0; these positions give the
    engine's correction nonzero terms on both walls."""
    x = np.array(system.x0, np.float64)
    ely = ~system.ele_mask
    mols, counts = np.unique(system.mol[ely], return_counts=True)
    idx = np.nonzero(ely & np.isin(system.mol, mols[counts == 1]))[0]
    z = x[:, 2]
    lxy = np.asarray(system.box[:2], np.float64)

    def take(order):
        chosen = []
        for i in idx[order]:
            d = x[chosen, :2] - x[i, :2]
            d -= lxy * np.round(d / lxy)
            if np.all(np.sum(d * d, axis=1) >= sep * sep):
                chosen.append(i)
                if len(chosen) == count:
                    break
        return np.asarray(chosen, np.int64)

    low, high = take(np.argsort(z[idx])), take(np.argsort(-z[idx]))
    x[low, 2] = z[system.ele_left_mask].max() + gap
    x[high, 2] = z[system.ele_right_mask].min() - gap
    return x


# --------------------------------------------------------------------------
# the ionic-liquid decks
# --------------------------------------------------------------------------

def _sol_thermostats(data, groups, doubled: bool, temp: float):
    """The decks' thermostats: one NHC on ``sol``, or for the doubled-cell
    trials two independent ones on its halves (il_onelayer/input:113-116
    ``fix 1 solpos nvt`` + ``fix 2 solneg nvt``), which this adds to
    ``groups``."""
    if not doubled:
        return (ThermostatConfig("sol", temp, temp, 100.0),)
    pos = data.x[:, 2] > 0.0
    groups["solpos"] = groups["sol"] & pos
    groups["solneg"] = groups["sol"] & ~pos
    return (ThermostatConfig("solpos", temp, temp, 100.0),
            ThermostatConfig("solneg", temp, temp, 100.0))


def _doubled_cell(data, molleft, molright, sym: bool, flip_vz: bool = False):
    """The NOSLAB doubled cell: ``replicate 1 1 2``, ``change_box`` to a
    z-centred box, and the molecule reassignment, symmetric (the upper half
    mirrored in z, its electrodes renumbered as the lower half's) or
    antisymmetric (tests/dilute/input:44-57, il_onelayer/input:34-47)."""
    molmax = int(data.mol.max())
    data = data_io.replicate_z2(data)
    data = data_io.change_box_z_centered(data)
    pos = data.x[:, 2] > 0.0
    if sym:
        data = data_io.mirror_group_z(data, pos, flip_vz=flip_vz)
        data = data_io.set_mol(data, molmax + molright, molright)
        data = data_io.set_mol(data, molmax + molleft, molleft)
    else:
        data = data_io.set_mol(data, molmax + molright, molleft)
        data = data_io.set_mol(data, molmax + molleft, molright)
    return data


def _il_groups(data):
    return {"sol": np.isin(data.type, [1, 2, 3, 4]),
            "bmi": np.isin(data.type, [1, 2, 3]),
            "ele": data.type == IL_ETYPE}


# the decks' electrode molecules and carbon type
IL_MOLLEFT, IL_MOLRIGHT, IL_ETYPE = 641, 642, 5
IL_SHAKE = ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,))


def il_onelayer(n: int = 0, *, data_path: Optional[str] = None):
    """tests/il_onelayer/input: BMI-PF6 and single-layer graphene, 3,776
    atoms (types 1-3 the cation sites, 4 the anion, 5 the electrodes; mol
    641 left, 642 right), SHAKE on the cation's two bonds and its angle,
    500 K NHC, read from ``data_path`` or the deck's ``data`` under
    ``ref_tests()``.  Every trial runs:

    0 CONP slab, EWALD, ETA at 2 V; 1 the same (+etypes, a no-op on the
    dense pair path); 2 CONQ slab with PPPM; 3 and 7 FFIELD (z periodic)
    with the external efield; 4 FFIELD, PPPM, EHGO (kappa 0) and a
    callable target (the deck's equal-style v_v); 5 and 6 the NOSLAB
    doubled cell (symmetric, antisymmetric), zneutr, a thermostat on each
    half."""
    if n not in range(8):
        raise ValueError(f"il_onelayer has trials 0-7, not {n}")
    data = data_io.parse_data_file(data_path or f"{ref_tests()}/il_onelayer/data")
    doubled = n in (5, 6)
    if doubled:
        data = _doubled_cell(data, IL_MOLLEFT, IL_MOLRIGHT, sym=(n == 5),
                             flip_vz=(n == 5))
    periodic = (True, True, n > 2)
    groups = _il_groups(data)
    thermos = _sol_thermostats(data, groups, doubled, 500.0)
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[IL_MOLLEFT], ele_right=[IL_MOLRIGHT], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    ff = FFMode.NORMAL
    mode = Mode.CONP
    target = v
    kspace = KSpaceStyle.EWALD
    if n in (3, 4, 7):
        ff = FFMode.FFIELD
    if n in (5, 6):
        ff = FFMode.NOSLAB
    if n == 2:
        mode = Mode.CONQ
        kspace = KSpaceStyle.PPPM
    pairmode = PairMode.ETA
    ehgo = None
    if n == 4:
        kspace = KSpaceStyle.PPPM
        # the deck drives trial 4 with the equal-style variable v_v
        # (il_onelayer/input:103): a callable target (fix_conp.cpp:112-117,
        # 1143)
        target = lambda step: v  # noqa: E731
        pairmode = PairMode.EHGO
        ehgo = EhgoConfig(kappa=0.0, eta_by_type=((IL_ETYPE, 1.979, None),))
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 2 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if ff is FFMode.FFIELD else None,
        thermostats=thermos, shake=IL_SHAKE)
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target, ff=ff,
                     zneutr=doubled, pairmode=pairmode, ehgo=ehgo,
                     kspace=kspace)
    return system, md, cfg


def il_twolayer(n: int = 0, *, data_path: Optional[str] = None):
    """tests/il_twolayer/input: the BASELINE.md north-star workload, the
    il_onelayer chemistry.  Every trial runs: 0 and 1 CONP slab; 2 and 5
    FFIELD with the external efield; 3 and 4 the NOSLAB doubled cell
    (symmetric, antisymmetric), zneutr, a thermostat on each half; CONP at
    2 V, EWALD, ETA."""
    if n not in range(6):
        raise ValueError(f"il_twolayer has trials 0-5, not {n}")
    data = data_io.parse_data_file(data_path or f"{ref_tests()}/il_twolayer/data")
    doubled = n in (3, 4)
    if doubled:
        data = _doubled_cell(data, IL_MOLLEFT, IL_MOLRIGHT, sym=(n == 3),
                             flip_vz=(n == 3))
    periodic = (True, True, n > 1)
    groups = _il_groups(data)
    thermos = _sol_thermostats(data, groups, doubled, 500.0)
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[IL_MOLLEFT], ele_right=[IL_MOLRIGHT], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    ff = {0: FFMode.NORMAL, 1: FFMode.NORMAL, 2: FFMode.FFIELD,
          3: FFMode.NOSLAB, 4: FFMode.NOSLAB, 5: FFMode.FFIELD}[n]
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 1 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if ff is FFMode.FFIELD else None,
        thermostats=thermos, shake=IL_SHAKE)
    cfg = ConpConfig(mode=Mode.CONP, nevery=1, eta=1.979, target=v, ff=ff,
                     zneutr=doubled)
    return system, md, cfg


def cond(n: int = 0, *, data_path: Optional[str] = None, suite: str = "cond"):
    """tests/cond/input: CONP, CONQ and COND on the il chemistry, 3,776
    atoms (``suite="cond2"``: the larger deck, Q = 50), PPPM.  0 CONP slab;
    1 CONQ slab (Q = 0.35); 2 CONP FFIELD with the external efield; 3 CONQ
    FFIELD with the feedback efield; 4 COND FFIELD with the feedback
    efield.  Reads ``data_path`` or the deck's ``data`` under
    ``ref_tests()``."""
    if n not in range(5):
        raise ValueError(f"cond has trials 0-4, not {n}")
    data = data_io.parse_data_file(data_path or f"{ref_tests()}/{suite}/data")
    periodic = (True, True, n > 1)
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[IL_MOLLEFT], ele_right=[IL_MOLRIGHT],
        groups=_il_groups(data))
    system = electrodes_first(system)

    v = 2.0
    qtarget = 50.0 if suite == "cond2" else 0.35
    mode = {0: Mode.CONP, 1: Mode.CONQ, 2: Mode.CONP, 3: Mode.CONQ,
            4: Mode.COND}[n]
    ff = FFMode.NORMAL if n <= 1 else FFMode.FFIELD
    target = v if mode is Mode.CONP else qtarget
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 1 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if n == 2 else None,
        efield_feedback=n in (3, 4),
        thermostats=(ThermostatConfig("sol", 500.0, 500.0, 100.0),),
        shake=IL_SHAKE)
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target, ff=ff,
                     kspace=KSpaceStyle.PPPM)
    return system, md, cfg


def zmirror(n: int = 0, *, data_path: Optional[str] = None):
    """tests/zmirror/input: the doubled cell's mirror-symmetry NEMD, NOSLAB
    and zneutr, the electrodes of both halves in one left and one right
    group (zmirror/input:49-50).  0 CONP, EWALD; 1 with PPPM; 2 with the
    zmirror fix (the upper half mirrors the lower one every step instead
    of being thermostatted); 3 CONQ (Q = 0.7) with zmirror.  Reads
    ``data_path`` or the deck's ``data`` under ``ref_tests()``."""
    if n not in range(4):
        raise ValueError(f"zmirror has trials 0-3, not {n}")
    data = data_io.parse_data_file(data_path or f"{ref_tests()}/zmirror/data")
    molmax = int(data.mol.max())
    data = _doubled_cell(data, IL_MOLLEFT, IL_MOLRIGHT, sym=True,
                         flip_vz=True)
    pos = data.x[:, 2] > 0.0
    groups = _il_groups(data)
    groups["solpos"] = groups["sol"] & pos
    groups["solneg"] = groups["sol"] & ~pos
    system = build_system(
        data, units="real", periodic=(True, True, True), mix="arithmetic",
        ele_left=[IL_MOLLEFT, IL_MOLLEFT + molmax],
        ele_right=[IL_MOLRIGHT, IL_MOLRIGHT + molmax], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    use_zm = n in (2, 3)
    mode = Mode.CONQ if n == 3 else Mode.CONP
    target = 2 * 0.35 if n == 3 else v
    thermostats = [ThermostatConfig("solneg", 500.0, 500.0, 100.0)]
    if not use_zm:
        thermostats.append(ThermostatConfig("solpos", 500.0, 500.0, 100.0))
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7, slab=None,
        thermostats=tuple(thermostats), shake=IL_SHAKE,
        zmirror=ZMirrorConfig("solneg", "solpos", 1) if use_zm else None)
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target,
                     ff=FFMode.NOSLAB, zneutr=True,
                     kspace=KSpaceStyle.PPPM if n >= 1 else KSpaceStyle.EWALD)
    return system, md, cfg


# --------------------------------------------------------------------------
# the synthetic ionic-liquid cell
# --------------------------------------------------------------------------

# Coarse-grained BMIm-PF6 after Roy & Maroncelli (J. Phys. Chem. B 114,
# 2010): per site (mass g/mol, eps kcal/mol, sigma A, charge e).  Cation
# sites 1 = methyl, 2 = imidazolium ring (the middle site), 3 = butyl; 4 =
# PF6.  The masses and charges (+0.78 e per ion pair, scaled) are the
# model's; eps is its kJ/mol value over 4.184.  Type 5 is graphene carbon
# with Steele's graphite LJ (12.011 g/mol, 0.0556 kcal/mol, 3.40 A).  The
# file lists every pair (PairIJ Coeffs) mixed as ``pair_modify mix
# arithmetic`` mixes them, except carbon-carbon, which is off: the walls are
# frozen, and their mutual LJ (~2e6 kcal/mol at 1.42 A bonds) would only
# bury the potential energy.
IL_SITES = {
    1: (15.04, 0.36 / 4.184, 3.41, 0.1578),
    2: (67.07, 2.56 / 4.184, 4.38, 0.4374),
    3: (57.12, 1.83 / 4.184, 5.04, 0.1848),
    4: (144.96, 4.71 / 4.184, 5.06, -0.78),
    5: (12.011, 0.0556, 3.40, 0.0),
}
# the rigid linear cation of this fixture: methyl-ring and ring-butyl bond
# lengths (A) and the 180-degree angle; the force constants (kcal/mol/A^2,
# kcal/mol/rad^2) only matter off the constraints
IL_BONDS = ((500.0, 1.80), (500.0, 2.50))
IL_ANGLE = (100.0, 180.0)
GRAPHENE_CELL = (2.46, 4.26)          # rectangular 4-atom cell (A)
GRAPHENE_SITES = ((0.0, 0.0), (0.5, 1.0 / 6.0), (0.5, 0.5), (0.0, 2.0 / 3.0))
SHEET_GAP = 3.35                      # graphite interlayer spacing (A)
WALL_OFFSET = 1.0                     # outer sheets to the box faces (A)
LIQUID_DENSITY = 1.3                  # g/cm^3
CARBON_SKIN = 1.7                     # half the carbon sigma at each wall (A)
ION_MARGIN = 4.0                      # ion centres to the inner sheets (A)
IL_TEMP = 500.0
AVOGADRO = 6.02214076e23


def _min_dist(points, others, lxy):
    """(T,) min over each candidate's points (T, P, 3) of the x/y
    minimum-image distance to ``others`` (Q, 3) (inf when Q = 0)."""
    if not len(others):
        return np.full(points.shape[0], np.inf)
    d = points[:, :, None, :] - others[None, None, :, :]
    for ax in (0, 1):
        d[..., ax] -= lxy[ax] * np.round(d[..., ax] / lxy[ax])
    return np.sqrt((d * d).sum(-1)).min(axis=(1, 2))


def write_il_data(path, *, n_pairs: int = 320, sheets: int = 3,
                  nx: int = 13, ny: int = 8, seed: int = 0) -> str:
    """Write a LAMMPS data file (atom style full) of BMI-PF6 between two
    graphene electrodes, in the il decks' types and ids, that
    ``il_onelayer`` and ``il_twolayer`` read; returns ``path``.

    Types 1-3 are the cation sites (bond type 1 between sites 1-2, type 2
    between 2-3, angle type 1 at 180 degrees; the positions satisfy the
    three constraints), 4 the anion, 5 the electrodes.  Ion molecules are
    numbered from 1 (cations first), skipping 641 and 642: the left
    electrode is mol 641 and the right 642.  Each wall has ``sheets`` graphene sheets of 4 nx ny atoms
    (AB-stacked, 3.35 A apart), lateral box 2.46 nx x 4.26 ny A.  The gap
    between the inner sheets holds the liquid at 1.3 g/cm^3 (its volume
    counted 1.7 A off each wall).  Pair coefficients as PairIJ Coeffs, the
    carbon-carbon LJ off.  Ion centres sit on a lattice at least 4 A
    from the inner sheets, species on alternate sites; each cation takes the
    one of 32 random orientations that keeps its sites farthest from every
    site placed so far.  Velocities are Maxwell-Boltzmann at 500 K over the
    ions' rigid-body degrees of freedom (centre of mass, and the cation's two
    rotations), with the electrolyte's net momentum removed; the electrodes
    are at rest.  Everything random comes from numpy ``default_rng(seed)``.

    The default is the size of the decks: 320 ion pairs and 3 sheets of 416
    atoms per wall, 3,776 atoms."""
    rng = np.random.default_rng(seed)
    units = get_units("real")
    lx, ly = nx * GRAPHENE_CELL[0], ny * GRAPHENE_CELL[1]
    area = lx * ly
    mass_pair = sum(IL_SITES[t][0] for t in (1, 2, 3, 4))
    vol = n_pairs * mass_pair / AVOGADRO / LIQUID_DENSITY * 1e24   # A^3
    gap = vol / area + 2 * CARBON_SKIN
    z_inner_left = WALL_OFFSET + (sheets - 1) * SHEET_GAP
    z_inner_right = z_inner_left + gap
    lz = z_inner_right + (sheets - 1) * SHEET_GAP + WALL_OFFSET

    # electrodes: sheet s of each wall, outer sheet first
    sheet = np.array([[(i + fx) * GRAPHENE_CELL[0], (j + fy) * GRAPHENE_CELL[1]]
                      for i in range(nx) for j in range(ny)
                      for fx, fy in GRAPHENE_SITES])
    walls = []
    for zs in ([WALL_OFFSET + s * SHEET_GAP for s in range(sheets)],
               [z_inner_right + s * SHEET_GAP for s in range(sheets)]):
        for s, z in enumerate(zs):
            shift = (0.0, GRAPHENE_CELL[1] / 3.0) if s % 2 else (0.0, 0.0)
            xy = (sheet + shift) % (lx, ly)
            walls.append(np.column_stack([xy, np.full(len(xy), z)]))
    nwall = sheets * len(sheet)
    ele_x = np.concatenate(walls)

    # ion centres: a lattice over the gap, species on alternate sites
    n_ions = 2 * n_pairs
    z0, z1 = z_inner_left + ION_MARGIN, z_inner_right - ION_MARGIN
    a0 = (area * (z1 - z0) / n_ions) ** (1.0 / 3.0)
    nlx, nly = max(1, round(lx / a0)), max(1, round(ly / a0))
    nlz = -(-n_ions // (nlx * nly))
    ijk = np.array([(i, j, k) for i in range(nlx) for j in range(nly)
                    for k in range(nlz)])
    ijk = ijk[np.sort(rng.permutation(len(ijk))[:n_ions])]
    centres = np.column_stack([
        (ijk[:, 0] + 0.5) * lx / nlx, (ijk[:, 1] + 0.5) * ly / nly,
        z0 + (ijk[:, 2] + 0.5) * (z1 - z0) / nlz])
    even = np.flatnonzero(ijk.sum(1) % 2 == 0)
    odd = np.flatnonzero(ijk.sum(1) % 2 == 1)
    order = np.concatenate([rng.permutation(even), rng.permutation(odd)])
    cat_c, an_c = centres[order[:n_pairs]], centres[order[n_pairs:]]

    # cations: sites along a unit vector, centred on the lattice point
    r12, r23 = IL_BONDS[0][1], IL_BONDS[1][1]
    offs = np.array([0.0, r12, r12 + r23]) - 0.5 * (r12 + r23)
    fixed = np.concatenate([ele_x, an_c])
    cat_x = np.zeros((n_pairs, 3, 3))
    axes = np.zeros((n_pairs, 3))
    reach = 0.5 * (r12 + r23) + 6.0       # sites that can be nearest
    for c in range(n_pairs):
        u = rng.standard_normal((32, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        cand = cat_c[c] + u[:, None, :] * offs[None, :, None]      # (32, 3, 3)
        others = np.concatenate([fixed, np.delete(cat_c, c, axis=0),
                                 cat_x[:c].reshape(-1, 3)])
        others = others[np.abs(others[:, 2] - cat_c[c, 2]) < reach]
        best = int(np.argmax(_min_dist(cand, others, (lx, ly))))
        cat_x[c], axes[c] = cand[best], u[best]
    cat_x[:, :, :2] %= (lx, ly)           # wrap into the box in x and y

    # rigid-body Maxwell-Boltzmann velocities (A/fs)
    kt = units.boltz * IL_TEMP
    m_cat = np.array([IL_SITES[t][0] for t in (1, 2, 3)])
    m_an = IL_SITES[4][0]
    sig = lambda m: np.sqrt(kt / (m * units.mvv2e))
    com_off = offs - (m_cat * offs).sum() / m_cat.sum()        # along u
    inertia = (m_cat * com_off ** 2).sum()
    cat_v = np.zeros((n_pairs, 3, 3))
    for c in range(n_pairs):
        u = axes[c]
        v_com = sig(m_cat.sum()) * rng.standard_normal(3)
        w = sig(inertia) * rng.standard_normal(3)
        w -= np.dot(w, u) * u                   # no spin about the axis
        cat_v[c] = v_com + np.cross(w, u)[None, :] * com_off[:, None]
    an_v = sig(m_an) * rng.standard_normal((n_pairs, 3))
    p_tot = (m_cat[None, :, None] * cat_v).sum((0, 1)) + m_an * an_v.sum(0)
    v_drift = p_tot / (n_pairs * mass_pair)
    cat_v -= v_drift
    an_v -= v_drift

    # atoms in file order: cations, anions, left wall, right wall
    x = np.concatenate([cat_x.reshape(-1, 3), an_c, ele_x])
    v = np.concatenate([cat_v.reshape(-1, 3), an_v, np.zeros_like(ele_x)])
    typ = np.concatenate([np.tile([1, 2, 3], n_pairs), np.full(n_pairs, 4),
                          np.full(2 * nwall, 5)])
    # ion molecules 1, 2, ... skipping the electrodes' 641 and 642 (the
    # decks' 640 ion molecules end just below them)
    ion_mol = np.arange(1, 2 * n_pairs + 1)
    ion_mol = ion_mol + 2 * (ion_mol >= 641)
    mol = np.concatenate([np.repeat(ion_mol[:n_pairs], 3), ion_mol[n_pairs:],
                          np.full(nwall, 641), np.full(nwall, 642)])
    q = np.array([IL_SITES[t][3] for t in typ])
    natoms = len(x)
    f = lambda val: f"{float(val):.17g}"
    lines = [
        f"BMI-PF6 between graphene electrodes, {natoms} atoms "
        f"(lammps_user_conp2_tpu_torch.workloads.write_il_data, seed {seed})",
        "", f"{natoms} atoms", "5 atom types", f"{2 * n_pairs} bonds",
        "2 bond types", f"{n_pairs} angles", "1 angle types", "",
        f"0.0 {f(lx)} xlo xhi", f"0.0 {f(ly)} ylo yhi",
        f"0.0 {f(lz)} zlo zhi", "", "Masses", ""]
    lines += [f"{t} {f(IL_SITES[t][0])}" for t in range(1, 6)]
    lines += ["", "PairIJ Coeffs # lj/cut/coul/long", ""]
    for a in range(1, 6):
        for b in range(a, 6):
            eps = 0.0 if a == b == 5 else math.sqrt(IL_SITES[a][1]
                                                    * IL_SITES[b][1])
            sig = 0.5 * (IL_SITES[a][2] + IL_SITES[b][2])
            lines.append(f"{a} {b} {f(eps)} {f(sig)}")
    lines += ["", "Bond Coeffs # harmonic", ""]
    lines += [f"{b + 1} {f(k)} {f(r0)}" for b, (k, r0) in enumerate(IL_BONDS)]
    lines += ["", "Angle Coeffs # harmonic", "",
              f"1 {f(IL_ANGLE[0])} {f(IL_ANGLE[1])}", "", "Atoms # full", ""]
    lines += [f"{i + 1} {mol[i]} {typ[i]} {f(q[i])} {f(x[i, 0])} "
              f"{f(x[i, 1])} {f(x[i, 2])}" for i in range(natoms)]
    lines += ["", "Velocities", ""]
    lines += [f"{i + 1} {f(v[i, 0])} {f(v[i, 1])} {f(v[i, 2])}"
              for i in range(natoms)]
    lines += ["", "Bonds", ""]
    for c in range(n_pairs):
        a = 3 * c + 1
        lines += [f"{2 * c + 1} 1 {a} {a + 1}", f"{2 * c + 2} 2 {a + 1} {a + 2}"]
    lines += ["", "Angles", ""]
    lines += [f"{c + 1} 1 {3 * c + 1} {3 * c + 2} {3 * c + 3}"
              for c in range(n_pairs)]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)
