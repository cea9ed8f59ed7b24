"""Reader for LAMMPS ``read_data`` files (atom_style full).

``parse_data_file`` reads a data file (the reference decks' ``data``
files, or the synthetic ionic-liquid cell of ``workloads.write_il_data``)
into a :class:`LammpsData` of numpy arrays: atom ids remapped to 0-based
rows sorted by tag, topology remapped to those rows.  Sections: Masses,
Pair Coeffs, PairIJ Coeffs, Bond Coeffs, Angle Coeffs, Atoms, Velocities,
Bonds, Angles; Dihedral/Improper Coeffs are skipped, and Dihedrals or
Impropers with entries raise, as in the JAX package's parser.

``parse_data_file`` takes the port's host library first
(``utils/native.parse_data_native``, ``csrc/conp2_native.cpp``), as the
JAX package's does, and ``parse_data_file_py`` (the JAX package's Python
parser) without it or with ``use_native=False``: the plain version the
library is held to, field for field.  The deck
transforms of the doubled-cell trials follow it: ``replicate_z2``
(``replicate 1 1 2``), ``change_box_z_centered`` (``change_box``),
``mirror_group_z`` (the z-mirror ``set``) and ``set_mol`` (the molecule
reassignment).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_HEADER_KEYS = [
    ("atoms", "natoms"),
    ("bonds", "nbonds"),
    ("angles", "nangles"),
    ("dihedrals", "ndihedrals"),
    ("impropers", "nimpropers"),
    ("atom types", "natomtypes"),
    ("bond types", "nbondtypes"),
    ("angle types", "nangletypes"),
    ("dihedral types", "ndihedraltypes"),
    ("improper types", "nimpropertypes"),
]

_SECTIONS = {
    "Masses", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs", "Angle Coeffs",
    "Dihedral Coeffs", "Improper Coeffs", "Atoms", "Velocities", "Bonds",
    "Angles", "Dihedrals", "Impropers",
}


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


def _strip(line: str) -> str:
    i = line.find("#")
    if i >= 0:
        line = line[:i]
    return line.strip()


def _finalize_raw(f: dict) -> LammpsData:
    """Sort the atoms by tag and remap the topology's atom ids to 0-based
    rows (the reference needs contiguous ids too)."""
    order = np.argsort(f["tag"], kind="stable")
    inv = {int(f["tag"][o]): k for k, o in enumerate(order)}
    bonds = f["bonds"].copy()
    angles = f["angles"].copy()
    if len(bonds):
        bonds[:, 1] = [inv[int(t)] for t in bonds[:, 1]]
        bonds[:, 2] = [inv[int(t)] for t in bonds[:, 2]]
    if len(angles):
        for c in (1, 2, 3):
            angles[:, c] = [inv[int(t)] for t in angles[:, c]]
    return LammpsData(
        natoms=f["natoms"], natomtypes=f["natomtypes"],
        box_lo=f["box_lo"], box_hi=f["box_hi"],
        tag=f["tag"][order], mol=f["mol"][order], type=f["type"][order],
        q=f["q"][order], x=f["x"][order], v=f["v"][order],
        mass_by_type=f["mass_by_type"], pair_coeffs=f["pair_coeffs"],
        pair_coeffs_ij=f.get("pair_coeffs_ij"),
        bond_coeffs=f["bond_coeffs"], angle_coeffs=f["angle_coeffs"],
        bonds=bonds, angles=angles,
    )


def _read_header(lines):
    """(header counts, box_lo, box_hi, index of the first section line)."""
    header = {}
    box_lo = np.zeros(3)
    box_hi = np.zeros(3)
    for i in range(1, len(lines)):          # line 0 is the title
        raw = lines[i]
        s = _strip(raw)
        if not s:
            continue
        if raw.split("#")[0].strip() in _SECTIONS:
            return header, box_lo, box_hi, i
        m = re.match(r"^([-\d.eE+]+)\s+([-\d.eE+]+)\s+(xlo xhi|ylo yhi|zlo zhi)$",
                     s)
        if m:
            ax = {"xlo xhi": 0, "ylo yhi": 1, "zlo zhi": 2}[m.group(3)]
            box_lo[ax] = float(m.group(1))
            box_hi[ax] = float(m.group(2))
            continue
        for key, attr in _HEADER_KEYS:
            m = re.match(rf"^(\d+)\s+{key}$", s)
            if m:
                header[attr] = int(m.group(1))
                break
        else:
            if re.match(r"^[-\d.eE+\s]+xy xz yz$", s):
                raise ValueError("triclinic boxes not supported yet")
    return header, box_lo, box_hi, None


def _sections(lines, start):
    """Yield (name, rows) for every section from line ``start`` on; rows
    are the whitespace-split, comment-stripped non-empty lines."""
    i = start
    while i is not None and i < len(lines):
        name = lines[i].split("#")[0].strip()
        rows = []
        i += 1
        while i < len(lines) and lines[i].split("#")[0].strip() not in _SECTIONS:
            s = _strip(lines[i])
            if s:
                rows.append(s.split())
            i += 1
        yield name, rows


def parse_data_file(path: str, *, use_native: bool = True) -> LammpsData:
    """Read a LAMMPS data file of atom_style full: through the host library
    when ``use_native`` and it is built (``CONP2_NO_NATIVE=1`` turns it
    off), else with ``parse_data_file_py``."""
    if use_native:
        from . import native
        fields = native.parse_data_native(path)
        if fields is not None and fields["natoms"] > 0:
            return _finalize_raw(fields)
    return parse_data_file_py(path)


def parse_data_file_py(path: str) -> LammpsData:
    """Read a LAMMPS data file of atom_style full (the Python parser)."""
    with open(path) as fh:
        lines = fh.readlines()
    header, box_lo, box_hi, start = _read_header(lines)
    natoms = header.get("natoms", 0)
    ntypes = header.get("natomtypes", 0)
    f = dict(
        natoms=natoms, natomtypes=ntypes, box_lo=box_lo, box_hi=box_hi,
        mass_by_type=np.zeros(ntypes + 1),
        pair_coeffs=np.zeros((ntypes + 1, 2)), pair_coeffs_ij=None,
        bond_coeffs=np.zeros((header.get("nbondtypes", 0) + 1, 2)),
        angle_coeffs=np.zeros((header.get("nangletypes", 0) + 1, 2)),
        tag=np.zeros(natoms, np.int64), mol=np.zeros(natoms, np.int64),
        type=np.zeros(natoms, np.int64), q=np.zeros(natoms),
        x=np.zeros((natoms, 3)), v=np.zeros((natoms, 3)),
        bonds=np.zeros((header.get("nbonds", 0), 3), np.int64),
        angles=np.zeros((header.get("nangles", 0), 4), np.int64))
    velocities = {}
    for name, rows in _sections(lines, start):
        if name == "Masses":
            for r in rows:
                f["mass_by_type"][int(r[0])] = float(r[1])
        elif name == "Pair Coeffs":
            for r in rows:
                f["pair_coeffs"][int(r[0])] = [float(r[1]), float(r[2])]
        elif name == "PairIJ Coeffs":
            pij = np.zeros((ntypes + 1, ntypes + 1, 2))
            for r in rows:
                a, b = int(r[0]), int(r[1])
                pij[a, b] = pij[b, a] = [float(r[2]), float(r[3])]
            f["pair_coeffs_ij"] = pij
        elif name in ("Bond Coeffs", "Angle Coeffs"):
            tab = f["bond_coeffs" if name == "Bond Coeffs" else "angle_coeffs"]
            for r in rows:
                tab[int(r[0])] = [float(r[1]), float(r[2])]
        elif name == "Atoms":
            for k, r in enumerate(rows):
                # full: id mol type q x y z [ix iy iz]
                f["tag"][k], f["mol"][k], f["type"][k] = (int(r[0]), int(r[1]),
                                                          int(r[2]))
                f["q"][k] = float(r[3])
                f["x"][k] = [float(r[4]), float(r[5]), float(r[6])]
        elif name == "Velocities":
            velocities = {int(r[0]): [float(r[1]), float(r[2]), float(r[3])]
                          for r in rows}
        elif name == "Bonds":
            for k, r in enumerate(rows):
                f["bonds"][k] = [int(r[1]), int(r[2]), int(r[3])]
        elif name == "Angles":
            for k, r in enumerate(rows):
                f["angles"][k] = [int(r[1]), int(r[2]), int(r[3]), int(r[4])]
        elif name in ("Dihedrals", "Impropers") and rows:
            raise ValueError(f"{name} present but not supported")
    # velocities by tag, whichever order the sections came in
    for k in range(natoms):
        if int(f["tag"][k]) in velocities:
            f["v"][k] = velocities[int(f["tag"][k])]
    return _finalize_raw(f)


# ---------------------------------------------------------------------------
# deck operations of the reference inputs' doubled-cell trials
# ---------------------------------------------------------------------------

def replicate_z2(d: LammpsData) -> LammpsData:
    """``replicate 1 1 2``: the cell duplicated along +z.  The new atoms'
    tags are offset by N and their molecule ids by max(mol) (the decks then
    reassign the electrodes' molecules, tests/dilute/input:50-57)."""
    n = d.natoms
    zprd = d.box_hi[2] - d.box_lo[2]
    molmax = int(d.mol.max())
    x2 = d.x.copy()
    x2[:, 2] += zprd
    return dataclasses.replace(
        d,
        natoms=2 * n,
        box_hi=np.array([d.box_hi[0], d.box_hi[1], d.box_hi[2] + zprd]),
        tag=np.concatenate([d.tag, d.tag + n]),
        mol=np.concatenate([d.mol, d.mol + molmax]),
        type=np.concatenate([d.type, d.type]),
        q=np.concatenate([d.q, d.q]),
        x=np.concatenate([d.x, x2]),
        v=np.concatenate([d.v, d.v]),
        bonds=(np.concatenate([d.bonds, d.bonds + np.array([0, n, n])])
               if len(d.bonds) else d.bonds),
        angles=(np.concatenate([d.angles, d.angles + np.array([0, n, n, n])])
                if len(d.angles) else d.angles),
    )


def change_box_z_centered(d: LammpsData) -> LammpsData:
    """``change_box all z final -lz/2 lz/2 remap units box``."""
    zprd = d.box_hi[2] - d.box_lo[2]
    shift = -zprd / 2 - d.box_lo[2]
    x = d.x.copy()
    x[:, 2] += shift
    return dataclasses.replace(
        d, x=x,
        box_lo=np.array([d.box_lo[0], d.box_lo[1], -zprd / 2]),
        box_hi=np.array([d.box_hi[0], d.box_hi[1], zprd / 2]),
    )


def mirror_group_z(d: LammpsData, mask: np.ndarray, *,
                   flip_vz: bool = False) -> LammpsData:
    """``set group pos z v_newz`` with newz = lz/2 - z
    (tests/dilute/input:52-54); ``flip_vz`` negates the group's vz."""
    zprd = d.box_hi[2] - d.box_lo[2]
    x = d.x.copy()
    x[mask, 2] = zprd / 2 - x[mask, 2]
    v = d.v.copy()
    if flip_vz:
        v[mask, 2] = -v[mask, 2]
    return dataclasses.replace(d, x=x, v=v)


def set_mol(d: LammpsData, old_mol: int, new_mol: int) -> LammpsData:
    """Molecule ``old_mol`` renumbered ``new_mol``."""
    mol = d.mol.copy()
    mol[mol == old_mol] = new_mol
    return dataclasses.replace(d, mol=mol)
