"""A deck as the plain reference sees it: the LAMMPS data file read here,
in atom-id order, and the deck's settings from the configuration and the
traffic files of the benchmark.

Nothing here imports the program: the data file is the only input both
sides read, for the atoms and their places.  Where the configuration
states the force field (``deck.force_field``: masses, charges, pair,
bond and angle coefficients), the reference takes it from there and
refuses a data file that lists anything else.  ``Deck`` holds host numpy
arrays; ``reference.conp_md`` computes with them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# LAMMPS ``units real`` (update.cpp, 27May2021)
BOLTZ = 0.0019872067
MVV2E = 48.88821291 * 48.88821291
FTM2V = 1.0 / MVV2E
QQR2E = 332.06371
QE2F = 23.060549
EVSCALE = QE2F / QQR2E          # volts to the solver's potential units

SECTIONS = ("Masses", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs",
            "Angle Coeffs", "Atoms", "Velocities", "Bonds", "Angles")


def read_data(path: str) -> dict:
    """A LAMMPS data file of atom style full, atoms sorted by id: numpy
    arrays under the names of its sections (0-based atom rows in the
    topology)."""
    with open(path) as fh:
        lines = [ln.split("#")[0].strip() for ln in fh]
    head = {}
    box = np.zeros((3, 2))
    i = 0
    while i < len(lines) and lines[i] not in SECTIONS:
        w = lines[i].split()
        if len(w) >= 4 and w[2].endswith("lo") and w[3].endswith("hi"):
            box["xyz".index(w[2][0])] = [float(w[0]), float(w[1])]
        elif len(w) >= 2 and w[0].isdigit():
            head[" ".join(w[1:])] = int(w[0])
        i += 1
    sec = {}
    name = None
    for ln in lines[i:]:
        if ln in SECTIONS:
            name = ln
            sec[name] = []
        elif ln and name is not None:
            sec[name].append(ln.split())
    nt = head["atom types"]
    atoms = sorted(sec["Atoms"], key=lambda r: int(r[0]))
    ids = np.array([int(r[0]) for r in atoms])
    row = {t: k for k, t in enumerate(ids)}
    d = dict(
        box_lo=box[:, 0].copy(), box_hi=box[:, 1].copy(), ntypes=nt, tag=ids,
        mol=np.array([int(r[1]) for r in atoms]),
        type=np.array([int(r[2]) for r in atoms]),
        q=np.array([float(r[3]) for r in atoms]),
        x=np.array([[float(c) for c in r[4:7]] for r in atoms]),
        v=np.zeros((len(ids), 3)), mass=np.zeros(nt + 1),
        pair=np.zeros((nt + 1, 2)), pair_ij=None,
        bond_coeffs=np.zeros((head.get("bond types", 0) + 1, 2)),
        angle_coeffs=np.zeros((head.get("angle types", 0) + 1, 2)),
        bonds=np.zeros((0, 3), np.int64), angles=np.zeros((0, 4), np.int64))
    for r in sec.get("Masses", []):
        d["mass"][int(r[0])] = float(r[1])
    for r in sec.get("Pair Coeffs", []):
        d["pair"][int(r[0])] = [float(r[1]), float(r[2])]
    if "PairIJ Coeffs" in sec:
        d["pair_ij"] = np.zeros((nt + 1, nt + 1, 2))
        for r in sec["PairIJ Coeffs"]:
            a, b = int(r[0]), int(r[1])
            d["pair_ij"][a, b] = d["pair_ij"][b, a] = [float(r[2]),
                                                       float(r[3])]
    for key, name in (("bond_coeffs", "Bond Coeffs"),
                      ("angle_coeffs", "Angle Coeffs")):
        for r in sec.get(name, []):
            d[key][int(r[0])] = [float(r[1]), float(r[2])]
    for r in sec.get("Velocities", []):
        d["v"][row[int(r[0])]] = [float(c) for c in r[1:4]]
    if sec.get("Bonds"):
        d["bonds"] = np.array([[int(r[1]), row[int(r[2])], row[int(r[3])]]
                               for r in sec["Bonds"]], np.int64)
    if sec.get("Angles"):
        d["angles"] = np.array([[int(r[1]), row[int(r[2])], row[int(r[3])],
                                 row[int(r[4])]] for r in sec["Angles"]],
                               np.int64)
    return d


@dataclasses.dataclass
class Deck:
    """One deck's trial in atom-id order (host numpy, float64)."""
    box_lo: np.ndarray
    box: tuple
    periodic: tuple
    tag: np.ndarray
    type: np.ndarray
    mass: np.ndarray             # (N,)
    q0: np.ndarray
    x0: np.ndarray
    v0: np.ndarray
    lj_eps: np.ndarray           # (T+1, T+1)
    lj_sig: np.ndarray
    bonds: np.ndarray            # (NB, 3) type, i, j
    angles: np.ndarray           # (NA, 4) type, i, j, k
    bond_coeffs: np.ndarray
    angle_coeffs: np.ndarray
    excl: list                   # (i, j) pairs with i < j whose pair term is off
    left: np.ndarray             # (N,) bool
    right: np.ndarray
    sol: np.ndarray              # the thermo group (bool)
    thermostats: list            # [(group mask, T, damp, tchain)]
    shake: list                  # [(i, j, d)] in build order
    cutoff: float
    accuracy: float
    dt: float
    slab: float                  # the slab volume factor, or 0 (no slab)
    eta: float
    volts: float
    ffield: bool                 # FFIELD: the z-ramp d vector and field
    self_fac: float              # the Gaussian self energy's factor
    pppm_diff: str = None        # the mesh's kspace_modify diff, or None

    @property
    def natoms(self) -> int:
        return len(self.tag)

    @property
    def ele(self) -> np.ndarray:
        return self.left | self.right

    @property
    def mobile(self) -> np.ndarray:
        m = np.zeros(self.natoms, bool)
        for g, *_ in self.thermostats:
            m |= g
        return m


def _tables(d: dict, mix: str, overrides) -> tuple:
    nt = d["ntypes"]
    eps = np.zeros((nt + 1, nt + 1))
    sig = np.zeros((nt + 1, nt + 1))
    if d["pair_ij"] is not None:
        eps, sig = d["pair_ij"][..., 0].copy(), d["pair_ij"][..., 1].copy()
    for i in range(1, nt + 1):
        for j in range(1, nt + 1):
            if eps[i, j] == 0.0 and sig[i, j] == 0.0:
                (ei, si), (ej, sj) = d["pair"][i], d["pair"][j]
                eps[i, j] = math.sqrt(ei * ej)
                sig[i, j] = (0.5 * (si + sj) if mix == "arithmetic"
                             else math.sqrt(si * sj))
    for i, j, e, s in overrides:
        eps[i, j] = eps[j, i] = e
        sig[i, j] = sig[j, i] = s
    return eps, sig


def _site_tables(ff: dict, mix: str) -> tuple:
    """(eps, sig) (T+1, T+1) mixed from the force field's per-type LJ,
    with ``pair_off`` pairs' eps set to 0."""
    site = np.asarray(ff["pair"], np.float64)
    d = dict(pair=np.vstack([np.zeros((1, 2)), site]), pair_ij=None,
             ntypes=len(site))
    eps, sig = _tables(d, mix, [])
    for i, j in ff.get("pair_off", []):
        eps[i, j] = eps[j, i] = 0.0
    return eps, sig


def _stated(ff: dict, d: dict, mix: str, eps, sig) -> dict:
    """The force field as the configuration states it, after a check that
    the data file ``d`` lists the same (relative 1e-12); ``eps`` and
    ``sig`` the file's mixed tables."""
    close = lambda a, b: np.allclose(a, b, rtol=1e-12, atol=0.0)
    out = {}
    if "masses" in ff:
        m = np.concatenate([[0.0], ff["masses"]])
        if not close(d["mass"], m):
            raise ValueError("the data file's masses are not the "
                             f"configuration's: {d['mass'][1:]}")
        out["mass"] = m
    if "charges" in ff:
        want = np.asarray(ff["charges"], np.float64)[d["type"] - 1]
        if not close(d["q"], want):
            raise ValueError("the data file's charges are not the "
                             "configuration's, by type")
    if "pair" in ff:
        e, s = _site_tables(ff, mix)
        if not (close(eps, e) and close(sig, s)):
            raise ValueError("the data file's pair coefficients are not "
                             "the configuration's")
        out["lj"] = (e, s)
    for key in ("bond_coeffs", "angle_coeffs"):
        if key in ff:
            c = np.vstack([np.zeros((1, 2)), np.asarray(ff[key], np.float64)])
            if d[key].shape != c.shape or not close(d[key], c):
                raise ValueError(f"the data file's {key} are not the "
                                 "configuration's")
            out[key] = c
    return out


def _exclusions(n: int, bonds, angles) -> list:
    """Pairs 1-2 and 1-3 of the bonds, and the three pairs of each angle:
    special_bonds 0.0 on each."""
    out = set()
    adj = [set() for _ in range(n)]
    for _, i, j in bonds:
        out.add((min(i, j), max(i, j)))
        adj[i].add(j)
        adj[j].add(i)
    for nb in adj:
        nb = sorted(nb)
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                out.add((nb[a], nb[b]))
    for _, i, j, k in angles:
        for a, b in ((i, j), (j, k), (i, k)):
            out.add((min(a, b), max(a, b)))
    return sorted(out)


def _shake_pairs(d: dict, group, btypes, atypes) -> list:
    """The constrained distances in LAMMPS fix shake's build order: the
    bonds of the listed types, then the 1-3 distance of each listed angle
    (law of cosines)."""
    r0 = {}
    out = []
    for t, i, j in d["bonds"]:
        b = d["bond_coeffs"][t, 1]
        r0[(i, j)] = r0[(j, i)] = b
        if t in btypes and group[i] and group[j]:
            out.append((int(i), int(j), float(b)))
    for t, i, j, k in d["angles"]:
        if t in atypes and group[i] and group[j] and group[k]:
            r1, r2 = r0[(i, j)], r0[(j, k)]
            th = math.radians(d["angle_coeffs"][t, 1])
            out.append((int(i), int(k), math.sqrt(
                r1 * r1 + r2 * r2 - 2.0 * r1 * r2 * math.cos(th))))
    return out


def _ehgo_is_eta(ehgo, dk) -> bool:
    """Whether an EHGO setting is ETA's pair kernels: kappa 0 and one width,
    the deck's eta, on the electrodes' type alone, u0 at its default
    sqrt(2/pi) eta (the self energy then takes factor 1, not ETA's 1/2)."""
    if not ehgo or ehgo["kappa"] != 0.0 or len(ehgo["eta_by_type"]) != 1:
        return False
    t, eta, u0 = ehgo["eta_by_type"][0]
    return t == dk["electrode_type"] and eta == dk["eta"] and u0 is None


def build_deck(data_path: str, config: dict, traffic: dict) -> Deck:
    """The deck of ``config`` (the configuration file's ``deck`` block)
    under the trial settings of ``traffic`` on the data file at
    ``data_path``."""
    dk = config["deck"]
    tr = traffic["trial_settings"]
    ehgo = tr.get("ehgo")
    diff = dk.get("pppm_diff")
    # the solvers differ in how they reach A^-1 b: the reference computes
    # it exactly under each, and the cell's limits bound the iteration's
    # tolerance
    if (tr["mode"] != "CONP"
            or tr["solver"] not in ("INV", "CG", "CG_MATFREE")
            or tr["ff"] not in ("NORMAL", "FFIELD")
            or tr["kspace"] not in ("EWALD", "PPPM")
            or tr["pairmode"] not in ("ETA", "EHGO")
            or tr.get("nevery", 1) != 1
            or (tr["pairmode"] == "EHGO" and not _ehgo_is_eta(ehgo, dk))
            or (diff is not None
                and (tr["kspace"] != "PPPM" or diff not in ("ik", "ad")))):
        raise NotImplementedError(
            "the reference covers CONP with INV, CG or CG_MATFREE every "
            "step, the NORMAL slab or FFIELD, Ewald (PPPM's exact sum, or "
            "its mesh with diff ik or ad where the configuration states "
            "pppm_diff), ETA and EHGO reducing to ETA's widths, not "
            f"{tr} with pppm_diff {diff!r}")
    d = read_data(data_path)
    eps, sig = _tables(d, dk["mix"], dk.get("pair_coeffs", []))
    ff = _stated(dk.get("force_field", {}), d, dk["mix"], eps, sig)
    eps, sig = ff.get("lj", (eps, sig))
    d.update({k: ff[k] for k in ("mass", "bond_coeffs", "angle_coeffs")
              if k in ff})
    typ = d["type"]
    groups = {k: np.isin(typ, v) for k, v in dk["groups"].items()}
    shake = []
    if dk.get("shake"):
        s = dk["shake"]
        shake = _shake_pairs(d, groups[s["group"]], set(s["btypes"]),
                             set(s["atypes"]))
    thermos = [(groups[t["group"]], float(t["temp"]), float(t["damp"]),
                int(t.get("tchain", 3))) for t in dk["thermostats"]]
    return Deck(
        box_lo=d["box_lo"], box=tuple(float(v) for v in d["box_hi"]
                                      - d["box_lo"]),
        periodic=tuple(bool(p) for p in tr["periodic"]), tag=d["tag"],
        type=typ, mass=d["mass"][typ], q0=d["q"], x0=d["x"], v0=d["v"],
        lj_eps=eps, lj_sig=sig, bonds=d["bonds"], angles=d["angles"],
        bond_coeffs=d["bond_coeffs"], angle_coeffs=d["angle_coeffs"],
        excl=_exclusions(len(typ), d["bonds"], d["angles"]),
        left=np.isin(d["mol"], dk["electrode_mols"][0]),
        right=np.isin(d["mol"], dk["electrode_mols"][1]),
        sol=groups[dk["thermo_group"]], thermostats=thermos, shake=shake,
        cutoff=float(dk["cutoff"]), accuracy=float(dk["kspace_accuracy"]),
        dt=float(dk["dt"]), slab=float(tr["slab"] or 0.0),
        eta=float(dk["eta"]), volts=float(dk["volts"]),
        ffield=tr["ff"] == "FFIELD",
        self_fac=1.0 if tr["pairmode"] == "EHGO" else 0.5, pppm_diff=diff)
