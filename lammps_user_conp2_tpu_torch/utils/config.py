"""Typed configuration for the constant-potential framework.

One dataclass replaces the reference's three config mechanisms (positional
fix args fix_conp.cpp:102-176, ``fix_modify e ehgo ...`` fix_conp.cpp:1482-1515,
and equal-style variables fix_conp.cpp:112-117).  The mode lattice is
{CONP, CONQ, COND} x {NORMAL, FFIELD, NOSLAB} x {zneutr} x {ETA, EHGO}
x {ewald, pppm} (SURVEY.md section 5 "Config / flag system").

The fields are those of the JAX package, so one configuration drives both
packages.  The port covers CONP / NORMAL / ETA / ewald / INV with
``nevery=1``; ``setup_conp`` and ``build_engine`` raise NotImplementedError
for the other values.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class Mode(enum.Enum):
    CONP = "conp"    # constant potential difference (fix conp)
    CONQ = "conq"    # constant total right-electrode charge (fix conq)
    COND = "cond"    # constant displacement / finite-field charge (fix cond)


class FFMode(enum.Enum):
    NORMAL = "normal"    # slab-corrected, potential step via d = -+0.5*evscale
    FFIELD = "ffield"    # finite-field: d is a z-ramp; pair with uniform efield
    NOSLAB = "noslab"    # fully periodic doubled cell (Raiteri)


class PairMode(enum.Enum):
    ETA = "eta"      # single Gaussian width eta
    EHGO = "ehgo"    # per-type widths + overlap correction (fix_conp.cpp:1517-1573)


class KSpaceStyle(enum.Enum):
    EWALD = "ewald"          # classic Ewald (km_ewald.cpp equivalent)
    PPPM = "pppm"            # mesh Ewald b-vector + force reuse (pppm_conp.cpp)


class Solver(enum.Enum):
    INV = "inv"              # dense inverse, projected (default; fix_conp.cpp:90)
    CG = "cg"                # neutrality-projected conjugate gradient (fix_conp.cpp:864-930)
    CG_MATFREE = "cg_matfree"  # matrix-free CG: A.p applied via factored Ewald
                               # + cached real-space block — no O(Ne^2) k-space
                               # assembly or O(Ne^3) inverse; production scale


@dataclasses.dataclass(frozen=True)
class EhgoConfig:
    """fix_modify e ehgo ... settings. eta/u0 indexed by 1-based atom type;
    u0 'auto' = sqrt(2/pi)*eta/evscale (fix_conp.cpp:1504)."""
    kappa: float = 1.0
    eta_by_type: tuple = ()      # ((type, eta, u0_or_None), ...)


@dataclasses.dataclass(frozen=True)
class ConpConfig:
    mode: Mode = Mode.CONP
    nevery: int = 1
    eta: float = 1.979
    # potential difference in volts (CONP), target right-electrode charge in e
    # (CONQ/COND). May be a callable step->float for equal-style variables.
    target: float | Callable = 0.0
    ff: FFMode = FFMode.NORMAL
    zneutr: bool = False
    pairmode: PairMode = PairMode.ETA
    ehgo: Optional[EhgoConfig] = None
    kspace: KSpaceStyle = KSpaceStyle.EWALD
    solver: Solver = Solver.INV
    qinit: bool = False          # keep initial electrode charges as baseline
    nonneutral: bool = False     # skip the electroneutrality projection
    matout: bool = False         # dump amatrix / inv_a_matrix files
    a_file: Optional[str] = None         # read A ("org") from file
    ainv_file: Optional[str] = None      # read A^-1 ("inv") from file
    mobile_electrodes: bool = False      # recompute electrode trig tables per solve
    cg_tolerance: float = 1e-6
    cg_maxiter: int = 100

    def __post_init__(self):
        if self.ff is FFMode.FFIELD and self.zneutr:
            raise ValueError("ffield and zneutr are mutually exclusive")
        if self.pairmode is PairMode.EHGO and self.ehgo is None:
            # the reference warns and falls back to ETA (fix_conp.cpp:1553-1558)
            object.__setattr__(self, "pairmode", PairMode.ETA)


@dataclasses.dataclass(frozen=True)
class ThermostatConfig:
    group: str                  # group name to thermostat
    t_start: float
    t_stop: float
    damp: float                 # fs
    tchain: int = 3


@dataclasses.dataclass(frozen=True)
class ShakeConfig:
    group: str
    btypes: tuple = ()          # bond types to constrain
    atypes: tuple = ()          # angle types to constrain
    tol: float = 1e-4
    maxiter: int = 20


@dataclasses.dataclass(frozen=True)
class ZMirrorConfig:
    group1: str
    group2: str
    every: int = 1


@dataclasses.dataclass(frozen=True)
class MDConfig:
    units: str = "real"
    dt: float = 1.0
    cutoff: float = 10.0            # global pair cutoff (lj = coul here)
    kspace_accuracy: float = 1e-6   # relative
    kspace_style: KSpaceStyle = KSpaceStyle.EWALD
    slab: Optional[float] = None    # kspace_modify slab factor (e.g. 3.0)
    g_ewald: Optional[float] = None  # pin (kspace_modify gewald), else derive
    mix: str = "arithmetic"         # pair_modify mix
    # uniform external field (V/Angstrom), or None
    efield: Optional[tuple] = None
    # closed-loop coupling: efield_z = -f_e/lz each step (tests/cond/input:68-70)
    efield_feedback: bool = False
    thermostats: tuple = ()         # tuple[ThermostatConfig]
    shake: Optional[ShakeConfig] = None
    zmirror: Optional[ZMirrorConfig] = None
    # JAX package only: force its Pallas pair kernel on or off (None =
    # auto).  The port takes its CUDA pair kernel for every CUDA float32
    # tensor and ignores this field.
    use_pallas_pair: Optional[bool] = None
    # real-space pair path: "auto" (block-compacted Verlet neighbor list
    # when N is large and the box is much bigger than the cutoff, else
    # dense), "dense", "cell" (padded cell-block sweep, also the sharded
    # engine's path), "nlist" (per-atom (N, K) rows), "block" (i-blocks of
    # 8 cell-sorted atoms share one j-union row — ~3.5x fewer gather
    # descriptors), or "tile" (the JAX package's TPU tile-pair kernel with
    # k-d brick ordering).  The port has "auto" (below 8192 atoms) and
    # "dense", which are the same dense sweep.
    pair_path: str = "auto"
    # Verlet-list skin (Angstrom): list radius = cutoff + skin, rebuilt when
    # any atom moves more than skin/2 (LAMMPS neigh_modify check yes)
    neighbor_skin: float = 1.0
    # per-atom neighbor-list capacity K; None = sized from the actual max
    # neighbor count at x0 (conp systems are strongly inhomogeneous — dense
    # electrode planes vs dilute electrolyte — so a mean-density estimate
    # can undersize the list and NaN-poison mid-run)
    neighbor_kmax: Optional[int] = None
    # PPPM force differentiation: "ik" (spectral, 1 fwd + 3 inv FFTs + a
    # 3-mesh gather) or "ad" (differentiate the B-spline interpolant of one
    # potential mesh — 1 fwd + 1 inv FFT + a 1-mesh gather; the exact
    # gradient of the discrete mesh energy).  "auto" = ad on the tiled
    # large-mesh path, ik on the dense small-system path (which all the
    # reference-log parity anchors were validated on).  LAMMPS analogue:
    # `kspace_modify diff ad|ik` (pppm.cpp).
    pppm_diff: str = "auto"
    # dtype for the force/integration path; solve path is configured separately
    dtype: str = "float64"
    solve_dtype: str = "float64"
