"""The synthetic capacitor as a data file, and the program's deck of it.

``write_data(path, seed, **state)`` writes the LAMMPS data file (atom
style full) of ``workloads.synthetic(**state)``: its box, types, charges,
masses, pair coefficients and positions as the program builds them, and
velocities drawn from ``seed``: the ions at 300 K (Maxwell-Boltzmann,
numpy ``default_rng(seed)``, the ions' net momentum removed), the walls
at rest.  ``program_deck(path, **state)`` is the program's deck of that
file for ``harness.build_program``: ``workloads.synthetic(**state)`` with
PPPM and INV, as the program's 100k cell (``step_breakdown_large.
large_cell``), its positions and velocities read from the file with the
program's parser.  The program has no deck that reads a synthetic data
file; this stands in for one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..reference.deck import BOLTZ, MVV2E

TEMP = 300.0


def _system(state: dict):
    from lammps_user_conp2_tpu_torch import workloads
    return workloads.synthetic(
        int(state["n_elyte"]), int(state["nele_side"]),
        lz=float(state["lz"]), lxy=float(state["lxy"]))


def write_data(path, seed: int, **state) -> str:
    """The data file of the synthetic state at ``path``; returns it."""
    system, _, _ = _system(state)
    rng = np.random.default_rng(int(seed))
    n = system.natoms
    ion = system.groups["sol"]
    m = system.mass[ion]
    v = np.zeros((n, 3))
    v[ion] = rng.standard_normal((int(ion.sum()), 3)) * np.sqrt(
        BOLTZ * TEMP / (m * MVV2E))[:, None]
    v[ion] -= (m[:, None] * v[ion]).sum(0) / m.sum()
    ntypes = system.ntypes
    mass = {int(t): float(system.mass[system.type == t][0])
            for t in range(1, ntypes + 1)}
    f = lambda val: f"{float(val):.17g}"
    lo, hi = system.box_lo, system.box_hi
    lines = [f"synthetic capacitor, {n} atoms (perfbench/proof/state.py, "
             f"seed {seed})", "", f"{n} atoms", f"{ntypes} atom types", ""]
    lines += [f"{f(lo[a])} {f(hi[a])} {c}lo {c}hi"
              for a, c in enumerate("xyz")]
    lines += ["", "Masses", ""]
    lines += [f"{t} {f(mass[t])}" for t in range(1, ntypes + 1)]
    lines += ["", "Pair Coeffs # lj/cut/coul/long", ""]
    lines += [f"{t} {f(system.lj_eps[t, t])} {f(system.lj_sigma[t, t])}"
              for t in range(1, ntypes + 1)]
    lines += ["", "Atoms # full", ""]
    x = system.x0
    lines += [f"{system.tag[i]} {system.mol[i]} {system.type[i]} "
              f"{f(system.q0[i])} {f(x[i, 0])} {f(x[i, 1])} {f(x[i, 2])}"
              for i in range(n)]
    lines += ["", "Velocities", ""]
    lines += [f"{system.tag[i]} {f(v[i, 0])} {f(v[i, 1])} {f(v[i, 2])}"
              for i in range(n)]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def program_deck(path, **state):
    """(system, md, cfg) of the program on the file at ``path``."""
    from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle, Solver
    from lammps_user_conp2_tpu_torch.utils.data_io import parse_data_file
    system, md, cfg = _system(state)
    data = parse_data_file(str(path), use_native=False)
    rows = np.searchsorted(data.tag, system.tag)
    if not (np.array_equal(data.tag[rows], system.tag)
            and np.array_equal(data.type[rows], system.type)
            and np.array_equal(data.q[rows], system.q0)):
        raise ValueError(f"{path} is not the synthetic state {state}")
    system = dataclasses.replace(system, x0=data.x[rows], v0=data.v[rows])
    cfg = dataclasses.replace(cfg, solver=Solver.INV, kspace=KSpaceStyle.PPPM)
    md = dataclasses.replace(md, kspace_style=KSpaceStyle.PPPM)
    return system, md, cfg

