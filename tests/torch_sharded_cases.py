"""The cases of tests/test_torch_sharded.py and the function its ranks run.

Imports no jax: ``run_cases`` runs in processes that ``parallel.comm.
spawn_ranks`` spawns, which import this module.  ``build_case`` builds a
case's (system, md, cfg, x0, v0) from either package's ``workloads``, so
the parent can build the same cell in the JAX package.

Cells: S2 (640 atoms; N and Ne multiples of 4), ODD (S2's density with
nele_side 7 and one electrode atom left out: N = 607 and Ne = 97, so N % d
and Ne % d are not 0 at d = 2 or 4 and every pad row is used), S3 (the
box four cutoffs wide, where the list has more than one cell per axis)
and the test-size ionic-liquid file (IL_SMALL) for the decks.  The cell
list cases split 192 cells (S2, ODD) or 112 (S3) over the ranks; d = 3
slices, with pad cells, are held in one process by test_torch_cells.py.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from torch_cells import CPU64, S2, S3, SOLVE64, il_small

ODD = dict(n_elyte=510, nele_side=7, lz=60.0, lxy=24.0)

# q: max |dq| (e); f: max |df| <= F_ABS + F_REL max |f| (JAX
# test_sharded.py's tolerances)
Q_TOL = 1e-10
F_ABS = 1e-7
F_REL = 1e-9


def _matrix():
    out = []
    for solver in ("INV", "CG", "CG_MATFREE"):
        for kspace in ("EWALD", "PPPM"):
            for pair in ("dense", "nlist"):
                out.append(dict(name=f"{solver}-{kspace}-{pair}", cell="S2",
                                solver=solver, kspace=kspace, pair=pair))
    return out


CASES = _matrix() + [
    dict(name="odd-CG_MATFREE-PPPM-nlist", cell="ODD", solver="CG_MATFREE",
         kspace="PPPM", pair="nlist"),
    dict(name="odd-INV-EWALD-dense", cell="ODD", solver="INV",
         kspace="EWALD", pair="dense"),
    # the block list on a tiled mesh with the persistent tile assignment
    dict(name="block-tiled-persist", cell="S3", solver="INV", kspace="PPPM",
         pair="block", tiled=True, steps=2),
    dict(name="cond4", deck=("cond", 4)),
    dict(name="zmirror3", deck=("zmirror", 3), steps=2),
    dict(name="nevery2", cell="S2", solver="CG", kspace="EWALD",
         pair="nlist", nevery=2, steps=3),
    dict(name="mobile-CG_MATFREE", cell="S2", solver="CG_MATFREE",
         kspace="PPPM", pair="dense", mobile=True, steps=2),
    # 20 steps with a small skin and seeded velocities: the list is
    # rebuilt inside the run
    dict(name="reneighbor-20", cell="ODD", solver="CG_MATFREE",
         kspace="EWALD", pair="nlist", skin=0.2, v_seed=0, steps=20),
    # the cell list: each rank a slice of the cells (S2 and ODD: 4 x 4 x
    # 12 cells, S3: 4 x 4 x 7)
    dict(name="cell-INV-EWALD", cell="S2", solver="INV", kspace="EWALD",
         pair="cell", steps=2),
    dict(name="cell-CG_MATFREE-PPPM", cell="S3", solver="CG_MATFREE",
         kspace="PPPM", pair="cell", steps=2),
    dict(name="odd-INV-PPPM-cell", cell="ODD", solver="INV", kspace="PPPM",
         pair="cell"),
    # the tile path's engine (K4's plain item sweep over k-d bricks, the
    # persistent mesh assignment with its drift test), built as on the card
    # (``kernels_run`` patched): the sharded step sweeps dense rows for it
    # and bins the ranks' rows every step, as the JAX step does
    dict(name="tile-INV-PPPM-tiled", cell="S3", solver="INV", kspace="PPPM",
         pair="tile", tiled=True, card_route=True, steps=2),
]
CASE_NAMES = [c["name"] for c in CASES]


def _without_atom(system, i):
    """A synthetic System (no bonds) without atom ``i``, either package."""
    cut = lambda a: np.delete(np.asarray(a), i, axis=0)
    return dataclasses.replace(
        system, tag=cut(system.tag), mol=cut(system.mol),
        type=cut(system.type), mass=cut(system.mass), q0=cut(system.q0),
        x0=cut(system.x0), v0=cut(system.v0),
        groups={k: cut(v) for k, v in system.groups.items()},
        ele_left_mask=cut(system.ele_left_mask),
        ele_right_mask=cut(system.ele_right_mask),
        mobile_mask=cut(system.mobile_mask))


def build_case(spec, wl, il_path=None):
    """(system, md, cfg, v0) of a case from the package whose
    ``workloads`` module is ``wl``."""
    if "deck" in spec:
        deck, n = spec["deck"]
        system, md, cfg = il_small(wl, il_path, deck, n)
        return system, md, cfg, None
    cell = {"S2": S2, "S3": S3, "ODD": ODD}[spec["cell"]]
    system, md, cfg = wl.synthetic(**cell)
    if spec["cell"] == "ODD":
        system = _without_atom(system, int(system.ele_mask.sum()) - 1)
    kspace = type(cfg.kspace)[spec["kspace"]]
    md = dataclasses.replace(md, kspace_style=kspace, pair_path=spec["pair"],
                             neighbor_skin=spec.get("skin", md.neighbor_skin))
    cfg = dataclasses.replace(cfg, kspace=kspace,
                              solver=type(cfg.solver)[spec["solver"]],
                              nevery=spec.get("nevery", 1),
                              mobile_electrodes=spec.get("mobile", False))
    v0 = None
    if spec.get("v_seed") is not None:
        rng = np.random.RandomState(spec["v_seed"])
        v0 = 0.01 * rng.standard_normal((system.natoms, 3))
        v0[~system.mobile_mask] = 0.0
    return system, md, cfg, v0


def start_positions(spec, system):
    """A case's start positions: the port's ``near_wall_positions`` of a
    synthetic cell, None (the file's) for a deck."""
    if "deck" in spec:
        return None
    from lammps_user_conp2_tpu_torch.workloads import near_wall_positions
    return np.asarray(near_wall_positions(system))


def _arrays(st):
    return dict(x=st.x.numpy(), v=st.v.numpy(), q=st.q.numpy(),
                f=st.f.numpy(), energy=float(st.energy),
                scalar=float(st.scalar_out), step=st.step)


def run_cases(rank, comm, names, il_path):
    """Every named case in turn, in each rank: the port's sharded engine
    ``steps`` steps (``run``) from ``init_state``; rank 0 also runs the
    port's ``Engine.step`` from the same state.  Returns (rank 0's {name:
    dict(sharded=..., single=..., ...)}, {name: the rank's replicated x,
    v, q})."""
    from lammps_user_conp2_tpu_torch import workloads as twl
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models import md as md_mod
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import pppm
    from lammps_user_conp2_tpu_torch.parallel.sharded import (
        build_sharded_engine)

    results, replicated = {}, {}
    dense, route = pppm._use_dense, md_mod.kernels_run
    for spec in (c for c in CASES if c["name"] in names):
        if spec.get("tiled"):
            pppm._use_dense = lambda grid, n: False
        if spec.get("card_route"):
            md_mod.kernels_run = lambda device, dtype: True
        try:
            system, md, cfg, v0 = build_case(spec, twl, il_path)
            x0 = start_positions(spec, system)
            eng = build_engine(system, md, setup_conp(system, md, cfg,
                                                      **SOLVE64), **CPU64)
            sheng = build_sharded_engine(eng, comm, x0=x0)
            st0 = eng.init_state(x0=x0, v0=v0)
            nsteps = spec.get("steps", 1)
            st, th = sheng.run(st0, nsteps, thermo_every=nsteps)
            out = dict(sharded=_arrays(st), pe_thermo=float(th["pe"][-1]),
                       tasg=None if st.tasg is None else (
                           type(st.tasg).__name__, tuple(st.tasg.table.shape)),
                       rank_cap=(None if sheng.rank_grid is None
                                 else sheng.rank_grid.tile_cap),
                       x_ref_moved=bool(st.nbr is not None and not torch.equal(
                           st.nbr.x_ref, st0.nbr.x_ref)))
            if rank == 0:
                s1 = st0
                for _ in range(nsteps):
                    s1 = eng.step(s1)
                out.update(single=_arrays(s1), natoms=system.natoms,
                           ne=eng.conp.ne, rebuilds=eng.rebuilds,
                           block=bool(eng.ncfg is not None and eng.ncfg.block),
                           list=eng.ncfg is not None,
                           cells=(None if eng.cell_grid is None
                                  else eng.cell_grid.total),
                           pair_cap=eng.pair_cap,
                           persist=(eng.mesh_persist, sheng.mesh_persist))
            results[spec["name"]] = out
            replicated[spec["name"]] = [st.x, st.v, st.q]
        finally:
            pppm._use_dense, md_mod.kernels_run = dense, route
    # what the rank imported of jax or the JAX package: nothing
    results["modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "lammps_user_conp2_tpu"))
    return results, replicated


def fail_on_rank_one(rank, comm):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    comm.psum(torch.ones(3))
    return {}, {}
