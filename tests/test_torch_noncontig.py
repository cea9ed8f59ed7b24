"""Port vs JAX package: electrodes on any rows.

Six cells under a seeded permutation that spreads the electrode rows
through the atoms (``reorder_atoms`` in both packages): S1 (dense pair
sweep, factored Ewald), S1 under CG_MATFREE with mobile electrodes (the
warm start and the operator's electrode rows), S3 (block Verlet list, PPPM on the electrodes' z
planes), S4 (the chunked Ewald above KXY_CHUNK), the 352-atom
ionic-liquid fixture (SHAKE/RATTLE) and the same fixture on the unfused
sweep with K6 (``use_pallas_pair=False``, anions 2 A off the sheets).
Float64 on the CPU:

* 5 steps of the port against 5 of the JAX engine on the same scrambled
  system, from the JAX package's solve context (``interop``): x to 1e-10
  A, q and f to 1e-10 of their largest, pe to 1e-10 relative;
* the port's scrambled run against its electrodes-first run of the same
  cell, each from its own set-up, mapped by tag: the same bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.models.system import reorder_atoms as jreorder
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import (CPU64, S1, S4, SOLVE64, il_small, il_small_file,
                         pppm_cell, rel_err, x_near)

torch.set_num_threads(2)
NSTEPS = 5
TOL = 1e-10


def _cell(name, wl, kenum, il_path):
    """(system, md, cfg) of the named cell in package ``wl``."""
    if name in ("S1", "S1_cgmf"):
        system, md, cfg = wl.synthetic(**S1)
        if name == "S1_cgmf":
            cfg = dataclasses.replace(cfg, solver=type(cfg.solver).CG_MATFREE,
                                      mobile_electrodes=True)
        return system, md, cfg
    if name == "S3":
        return pppm_cell(wl, kenum, pair_path="block")
    if name == "S4":
        return wl.synthetic(**S4)
    system, md, cfg = il_small(wl, il_path)
    if name == "il_unfused":
        md = dataclasses.replace(md, use_pallas_pair=False)
    return system, md, cfg


def _x0(name, system):
    if name == "il":
        return system.x0
    if name == "il_unfused":
        return twl.near_sheet_positions(system, gap=2.0, count=4)
    return x_near(system)


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


@pytest.fixture(scope="module",
                params=["S1", "S1_cgmf", "S3", "S4", "il", "il_unfused"])
def runs(request, il_path):
    """The cell's runs: JAX and the port on the scrambled system, the port
    electrodes first; and the permutation (scrambled row k = row perm[k])."""
    name = request.param
    js, jmd, jcfg = _cell(name, jwl, JK, il_path)
    ts, tmd, tcfg = _cell(name, twl, TK, il_path)
    x0 = _x0(name, ts)
    perm = np.random.default_rng(7).permutation(ts.natoms)
    jss, tss = jreorder(js, perm), reorder_atoms(ts, perm)
    jsol = jsetup(jss, jmd, jcfg)
    tsol = tsetup(tss, tmd, tcfg, **SOLVE64)
    assert not tsol.ele_contig
    tsol.load_context(interop.context_from_numpy(
        {k: np.asarray(v) for k, v in jsol.ctx._asdict().items()}, **CPU64))
    jeng = jbuild(jss, jmd, jsol)
    teng = tbuild(tss, tmd, tsol, **CPU64)
    first = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    assert first.conp.ele_contig
    jst, _ = jeng.run(jeng.init_state(x0=x0[perm]), NSTEPS, thermo_every=0)
    tst = teng.init_state(x0=x0[perm])
    fst = first.init_state(x0=x0)
    for _ in range(NSTEPS):
        tst, fst = teng.step(tst), first.step(fst)
    return name, perm, jst, tst, fst


def _agree(st, x, q, f, pe):
    assert float(np.abs(st.x.numpy() - x).max()) < TOL
    assert rel_err(st.q.numpy(), q) < TOL
    assert rel_err(st.f.numpy(), f) < TOL
    assert float(st.energy) == pytest.approx(pe, rel=TOL)


def test_scrambled_steps_match_jax(runs):
    _, _, jst, tst, _ = runs
    assert tst.step == NSTEPS
    _agree(tst, np.asarray(jst.x), np.asarray(jst.q), np.asarray(jst.f),
           float(jst.energy))


def test_scrambled_matches_electrodes_first_by_tag(runs):
    _, perm, _, tst, fst = runs
    _agree(tst, fst.x.numpy()[perm], fst.q.numpy()[perm],
           fst.f.numpy()[perm], float(fst.energy))
