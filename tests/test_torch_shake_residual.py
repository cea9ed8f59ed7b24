"""Port vs JAX package: the SHAKE residual of the linear cation over 800
steps of the ionic-liquid test cell (IL_SMALL), float64 on both sides.

At the decks' 180-degree angle the three constraint directions of a
straight cation are parallel, so the 12 Gauss-Seidel sweeps correct along
the axis only: the bend the forces make stays, and with the 1-3 distance
held (the last slot) the bent cation's bonds come out long.  Both packages
leave the same residual at every checkpoint (to 1e-6 relative), the bonds
are never short, the bonds' residual stays under bend^2 (radians) and does
not grow after the start's heating (the second half's largest value is no
larger than the first half's), and the 1-3 distances hold to 1e-6."""

import math

import numpy as np
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.models.shake import constraint_residuals
from lammps_user_conp2_tpu_torch.shake_residual import rotor_geometry
from torch_cells import SOLVE64, CPU64, il_small, il_small_file

torch.set_num_threads(2)

NSTEPS = 800
EVERY = 100


def test_il_shake_residual_bounded(tmp_path):
    path = il_small_file(tmp_path)
    js, jmd, jcfg = il_small(jwl, path)
    ts, tmd, tcfg = il_small(twl, path)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    kw = dict(box=ts.box, periodic=ts.periodic)
    jst, tst = jeng.init_state(), teng.init_state()
    bonds = []
    for step in range(EVERY, NSTEPS + 1, EVERY):
        jst, _ = jeng.run(jst, EVERY, thermo_every=0)
        for _ in range(EVERY):
            tst = teng.step(tst)
        res = constraint_residuals(teng.cons, tst.x, **kw)
        jres = constraint_residuals(
            teng.cons, torch.tensor(np.asarray(jst.x)), **kw)
        np.testing.assert_allclose(res, jres, rtol=1e-6, err_msg=str(step))
        geo = rotor_geometry(teng.cons, tst.x, **kw)
        assert min(geo["bond1_err_min"], geo["bond2_err_min"]) > -1e-9, step
        assert max(res[:2]) <= math.radians(geo["bend_max_deg"]) ** 2, step
        assert res[2] < 1e-6, step
        bonds.append(max(res[:2]))
    half = len(bonds) // 2
    assert 1e-4 < max(bonds) < 1e-2
    assert max(bonds[half:]) <= max(bonds[:half])
