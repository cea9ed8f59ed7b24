"""Port vs JAX package: the charge and field modes, float64 on both sides.

* Per step: on the synthetic S1 cell (Ewald) and on the written il file
  (IL_SMALL, PPPM, the cond deck's settings), the charges (atol 1e-8), the
  fix scalar (1e-8 relative) and pe (1e-9 relative) of both engines agree
  at init and over 3 steps for CONQ with one and with two electrodes,
  COND with the feedback field, and CONP and CONQ under FFIELD with the
  external and with the feedback field (test_torch_cond_setup.py holds
  the set-up they start from).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from torch_cells import CPU64, S1, SOLVE64, il_small, il_small_file, x_near

torch.set_num_threads(2)

NSTEPS = 3
CASES = ["conq1", "conq2", "cond", "conp_ext", "conp_fb", "conq_ext",
         "conq_fb"]


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _one_electrode(system):
    """Both walls in one electrode (group1 == group2, fix_conp.cpp:295)."""
    return dataclasses.replace(system, ele_left_mask=system.ele_mask,
                               ele_right_mask=np.zeros_like(system.ele_mask))


def _case(wl, cell, case, il_path):
    """(system, md, cfg, x0) of ``case`` on ``cell`` in the package of the
    workloads module ``wl`` (each package with its own enums)."""
    if cell == "il":
        n = {"conq1": 1, "conq2": 1, "cond": 4, "conp_ext": 2, "conp_fb": 2,
             "conq_ext": 3, "conq_fb": 3}[case]
        system, md, cfg = il_small(wl, il_path, "cond", n)
        x0 = None
    else:
        system, md, cfg = wl.synthetic(**S1)
        x0 = x_near(system)
        Mode, FF = type(cfg.mode), type(cfg.ff)
        mode = {"conq1": "CONQ", "conq2": "CONQ", "cond": "COND"}.get(
            case, case[:4].upper())
        cfg = dataclasses.replace(cfg, mode=Mode[mode],
                                  target=1.0 if mode == "CONP" else 0.05)
        if case not in ("conq1", "conq2"):
            # FFIELD: z periodic, no slab correction
            system = dataclasses.replace(system, periodic=(True, True, True))
            cfg = dataclasses.replace(cfg, ff=FF.FFIELD)
            md = dataclasses.replace(md, slab=None)
    lz = system.box[2]
    if case.endswith("_ext"):
        md = dataclasses.replace(md, efield=(0.0, 0.0, -2.0 / lz),
                                 efield_feedback=False)
    elif case.endswith("_fb") or case == "cond":
        md = dataclasses.replace(md, efield=None, efield_feedback=True)
    if case == "conq1":
        system = _one_electrode(system)
    return system, md, cfg, x0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cell", ["synthetic", "il"])
def test_charge_mode_steps_match(il_path, cell, case):
    js, jmd, jcfg, x0 = _case(jwl, cell, case, il_path)
    ts, tmd, tcfg, _ = _case(twl, cell, case, il_path)
    jsol = jsetup(js, jmd, jcfg)
    tsol = tsetup(ts, tmd, tcfg, **SOLVE64)
    assert tsol.one_electrode == jsol.one_electrode == (case == "conq1")
    assert tsol.ksp.slabflag == jsol.ksp.slabflag
    jeng = jbuild(js, jmd, jsol)
    teng = tbuild(ts, tmd, tsol, **CPU64)
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    for i in range(NSTEPS + 1):
        if i:
            jst, _ = jeng.run(jst, 1, thermo_every=1)
            tst = teng.step(tst)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.scalar_out) == pytest.approx(
            float(jst.scalar_out), rel=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
        np.testing.assert_allclose(tst.f.numpy(), np.asarray(jst.f), rtol=0,
                                   atol=1e-7)
    th = teng.thermo(tst)
    assert float(th["f_e"]) == float(tst.scalar_out)
    if tcfg.mode.name == "CONQ" and case != "conq1":
        # the right electrode holds the target charge
        assert float(th["qright"]) == pytest.approx(tcfg.target, abs=1e-9)
