"""Port vs JAX package: the float64 electrode setup on S1 and S2.
A to a relative 1e-10 (the port always assembles its k-space block with the
host plane-factored sum, the JAX package below 1e10 flops with the direct
trig sum: roundoff of a different summation order); the projected A^-1,
elesetq and totsetq to a relative 1e-8 (the conditioning of the inverse)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import conp as jconp
from lammps_user_conp2_tpu.models import electrodes as jel
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import conp as tconp
from lammps_user_conp2_tpu_torch.models import electrodes as tel
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.utils.config import (ConpConfig, FFMode,
                                                      KSpaceStyle, Mode,
                                                      ShakeConfig, Solver)
from torch_cells import S1, S2, rel_err

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", [S1, S2], ids=["S1", "S2"])
def test_setup_matches(cell):
    js, jmd, jcfg = jwl.synthetic(**cell)
    ts, tmd, tcfg = twl.synthetic(**cell)
    j = jconp.setup_conp(js, jmd, jcfg)
    t = tconp.setup_conp(ts, tmd, tcfg)
    assert t.ksp.g_ewald == pytest.approx(j.ksp.g_ewald, rel=1e-14)
    assert t.cut_coulsq == j.cut_coulsq and t.ne == len(j.ele_idx)
    np.testing.assert_array_equal(t.ele_idx, j.ele_idx)

    ele = j.ele_idx
    xe = js.x0[ele]
    kw = dict(box=js.box, periodic=js.periodic, cut_coulsq=j.cut_coulsq)
    ja = np.asarray(jel.assemble_amatrix(
        jnp.asarray(xe), jnp.asarray(js.type[ele]),
        j.kernels.self_diag[ele], j.ksp, j.kernels, **kw))
    ta = tel.assemble_amatrix(xe, ts.type[ele], t.kernels.self_diag[ele],
                              t.ksp, t.kernels, **kw).numpy()
    assert rel_err(ta, ja) < 1e-10

    assert rel_err(t.ainv.numpy(), j.ctx.ainv) < 1e-8
    assert rel_err(t.elesetq.numpy(), j.ctx.elesetq) < 1e-8
    assert float(t.totsetq) == pytest.approx(float(j.ctx.totsetq), rel=1e-8)
    assert t.ee_diag == pytest.approx(j.ee_diag, rel=1e-8)
    np.testing.assert_array_equal(t.d.numpy(), np.asarray(j.ctx.d))
    np.testing.assert_array_equal(t.elecheck_ele.numpy(),
                                  np.asarray(j.ctx.elecheck_ele))
    # the projected inverse maps neutral charge space to itself
    assert abs(float(t.ainv.sum())) < 1e-8 * float(t.ainv.abs().sum())


def test_project_inverse_zneutr_matches():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((12, 12))
    ainv = m @ m.T + 12 * np.eye(12)
    z = rng.uniform(0, 10, 12)
    for zneutr in (False, True):
        kw = dict(nullneutral=True, zneutr=zneutr, zhalf=5.0)
        ta, tt = tel.project_inverse(torch.from_numpy(ainv),
                                     z_e=torch.from_numpy(z), **kw)
        ja, jt = jel.project_inverse(jnp.asarray(ainv), z_e=jnp.asarray(z),
                                     **kw)
        assert rel_err(ta.numpy(), ja) < 1e-13
        assert float(tt) == pytest.approx(float(jt), rel=1e-13)


@pytest.mark.parametrize("change", [
    dict(mode=Mode.CONQ), dict(solver=Solver.CG), dict(ff=FFMode.FFIELD),
    dict(kspace=KSpaceStyle.PPPM), dict(nevery=2), dict(matout=True),
    dict(mobile_electrodes=True), dict(target=lambda step: 1.0)],
    ids=["conq", "cg", "ffield", "pppm", "nevery", "matout", "mobile",
         "callable"])
def test_setup_refuses_features_not_ported(change):
    system, md, cfg = twl.synthetic(**S1)
    cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        tconp.setup_conp(system, md, cfg)


@pytest.mark.parametrize("change", [
    dict(shake=ShakeConfig("sol")), dict(efield=(0.0, 0.0, 0.1)),
    dict(kspace_style=KSpaceStyle.PPPM), dict(pair_path="nlist")],
    ids=["shake", "efield", "pppm", "nlist"])
def test_build_engine_refuses_features_not_ported(change):
    system, md, cfg = twl.synthetic(**S1)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_engine(system, dataclasses.replace(md, **change))


def test_build_engine_refuses_verlet_list_size():
    system, md, _ = twl.synthetic(n_elyte=8200, nele_side=4, lz=40.0,
                                  lxy=40.0)
    with pytest.raises(NotImplementedError, match="Verlet"):
        build_engine(system, md)
