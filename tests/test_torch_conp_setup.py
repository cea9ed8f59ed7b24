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
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
from torch_cells import CPU64, S1, S2, SOLVE64, rel_err

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", [S1, S2], ids=["S1", "S2"])
def test_setup_matches(cell):
    js, jmd, jcfg = jwl.synthetic(**cell)
    ts, tmd, tcfg = twl.synthetic(**cell)
    j = jconp.setup_conp(js, jmd, jcfg)
    t = tconp.setup_conp(ts, tmd, tcfg, **SOLVE64)
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
    dict(kspace_style=KSpaceStyle.PPPM), dict(pair_path="cell"),
    dict(pair_path="tile")],
    ids=["pppm", "cell", "tile"])
def test_build_engine_refuses_features_not_ported(change):
    """PPPM forces are ported, but not under an Ewald charge solve (the
    JAX engine cannot run that either; a PPPM solve gives PPPM forces);
    the cell and tile pair paths are ported (test_torch_cells.py,
    test_torch_tile_path.py): ``build_engine`` takes them (the tile path
    falls back to the dense sweep off the card, as the JAX engine does
    off its accelerator) and refuses a pair path the JAX engine does not
    name; SHAKE/RATTLE, zmirror and the external field are ported
    (test_torch_shake.py, test_torch_decks.py)."""
    system, md, cfg = twl.synthetic(**S1)
    conp = None
    if "kspace_style" in change:
        conp = tconp.setup_conp(system, md, cfg, **SOLVE64)
    if "pair_path" in change:
        eng = build_engine(system, dataclasses.replace(md, **change), conp,
                           **CPU64)
        assert (eng.cell_grid is not None) == (change["pair_path"] == "cell")
        assert eng.pair_cap is None and eng.ncfg is None
        change = dict(pair_path=change["pair_path"] + "s")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_engine(system, dataclasses.replace(md, **change), conp,
                     **CPU64)


def test_build_engine_refuses_verlet_list_size():
    """N > 8192 in a box at least 4 cutoffs wide is no longer refused: on
    the CPU it takes the per-atom Verlet list (the block form is kept for
    the CUDA float32 kernel), sized from x0."""
    system, md, _ = twl.synthetic(n_elyte=8200, nele_side=4, lz=40.0,
                                  lxy=40.0)
    eng = build_engine(system, dataclasses.replace(
        md, kspace_style=KSpaceStyle.PPPM), **CPU64)
    assert eng.ncfg is not None and eng.ncfg.block == 0
    assert eng.ncfg.k_max > 0 and eng.pppm_grid is not None


@pytest.mark.parametrize("change", ["spread", "mobile"])
def test_setup_reads_electrodes_through_the_full_mesh(change):
    """Electrodes spread through the box, or mobile ones, keep no z-plane
    set under PPPM, in both packages; mobile electrodes change nothing
    under EWALD with the INV solver."""
    system, md, cfg = twl.synthetic(**S1)
    jsys, jmd, jcfg = jwl.synthetic(**S1)
    x0 = np.array(system.x0)
    if change == "spread":
        ele = system.ele_mask
        x0[ele, 2] = np.linspace(1.0, system.box[2] - 1.0, int(ele.sum()))
        cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
        jcfg = dataclasses.replace(jcfg, kspace=type(jcfg.kspace).PPPM)
    else:
        cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM,
                                  mobile_electrodes=True)
        jcfg = dataclasses.replace(jcfg, kspace=type(jcfg.kspace).PPPM,
                                   mobile_electrodes=True)
    t = tconp.setup_conp(system, md, cfg, x0=x0, **SOLVE64)
    j = jconp.setup_conp(jsys, jmd, jcfg, x0=x0)
    assert t.ele_zplanes is None and j.ele_zplanes is None
    assert rel_err(t.ainv.numpy(), j.ctx.ainv) < 1e-8
    _, _, ecfg = twl.synthetic(**S1)
    still = tconp.setup_conp(system, md, ecfg, **SOLVE64)
    moved = tconp.setup_conp(system, md, dataclasses.replace(
        ecfg, mobile_electrodes=True), **SOLVE64)
    assert torch.equal(still.ainv, moved.ainv)
    x = torch.as_tensor(x0)
    q = torch.as_tensor(system.q0)
    assert torch.equal(still.b_vector_full(x, q)[0],
                       moved.b_vector_full(x, q)[0])
