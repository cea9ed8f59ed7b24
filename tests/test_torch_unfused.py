"""Port vs JAX package: the unfused CONP correction (K6) and the engine paths
whose pair sweeps now apply special-bond exclusions per pair.

* K6's plain version (``ele_rows_kernel.conp_correction``, the CPU path)
  against the JAX Mosaic kernel ``conp_correction_pallas`` in interpret
  mode and the JAX ``ops/pairs.conp_correction_forces``, on S2 at 5 A and
  3 A from the walls with nonzero electrode charges, float64: forces rtol
  1e-7 / atol 1e-8, ecorr relative 1e-10 (the K4/K5 tests' measures).
* ``MDConfig(use_pallas_pair=False)``: the unfused dense sweep and K6's
  path (never the fused K4 path) over 20 steps of the 352-atom
  ionic-liquid fixture against the JAX engine (x 1e-8 A, q 1e-8 e, pe 1e-9
  relative), from x0 and from anions 2 A off the inner sheets, where the
  engine's correction is nonzero; the first forces (rtol 1e-8) and energy
  (1e-10) with anions 1.2 A off the sheets, where it shows in both.
* The same fixture (cutoff 7 A, bonds and angles excluded) on
  ``pair_path="block"`` and ``"nlist"``: 20 steps against the JAX engine,
  which subtracts the excluded pairs after an s = 1 sweep; and the block
  engine in float32 against float64 on the CPU: the first forces within
  1e-4 of the largest, the block sweep at three later positions within
  1e-5, more than 10x closer than the JAX package's subtraction in float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.electrodes import make_kernels as jkernels
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops.pairs import conp_correction_forces as jcorr
from lammps_user_conp2_tpu.ops.pallas.ele_rows_kernel import (
    conp_correction_pallas)
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import md as tmd_mod
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.electrodes import make_kernels
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
from torch_cells import (S2, charges_with_electrodes, il_small, il_small_file,
                         x_close, x_near)

torch.set_num_threads(2)
NSTEPS = 20
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_k6_plain_matches_jax(positions):
    system, md, cfg = twl.synthetic(**S2)
    jsys, _, jcfg = jwl.synthetic(**S2)
    x = positions(system)
    q = charges_with_electrodes(system)
    ele = np.nonzero(system.ele_mask)[0]
    ely = (~system.ele_mask).astype(np.float64)
    kern = make_kernels(cfg, system)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              qqr2e=system.units().qqr2e)
    t = torch.as_tensor
    args = (t(x), t(q), t(system.type), t(ele),
            t((system.elecheck != 0).astype(np.float64)), t(ely),
            t(kern.eta_ij), t(kern.fo_ij))
    tf, te = k56.conp_correction(*args, **kw)
    pf, pe = k56.conp_correction_plain(*args, **kw)
    assert torch.equal(tf, pf) and float(te) == float(pe)
    assert k56.corr_launches.count == 0      # nothing launched on the CPU
    nt1 = kern.eta_ij.shape[0]
    onehot = np.zeros((system.natoms, nt1))
    onehot[np.arange(system.natoms), system.type] = 1.0
    te_idx = system.type[ele]
    jf, je = conp_correction_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(ele), jnp.asarray(ely),
        jnp.asarray(kern.eta_ij[te_idx]), jnp.asarray(kern.fo_ij[te_idx]),
        jnp.asarray(onehot), interpret=True, **kw)
    jk = jkernels(jcfg, jsys)
    rf, re = jcorr(jnp.asarray(x), jnp.asarray(q), jnp.asarray(jsys.elecheck),
                   jk.force, jk.potential, jnp.asarray(jsys.type),
                   ele_idx=jnp.asarray(ele), **kw)
    for f_ref, e_ref in ((jf, je), (rf, re)):
        np.testing.assert_allclose(tf.numpy(), np.asarray(f_ref), rtol=1e-7,
                                   atol=1e-8)
        assert float(te) == pytest.approx(float(e_ref), rel=1e-10)
    if positions is x_close:
        assert abs(float(te)) > 1e-3
    # Newton's third law: the electrolyte reactions balance the rows
    assert float(tf.sum(0).abs().max()) < 1e-9 * float(tf.abs().max())


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _compare_20_steps(jeng, teng, x0=None):
    ne = teng.conp.ne
    jst, tst = jeng.init_state(x0=x0), teng.init_state(x0=x0)
    for _ in range(NSTEPS):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-9)
        assert abs(float(tst.q[:ne].sum())) < 1e-10
    return tst


def _il_engines(il_path, **md_kw):
    js, jmd, jcfg = il_small(jwl, il_path)
    ts, tmd, tcfg = il_small(twl, il_path)
    jmd = dataclasses.replace(jmd, **md_kw)
    tmd = dataclasses.replace(tmd, **md_kw)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, solve_dtype=torch.float64,
                                  device="cpu"), **F64)
    assert teng.exclusions is not None
    return jeng, teng


def test_unfused_engine_20_steps_match(il_path, monkeypatch):
    """use_pallas_pair=False: every force evaluation takes the unfused
    sweep and K6's path; the fused pair path is never called."""
    calls = {"corr": 0}
    real = tmd_mod.conp_correction

    def spy(*a, **k):
        calls["corr"] += 1
        return real(*a, **k)

    def fused(*a, **k):
        raise AssertionError("the fused pair sweep ran")

    monkeypatch.setattr(tmd_mod, "conp_correction", spy)
    monkeypatch.setattr(tmd_mod, "pair_forces", fused)
    jeng, teng = _il_engines(il_path, use_pallas_pair=False)
    assert teng.ncfg is None
    _compare_20_steps(jeng, teng)
    assert calls["corr"] == NSTEPS + 1


def _ecorr_spy(monkeypatch):
    """Records the correction energy of every K6-path call of the engine."""
    seen = []
    real = tmd_mod.conp_correction

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(float(out[1]))
        return out

    monkeypatch.setattr(tmd_mod, "conp_correction", spy)
    return seen


def test_unfused_engine_near_sheets_20_steps_match(il_path, monkeypatch):
    """use_pallas_pair=False from anions 2 A off the inner sheets
    (``near_sheet_positions``): the engine's correction is nonzero, where
    at x0 every term is 0, and 20 steps still match the JAX engine."""
    seen = _ecorr_spy(monkeypatch)
    jeng, teng = _il_engines(il_path, use_pallas_pair=False)
    x0 = twl.near_sheet_positions(teng.system, gap=2.0, count=4)
    _compare_20_steps(jeng, teng, x0=x0)
    assert len(seen) == NSTEPS + 1 and abs(seen[0]) > 1e-7


def test_unfused_engine_forces_at_sheets_match(il_path, monkeypatch):
    """The unfused engine's first forces and energy with anions 1.2 A off
    the inner sheets, where the correction is large enough to show in them
    (|ecorr| > 0.1 kcal/mol against rel 1e-10 of pe, and each force within
    rtol 1e-8), against the JAX engine: the correction's forces and energy
    enter with the JAX engine's signs."""
    seen = _ecorr_spy(monkeypatch)
    jeng, teng = _il_engines(il_path, use_pallas_pair=False)
    x0 = twl.near_sheet_positions(teng.system, gap=1.2, count=4)
    jst, tst = jeng.init_state(x0=x0), teng.init_state(x0=x0)
    assert len(seen) == 1 and abs(seen[0]) > 0.1
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tst.f.numpy(), np.asarray(jst.f), rtol=1e-8,
                               atol=1e-8)
    assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-10)


@pytest.mark.parametrize("path", ["nlist", "block"])
def test_list_paths_with_exclusions_20_steps_match(il_path, path):
    jeng, teng = _il_engines(il_path, pair_path=path)
    assert teng.ncfg is not None and teng.ncfg.block == (8 if path == "block"
                                                         else 0)
    tst = _compare_20_steps(jeng, teng)
    assert not bool(tst.nbr.overflow)


def test_block_engine_f32_matches_f64(il_path):
    """Float32 against float64 on the CPU, the block engine with the
    cations' exclusions.  At x0 the whole force evaluation (charge solve,
    pair, bonded, k-space) agrees within 1e-4 of the largest force.  At the
    positions of 3 float64 steps the block sweep alone agrees within 1e-5;
    the JAX package's way in float32 (an s = 1 sweep plus its
    ``exclusion_correction``) is more than 10x further off there.  (Later
    whole-engine forces are dominated by the angle term's float32 arccos
    near 180 degrees, not by the pair sweep.)"""
    from lammps_user_conp2_tpu.ops.cells import exclusion_correction as jex
    from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
    from lammps_user_conp2_tpu_torch.ops import neighbors as TN
    ts, tmd, tcfg = il_small(twl, il_path)
    tmd = dataclasses.replace(tmd, pair_path="block")
    eng = {dt: tbuild(ts, tmd, tsetup(ts, tmd, tcfg, solve_dtype=dt,
                                      device="cpu"), dtype=dt, device="cpu")
           for dt in (torch.float32, torch.float64)}
    e32, e64 = eng[torch.float32], eng[torch.float64]
    st = e64.init_state()
    f32 = e32.init_state().f.double()
    assert float((f32 - st.f).abs().max()) <= 1e-4 * float(st.f.abs().max())
    kw = dict(g_ewald=e64.ksp_force.g_ewald, qqr2e=ts.units().qqr2e)
    for _ in range(3):
        st = e64.step(st)
        x, q = st.x.float(), st.q.float()
        ref = TN.block_pair_forces(e64.ncfg, e64.derived_state(st.x)[0],
                                   st.x, st.q, e64.type_idx, e64.tables,
                                   e64.exclusions, **kw)[0]
        nbr = e32.derived_state(x)[0]
        per_pair = TN.block_pair_forces(e32.ncfg, nbr, x, q, e32.type_idx,
                                        e32.tables, e32.exclusions, **kw)[0]
        s1 = TN.block_pair_forces(e32.ncfg, nbr, x, q, e32.type_idx,
                                  e32.tables, None, **kw)[0]
        exi, exv = e32.exclusions
        df = jex(jnp.asarray(x.numpy()), jnp.asarray(q.numpy()),
                 jnp.asarray(ts.type),
                 jtables(ts.lj_eps, ts.lj_sigma, ts.type, jnp.float32),
                 (jnp.asarray(exi.numpy()), jnp.asarray(exv.numpy())),
                 box=ts.box, periodic=ts.periodic, cutsq=tmd.cutoff ** 2,
                 qqr2e=kw["qqr2e"])[0]
        subtract = s1.double() + torch.as_tensor(np.asarray(df, np.float64))
        scale = float(ref.abs().max())
        err = float((per_pair.double() - ref).abs().max()) / scale
        err_sub = float((subtract - ref).abs().max()) / scale
        assert err <= 1e-5 and err_sub > 10.0 * err
