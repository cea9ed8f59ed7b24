"""Port vs JAX package: the large-N engine path (Verlet list, PPPM with the
electrode z planes) as a whole.

* float64, S3 with PPPM and pair_path "nlist" / "block": 20 steps of
  build_engine -> init_state(x_near) -> step against the JAX engine, x to
  1e-8 A, q to 1e-8 e, pe to 1e-9 relative; a 0.3 A skin makes the list
  and the mesh tiles rebuild inside the window.
* float32 with the tiled z-binned mesh forced (``_use_dense`` patched to
  False in both packages, as tests/test_pppm_tiled.py does): forces of one
  solve + force evaluation against JAX float32 to 5e-5 of the largest.
* overflow recovery: with neighbor_kmax=24, or half the tile slot
  capacity on the forced tiled mesh, the run NaN-poisons, regrows the
  capacity and matches the ample-capacity run.
* PPPM setup above KXY_CHUNK (S4: 1,411 xy vectors): setup_conp builds no
  factored Ewald in PPPM mode, and A^-1 matches the JAX setup to 1e-8;
  the EWALD setup of the same cell (the chunked sums) matches it too.
* one step from a JAX PPPM-mode state and context through ``interop``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops import pppm as JP
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import ewald_factored as ewf
from lammps_user_conp2_tpu_torch.ops import pppm as TP
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import (CPU64, S3, S4, SOLVE64, pppm_cell, rel_err,
                         x_near)

torch.set_num_threads(2)
NSTEPS = 20


def _engines(pair_path, **md_kw):
    js, jmd, jcfg = pppm_cell(jwl, JK, pair_path=pair_path, **md_kw)
    ts, tmd, tcfg = pppm_cell(twl, TK, pair_path=pair_path, **md_kw)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    return jeng, teng, x_near(ts)


@pytest.fixture(scope="module", params=["nlist", "block"])
def engines(request):
    # a 0.3 A skin so the list (and the mesh tiles) rebuild within 20 steps
    return _engines(request.param, neighbor_skin=0.3)


def test_engine_20_steps_match(engines):
    jeng, teng, x0 = engines
    assert teng.ncfg is not None and teng.pppm_grid is not None
    assert teng.ncfg.block == jeng.ncfg.block
    assert (teng.ncfg.k_max, teng.ncfg.u_max) == (jeng.ncfg.k_max,
                                                  jeng.ncfg.u_max)
    assert teng.mesh_persist == jeng.mesh_persist
    np.testing.assert_array_equal(teng.conp.ele_zplanes,
                                  jeng.conp.ele_zplanes)
    ne = teng.conp.ne
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
    for i in range(NSTEPS):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-9)
        assert abs(float(tst.q[:ne].sum())) < 1e-10
    assert teng.rebuilds >= 1          # the skin trigger fired on the way
    assert abs(float(tst.q[:ne].abs().max())) > 1e-3


def test_one_step_from_jax_state_and_context(engines):
    """The per-step path apart from the setup: a JAX PPPM-mode context and
    mid-run state through interop; the list and tiles are rebuilt at x."""
    jeng, teng, x0 = engines
    jst = jeng.init_state(x0=x0)
    jst, _ = jeng.run(jst, 3, thermo_every=1)
    js1, _ = jeng.run(jst, 1, thermo_every=1)
    saved = teng.conp.ctx
    jctx = {k: np.asarray(v) for k, v in jeng.conp.ctx._asdict().items()}
    teng.conp.load_context(interop.context_from_numpy(jctx, **CPU64))
    try:
        fields = {k: np.asarray(v) for k, v in jst._asdict().items()
                  if v is not None and k not in ("nbr", "tasg")}
        out = teng.step(interop.state_from_numpy(fields, engine=teng,
                                                 **CPU64))
        np.testing.assert_allclose(out.x.numpy(), np.asarray(js1.x), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(out.q.numpy(), np.asarray(js1.q), rtol=0,
                                   atol=1e-11)
        assert rel_err(out.f.numpy(), js1.f) < 1e-9
        assert float(out.energy) == pytest.approx(float(js1.energy),
                                                  rel=1e-11)
    finally:
        teng.conp.load_context(saved)


def test_f32_forced_tiled_forces_match(monkeypatch):
    monkeypatch.setattr(JP, "_use_dense", lambda grid, n: False)
    monkeypatch.setattr(TP, "_use_dense", lambda grid, n: False)
    md_kw = dict(pair_path="nlist", pppm_diff="ad")
    js, jmd, jcfg = pppm_cell(jwl, JK, **md_kw)
    ts, tmd, tcfg = pppm_cell(twl, TK, **md_kw)
    jcfg = dataclasses.replace(jcfg, target=0.0)
    tcfg = dataclasses.replace(tcfg, target=0.0)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg, solve_dtype=jnp.float32),
                  dtype=jnp.float32)
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, solve_dtype=torch.float32,
                                  device="cpu"),
                  dtype=torch.float32, device="cpu")
    assert teng.mesh_persist and jeng.mesh_persist
    # init_state = one charge solve + one force evaluation at x0
    jst = jeng.init_state()
    tst = teng.init_state()
    _, _, tkc = teng.conp.solve_full(tst.x, tst.q, tst.nbr, teng.ncfg,
                                     tst.tasg)
    assert tkc[1] is not None          # the tiled slots, not the dense mesh
    jf = np.asarray(jst.f, np.float64)
    assert np.abs(tst.f.double().numpy() - jf).max() < 5e-5 * np.abs(jf).max()
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["list", "tiles"])
def test_overflow_recovery_matches_ample_run(kind, monkeypatch):
    """An undersized capacity NaN-poisons the state; run() regrows it and
    re-runs from the entry state, matching the ample-capacity run.  "list":
    neighbor_kmax=24 (K); "tiles": the tiled mesh forced, half the tile
    slot capacity the cell needs."""
    monkeypatch.setattr(TP, "_use_dense", lambda grid, n: kind == "list")
    ts, tmd, tcfg = pppm_cell(twl, TK, pair_path="nlist", pppm_diff="ad")
    x0 = x_near(ts)
    ok = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    f_ok, th_ok = ok.run(ok.init_state(x0=x0), 5, thermo_every=5)
    if kind == "list":
        small = tbuild(ts, dataclasses.replace(tmd, neighbor_kmax=24),
                       tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
        assert small.ncfg.k_max == 24
    else:
        small = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
        occ = TP.tile_occupancy(small.pppm_grid, torch.as_tensor(x0))
        small.pppm_grid = dataclasses.replace(small.pppm_grid,
                                              tile_cap=occ // 2)
        small.conp.pppm_grid = small.pppm_grid
    st0 = small.init_state(x0=x0)
    assert not np.isfinite(float(st0.energy))
    f_bad, th_bad = small.run(st0, 5, thermo_every=5)
    if kind == "list":
        assert small.ncfg.k_max > 24 and not bool(f_bad.nbr.overflow)
    else:
        assert small.pppm_grid.tile_cap >= occ
    assert np.isfinite(float(f_bad.energy))
    np.testing.assert_allclose(f_bad.x.numpy(), f_ok.x.numpy(), atol=1e-10)
    assert float(th_bad["temp"][-1]) == pytest.approx(
        float(th_ok["temp"][-1]), rel=1e-10)


def test_pppm_setup_above_kxy_chunk():
    """The charge solve in PPPM mode builds no factored Ewald (the JAX
    package builds it only outside PPPM, or for CG_MATFREE), so a cell
    whose exact Ewald sum has more than KXY_CHUNK xy vectors sets up, and
    A^-1 matches; under EWALD it sets up too, on the chunked sums."""
    js, jmd, jcfg = pppm_cell(jwl, JK, cell=S4)
    ts, tmd, tcfg = pppm_cell(twl, TK, cell=S4)
    tc = tsetup(ts, tmd, tcfg, **SOLVE64)
    assert tc.fksp is None and tc.pppm_grid is not None
    # the exact Ewald of this cell is above the factored path's bound
    assert ewf.factorize(tc.ksp).nxy > ewf.KXY_CHUNK
    jc = jsetup(js, jmd, jcfg)
    assert jc.fksp is None
    ref = np.asarray(jc.ctx.ainv)
    assert rel_err(tc.ainv.numpy(), ref) < 1e-8
    np.testing.assert_allclose(tc.elesetq.numpy(), np.asarray(jc.ctx.elesetq),
                               rtol=1e-8, atol=1e-14)
    # the EWALD solve of the same cell takes the chunked factored sums,
    # and its A^-1 is the same as the JAX package's
    te = tsetup(ts, dataclasses.replace(tmd, kspace_style=TK.EWALD),
                dataclasses.replace(tcfg, kspace=TK.EWALD), **SOLVE64)
    assert te.fksp.nxy > ewf.KXY_CHUNK and not te._ewald_cacheable()
    je = jsetup(js, dataclasses.replace(jmd, kspace_style=JK.EWALD),
                dataclasses.replace(jcfg, kspace=JK.EWALD))
    assert rel_err(te.ainv.numpy(), np.asarray(je.ctx.ainv)) < 1e-8
