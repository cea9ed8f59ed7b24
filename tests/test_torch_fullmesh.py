"""Port vs JAX package: the real-mesh tiled PPPM path (K2b) and the engine
paths that read the electrodes through the full mesh, float64 unless
stated.

* K2b's plain version (``tile_patches_plain``) against the JAX Mosaic
  kernel ``spread_tiles_pallas`` in interpret mode, float32, 2e-6 of the
  largest patch value.
* ``_overlap_add``, ``_pad_brick``, ``spread_tiled``, ``gather_tiled`` (one
  and three meshes) and the tiled branches of ``spread``/``gather``/
  ``gather3`` against the JAX functions on the slab (z-span tiles, the
  production geometry) and the periodic-z grid of test_torch_pppm.py, to
  1e-10 of the largest value, with ``_use_dense`` patched to False in both
  packages (tests/test_pppm_tiled.py's way); tile overflow gives NaN.
* 20 engine steps against the JAX engine (x 1e-8 A, q 1e-8 e, pe 1e-9
  relative) for PPPM with rough electrodes that touch more z planes than
  max(nz/4, 16) (the full-mesh b vector and electrode re-spread), and for
  ``mobile_electrodes=True`` on the forced tiled mesh with the ik force
  readout (the tiled gather3) and the ad one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops import pppm as JP
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import pppm as TP
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from test_torch_pppm import _periodic, _slab
from torch_cells import CPU64, SOLVE64, pppm_cell, x_near

torch.set_num_threads(2)
NSTEPS = 20


@pytest.fixture(scope="module", params=["slab", "periodic"])
def grids(request):
    box, x, q, kw = (_slab if request.param == "slab" else _periodic)()
    args = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0, **kw)
    return JP.setup_pppm(**args), TP.setup_pppm(**args), x, q, request.param


@pytest.fixture
def tiled(monkeypatch):
    """Both packages' meshes forced onto the tiled path."""
    monkeypatch.setattr(JP, "_use_dense", lambda grid, n: False)
    monkeypatch.setattr(TP, "_use_dense", lambda grid, n: False)


def _close(t, j, tol=1e-10):
    t, j = t.numpy(), np.asarray(j)
    assert np.isfinite(t).all()
    assert np.abs(t - j).max() <= tol * np.abs(j).max()


def test_k2b_plain_matches_jax_kernel(grids):
    from lammps_user_conp2_tpu.ops.pallas.pppm_spread import (
        spread_tiles_pallas)
    jg, tg, x, q, _ = grids
    geom = TP._tile_geometry(tg, len(x))
    _, ex, ey, ez = TP._patch_dims(geom)
    sl = jax.jit(lambda xj, qj: JP._pack_slot_rows(
        JP.tile_slots(jg, xj, qj), jnp.float32, geom.t_tiles, geom.cap))(
            jnp.asarray(x, jnp.float32), jnp.asarray(q, jnp.float32))
    ref = np.asarray(spread_tiles_pallas(sl, jg.coeffs, ex=ex, ey=ey, ez=ez,
                                         cap=geom.cap, interpret=True))
    cf = torch.as_tensor(tg.coeffs, dtype=torch.float32)
    got = k2.spread_tiles(torch.as_tensor(np.array(sl)), cf, geom)
    assert got.shape == ref.shape == (geom.t_tiles, ex * ey, ez)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
    assert k2.tiles_launches.count == 0        # nothing launched on the CPU


def test_overlap_add_and_pad_match(grids):
    """The overlap-add (span mode: the z ring, bin 0 at the top of the
    mesh) and the wrap pad of the readout, on random patches and meshes."""
    jg, tg, x, q, kind = grids
    geom = TP._tile_geometry(tg, len(x))
    assert geom.z_span == (kind == "slab")
    _, ex, ey, ez = TP._patch_dims(geom)
    rng = np.random.default_rng(11)
    patches = rng.standard_normal((geom.t_tiles, ex * ey, ez))
    ref = np.asarray(JP._overlap_add(jnp.asarray(patches), geom, jg.nz))
    got = TP._overlap_add(torch.as_tensor(patches), geom, tg.nz)
    assert got.shape == ref.shape == tuple(tg.shape)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    mesh = rng.standard_normal(tg.shape)
    np.testing.assert_array_equal(
        TP._pad_brick(torch.as_tensor(mesh), geom, tg.nz).numpy(),
        np.asarray(JP._pad_brick(jnp.asarray(mesh), geom, jg.nz)))


def test_spread_tiled_matches(grids, tiled):
    jg, tg, x, q, _ = grids
    xt, qt = torch.as_tensor(x), torch.as_tensor(q)
    ref = jax.jit(lambda a, b: JP.spread_tiled(jg, a, b))(jnp.asarray(x),
                                                          jnp.asarray(q))
    _close(TP.spread_tiled(tg, xt, qt), ref)
    # spread() takes the tiled branch, with or without given slots
    _close(TP.spread(tg, xt, qt), ref)
    _close(TP.spread(tg, xt, qt, slots=TP.tile_slots(tg, xt, qt)), ref)
    # the whole mesh: the charge lands, nothing is lost in the ring
    assert float(TP.spread(tg, xt, qt).sum()) == pytest.approx(
        float(q.sum()), abs=1e-9)


@pytest.mark.parametrize("nfields", [1, 3])
def test_gather_tiled_matches(grids, tiled, nfields):
    jg, tg, x, q, _ = grids
    rng = np.random.default_rng(12)
    meshes = [rng.standard_normal(tg.shape) for _ in range(nfields)]
    xt = torch.as_tensor(x)
    ref = jax.jit(lambda a, *ms: JP.gather_tiled(jg, list(ms), a))(
        jnp.asarray(x), *[jnp.asarray(m) for m in meshes])
    got = TP.gather_tiled(tg, [torch.as_tensor(m) for m in meshes], xt)
    assert len(got) == nfields
    for g, r in zip(got, ref):
        _close(g, r)
    if nfields == 1:
        _close(TP.gather(tg, torch.as_tensor(meshes[0]), xt), ref[0])
    else:
        _close(TP.gather3(tg, [torch.as_tensor(m) for m in meshes], xt),
               np.stack([np.asarray(r) for r in ref], axis=1))


def test_tiled_overflow_fails_loud(grids, tiled):
    jg, tg, x, q, _ = grids
    small = dataclasses.replace(tg, tile_cap=4)
    xt, qt = torch.as_tensor(x), torch.as_tensor(q)
    assert torch.isnan(TP.spread_tiled(small, xt, qt)).all()
    assert torch.isnan(TP.gather(small, torch.zeros(tg.shape,
                                                    dtype=torch.float64),
                                 xt)).all()


def _rough(wl, kenum, **md_kw):
    """S3 with PPPM at accuracy 1e-3 (a 15 x 15 x 72 mesh) and rough
    electrodes: every third wall atom 1.8 A outward and every third inward,
    so the stencils touch more z planes than max(nz/4, 16) = 18."""
    system, md, cfg = pppm_cell(wl, kenum, kspace_accuracy=1e-3, **md_kw)
    x0 = np.array(system.x0)
    ele = system.ele_mask
    z = x0[ele, 2]
    side = np.where(z < 0.5 * system.box[2], -1.0, 1.0)
    x0[ele, 2] = z + side * 1.8 * ((np.arange(int(ele.sum())) % 3) - 1)
    return dataclasses.replace(system, x0=x0), md, cfg


def _mobile(wl, kenum, **md_kw):
    system, md, cfg = pppm_cell(wl, kenum, **md_kw)
    return system, md, dataclasses.replace(cfg, mobile_electrodes=True)


def _run_both(cell, **md_kw):
    js, jmd, jcfg = cell(jwl, JK, **md_kw)
    ts, tmd, tcfg = cell(twl, TK, **md_kw)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    assert teng.conp.ele_zplanes is None and jeng.conp.ele_zplanes is None
    x0 = x_near(ts)
    jst, tst = jeng.init_state(x0=x0), teng.init_state(x0=x0)
    ne = teng.conp.ne
    assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
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
    assert float(tst.q[:ne].abs().max()) > 1e-3
    return teng


def test_rough_electrodes_engine_20_steps_match():
    """Dense mesh (the 15 x 15 mesh is under the dense bound): the b vector
    through the full inverse FFT and the stencil readout, the electrode
    re-spread through spread() + rfft3."""
    teng = _run_both(_rough)
    assert TP._use_dense(teng.pppm_grid, teng.system.natoms)


@pytest.mark.parametrize("diff", ["ik", "ad"])
def test_mobile_electrodes_tiled_engine_20_steps_match(tiled, diff):
    """The forced tiled mesh: the electrode re-spread through spread_tiled
    (K2b's plain version), the b vector through gather_tiled, and the ik
    forces through the tiled gather3 (ad: the z-binned gather)."""
    teng = _run_both(_mobile, pair_path="nlist", pppm_diff=diff)
    assert not TP._use_dense(teng.pppm_grid, teng.conp.ne)
