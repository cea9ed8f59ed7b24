"""The kernel wrappers' dtype route, on the CPU (``build.kernel_route``).

* The rule: a CPU tensor takes the plain version (any dtype), a CUDA
  float32 tensor the kernel, a CUDA float64 tensor the plain version, and
  a CUDA tensor of any other dtype raises TypeError.  Without a card the
  CUDA tensors are stand-ins that carry a CUDA device and a dtype.
* Per wrapper (K4 ``pair_forces``, ``tile_schedule``; K5 ``b_realspace``,
  ``elyte_order``; K6 ``conp_correction``, ``corr_orders``; K1
  ``block_pair``, ``pack_rows``; K2a ``spread_mesh``; K2b
  ``spread_tiles``; K3 ``gather3``; K7 ``shake_positions``; K8
  ``rattle_velocities``; K9 ``window_gather``; K10 ``integrate_half``;
  the dense mesh's stencil kernels ``mesh_spread`` and ``mesh_gather``,
  through ``ops/pppm.py`` ``spread`` and ``gather3``),
  float64 inputs on the CPU:
  the wrapper consults the rule with the tensor it dispatches on; where
  the rule says CUDA float64, it returns its plain version's result bit
  for bit with no launch counted; where the rule says CUDA float16, it
  raises TypeError before any launch.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.ops import pppm as P
from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
from lammps_user_conp2_tpu_torch.ops.kernels import build
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
from lammps_user_conp2_tpu_torch.ops.kernels import mesh_stencil as kms
from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
from torch_cells import (CPU64, S1, S3, SOLVE64, il_small, il_small_file,
                         x_near)

torch.set_num_threads(2)


def card(dtype):
    """A stand-in for a CUDA tensor of ``dtype`` (what the rule reads)."""
    return SimpleNamespace(device=torch.device("cuda", 0), is_cuda=True,
                           dtype=dtype)


@pytest.mark.parametrize("dtype,route", [
    (torch.float32, True), (torch.float64, False), (torch.float16, None),
    (torch.bfloat16, None), (torch.int32, None)])
def test_rule(dtype, route):
    if route is None:
        with pytest.raises(TypeError, match="float32"):
            build.kernel_route("k", card(dtype))
    else:
        assert build.kernel_route("k", card(dtype)) is route
    # a CPU tensor of any dtype takes the plain version
    assert build.kernel_route("k", torch.zeros(2, dtype=dtype)) is False


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The wrappers' inputs, float64 on the CPU: S1 (dense), S3 with PPPM
    on the block list and the tiled mesh, the test-size il cell."""
    out = {}
    system, md, cfg = twl.synthetic(**S1)
    conp = setup_conp(system, md, cfg, **SOLVE64)
    eng = build_engine(system, md, conp, **CPU64)
    x = torch.as_tensor(x_near(system))
    q = torch.as_tensor(system.q0)
    out["S1"] = (system, md, conp, eng, x, q)
    system, md, cfg = twl.synthetic(**S3)
    md = dataclasses.replace(md, pair_path="block", pppm_diff="ad",
                             kspace_style=KSpaceStyle.PPPM)
    cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    use_dense = P._use_dense
    P._use_dense = lambda grid, n: False
    try:
        conp = setup_conp(system, md, cfg, **SOLVE64)
        eng = build_engine(system, md, conp, **CPU64)
        x = torch.as_tensor(x_near(system))
        q = torch.as_tensor(system.q0)
        nbr, tasg = eng.derived_state(x)
        grid = eng.pppm_grid
        geom = P._tile_geometry(grid, system.natoms)
        slots = P.refresh_tile_slots(grid, tasg, x, q)
        cf = P._coeffs(grid, torch.float64, x.device)
        _, uz = P.pppm_energy_u_zbin(grid, P._spread_rhok_tiled(
            grid, x, q, slots), system.natoms)
    finally:
        P._use_dense = use_dense
    up = P._wrap_pad_xy(uz, geom.hw + geom.dm).contiguous()
    out["S3"] = (system, md, eng, x, q, nbr, slots.rows, cf, geom, up)
    path = il_small_file(tmp_path_factory.mktemp("il"))
    system, md, cfg = il_small(twl, path)
    eng = build_engine(system, md, setup_conp(system, md, cfg, **SOLVE64),
                       **CPU64)
    out["il"] = (system, md, eng)
    rng = np.random.default_rng(11)
    grid = P.setup_pppm(box=(10.0, 11.0, 30.0), box_lo=(0.0, 0.0, 0.0),
                        accuracy_abs=1e-4, natoms=50, q2=1.0, cutoff=5.0,
                        g_ewald=0.3, grid=(8, 9, 20))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    out["mesh"] = (grid, t(rng.uniform(0, 10, (50, 3))), t(rng.normal(
        size=50)), [t(rng.normal(size=grid.shape)) for _ in range(3)])
    return out


def _calls(cells):
    """name -> (dispatch counter or None, wrapper call, plain call)."""
    system, md, conp, eng, x, q = cells["S1"]
    pkw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    zs = z_perm(x, system.box, system.periodic)
    q_el = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    bargs = (x, q_el, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
             conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    cargs = (x, q, eng.type_idx, conp.ele_idx_t, eng.ele_flag,
             eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    ckw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               qqr2e=system.units().qqr2e)
    skw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff)
    s3, md3, eng3, x3, q3, nbr, rows, cf, geom, up = cells["S3"]
    kw3 = dict(box=s3.box, periodic=s3.periodic, cutoff=md3.cutoff,
               g_ewald=eng3.ksp_force.g_ewald, qqr2e=s3.units().qqr2e)
    fuse3 = (eng3.ele_flag, eng3.elyte_flag, eng3.eta_tab, eng3.fo_tab)
    a3 = (x3, q3, eng3.type_idx, nbr.bun, nbr.brows, eng3.tables)
    sil, mil, eil = cells["il"]
    xo = torch.as_tensor(sil.x0)
    xn = xo + mil.dt * torch.as_tensor(sil.v0)
    v = torch.as_tensor(sil.v0)
    hkw = dict(box=sil.box, periodic=sil.periodic)
    win = torch.rand((2, 64, 128), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 64, (2, 64, 128), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    itg = eil.integrator
    chain = torch.full((len(itg.thermostats), itg.thermostats[0].tchain),
                       0.01, dtype=torch.float64)
    iargs = (itg, v, 3.0 * v, xo, chain, 2.0 * chain, ("nhc", "kick", "drift"))
    mg, mx, mq, mf = cells["mesh"]
    return {
        "pair_forces": (k4.launches, lambda: k4.pair_forces(
            x, q, eng.type_idx, eng.tables, None, conp_fuse=fuse,
            ele_idx=conp.ele_idx_t, **pkw), lambda: k4.pair_forces_plain(
            x, q, eng.type_idx, eng.tables, None, conp_fuse=fuse, **pkw)),
        "tile_schedule": (None, lambda: k4.tile_schedule(
            zs[1], x.shape[0], **skw), lambda: k4.tile_schedule_plain(
            zs[1], x.shape[0], **skw)),
        "b_realspace": (k56.launches, lambda: k56.b_realspace(
            *bargs, zsort=zs, **bkw), lambda: k56.b_realspace_plain(
            *bargs, **bkw)),
        "elyte_order": (None, lambda: k56.elyte_order(
            zs[0], zs[1], conp.elyte_f), lambda: k56.elyte_order_plain(
            zs[0], zs[1], conp.elyte_f)),
        "conp_correction": (k56.corr_launches, lambda: k56.conp_correction(
            *cargs, zsort=zs, **ckw), lambda: k56.conp_correction_plain(
            *cargs, **ckw)),
        "corr_orders": (None, lambda: k56.corr_orders(
            zs[0], zs[1], eng.elyte_flag, eng.ele_flag), lambda: (
            k56.elyte_order_plain(zs[0], zs[1], eng.elyte_flag),
            k56.elyte_order_plain(zs[0], zs[1], eng.ele_flag))),
        "block_pair": (k1.launches, lambda: k1.block_pair(
            *a3, conp_fuse=fuse3, **kw3), lambda: k1.block_pair_plain(
            *a3, conp_fuse=fuse3, **kw3)),
        "pack_rows": (None, lambda: k1.pack_rows(
            x3, q3, eng3.type_idx, fuse3[:2]), lambda: k1.pack_rows_plain(
            x3, q3, eng3.type_idx, fuse3[:2])),
        "spread_mesh": (k2.launches, lambda: k2.spread_mesh(rows, cf, geom),
                        lambda: k2.spread_mesh_plain(rows, cf, geom)),
        "spread_tiles": (k2.tiles_launches, lambda: k2.spread_tiles(
            rows, cf, geom), lambda: k2.tile_patches_plain(rows, cf, geom)),
        "gather3": (k3.launches, lambda: k3.gather3(up, rows, cf, geom),
                    lambda: k3.gather3_plain(up, rows, cf, geom)),
        "shake_positions": (k78.shake_launches, lambda: k78.shake_positions(
            eil.cons, xn, xo, mil.dt, **hkw),
            lambda: k78.shake_positions_plain(eil.cons, xn, xo, mil.dt,
                                              **hkw)),
        "rattle_velocities": (k78.rattle_launches,
                              lambda: k78.rattle_velocities(
                                  eil.cons, xo, v, **hkw),
                              lambda: k78.rattle_velocities_plain(
                                  eil.cons, xo, v, **hkw)),
        "window_gather": (k9.launches, lambda: k9.window_gather(win, idx, 3),
                          lambda: k9.window_gather_plain(win, idx, 3)),
        "integrate_half": (ik.launches, lambda: ik.integrate_half(*iargs),
                           lambda: ik.integrate_half_plain(*iargs)),
        "mesh_spread": (kms.spread_launches, lambda: P.spread(mg, mx, mq),
                        lambda: P._spread_dense(mg, mx, mq)),
        "mesh_gather": (kms.gather_launches, lambda: P.gather3(
            mg, mf, mx, scale=mq), lambda: mq[:, None] * P._gather3_dense(
            mg, mf, mx)),
    }


WRAPPERS = ["pair_forces", "tile_schedule", "b_realspace", "elyte_order",
            "conp_correction", "corr_orders", "block_pair", "pack_rows",
            "spread_mesh", "spread_tiles", "gather3", "shake_positions",
            "rattle_velocities", "window_gather", "integrate_half",
            "mesh_spread", "mesh_gather"]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_routes_by_dtype(cells, name, monkeypatch):
    counter, call, plain = _calls(cells)[name]
    real = build.kernel_route
    seen = []

    def as_card(dtype):
        def route(wname, t):
            seen.append((wname, t.dtype))
            return real(wname, card(dtype))
        return route

    # the CPU float64 inputs take the plain version under the real rule
    n0 = None if counter is None else counter.count
    for got, ref in zip(_flat(call()), _flat(plain())):
        assert torch.equal(got, ref)
    # on the card in float64: the plain version, bit for bit, no launch
    monkeypatch.setattr(build, "kernel_route", as_card(torch.float64))
    for got, ref in zip(_flat(call()), _flat(plain())):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert seen and seen[0] == (name, torch.float64)
    if counter is not None:
        assert counter.count == n0
    # on the card in float16: a TypeError, no launch
    monkeypatch.setattr(build, "kernel_route", as_card(torch.float16))
    with pytest.raises(TypeError, match=name):
        call()
    if counter is not None:
        assert counter.count == n0
