"""Port vs JAX package: the tile pair path (``pair_path="tile"``: K4 over
the live tile pairs of atoms in k-d bricks), float64 on the CPU.

* The orderings ``kd_perm`` (tiles of 128 and 32), ``morton_perm`` and
  ``hilbert_perm`` give the JAX package's permutation (distinct keys).
* ``tile_mask3`` gives JAX ``_tile_mask3``'s live set at the same order
  and tile size, and ``pair_tile_count`` JAX's count.
* K4's plain item sweep (``pair_forces(order=..., pair_cap=...)`` on the
  CPU) in the kd and morton orders against JAX ``pair_forces_pallas(...,
  order=..., interpret=True)`` on test_pallas_pair.py's 1,564-atom system
  (tiles of 32 here, 128 there): f to rtol 1e-7 and atol 1e-8, the
  energies to 1e-12 (that test's bounds); the fused CONP correction
  against the plain dense sweep's; NaN at ``pair_cap = count // 2`` in
  both packages.
* The item list: each live tile pair once, i-major, its row ranges and
  its by-column index covering every item exactly once.
* ``tile_drift_exceeded`` equal to JAX's at drifts below, at and past
  the margin.
* ``pair_path="tile"`` off the card builds what the JAX engine builds off
  its accelerator: the Verlet list above 8,192 atoms in a box four
  cutoffs wide, else the dense sweep (and one dense step equal to JAX's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops import pppm as jpppm
from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
from lammps_user_conp2_tpu.ops.pallas import pair_kernel as jpk
from lammps_user_conp2_tpu.ops.pallas import zorder as jz
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import pppm as tpppm
from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as tpk
from lammps_user_conp2_tpu_torch.ops.kernels import zorder as tz
from lammps_user_conp2_tpu_torch.ops.pairs import make_pair_tables
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import CPU64, S2, S3, SOLVE64, pppm_cell, x_near

torch.set_num_threads(2)

# test_pallas_pair.py's system and bounds
F_RTOL, F_ATOL, E_RTOL = 1e-7, 1e-8, 1e-12
JAX_ORDER = {"kd": "kd128", "morton": "morton", "hilbert": "hilbert",
             "z": "z"}


@pytest.fixture(scope="module")
def morton_case():
    system, md, _ = twl.synthetic(n_elyte=1500, nele_side=8, lz=40.0,
                                  lxy=30.0)
    rng = np.random.default_rng(7)
    x = system.x0 + 0.05 * rng.standard_normal(system.x0.shape)
    return system, md, x


def _jax_perm(name, x, box, periodic, tr):
    if name == "kd":
        return jz.kd_perm(jnp.asarray(x), box, periodic, tr=tr)[0]
    return jz.ORDERINGS[name](jnp.asarray(x), box, periodic)[0]


@pytest.mark.parametrize("name,tr", [("kd", 128), ("kd", 32),
                                     ("morton", 128), ("hilbert", 128)])
def test_orderings_match_jax(morton_case, name, tr):
    system, _, x = morton_case
    box, per = system.box, system.periodic
    jp = np.asarray(_jax_perm(name, x, box, per, tr))
    tp, zs = tpk.order_atoms(torch.as_tensor(x), box, per, name, tr)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(zs.numpy(), tz.wrap_z(
        torch.as_tensor(x[:, 2]), box[2], per[2])[tp].numpy())
    assert sorted(tp.tolist()) == list(range(system.natoms))


def _wrapped(x, perm, box, per, tr):
    n = x.shape[0]
    ni = tpk.odd_tiles(n, tr)
    xp = np.concatenate([x[perm], np.full((ni * tr - n, 3), 1e6)])
    xw = np.array(jz.wrap_coords(jnp.asarray(xp), box, per))
    return xw, np.arange(ni * tr) < n, ni


@pytest.mark.parametrize("name,tr", [("kd", 128), ("kd", 32),
                                     ("morton", 128), ("z", 128)])
def test_tile_mask3_and_count_match_jax(morton_case, name, tr):
    system, md, x = morton_case
    box, per = system.box, system.periodic
    perm = np.asarray(_jax_perm(name, x, box, per, tr))
    xw, valid, ni = _wrapped(x, perm, box, per, tr)
    njp = (ni + 1) // 2
    jm = np.asarray(jpk._tile_mask3(jnp.asarray(xw), jnp.asarray(valid), ni,
                                    tr, njp, float(md.cutoff),
                                    tuple(float(b) for b in box), per))
    tm = tpk.tile_mask3(torch.as_tensor(xw), torch.as_tensor(valid), ni, tr,
                        njp, md.cutoff, box, per)
    np.testing.assert_array_equal(tm.numpy(), jm)
    tc = tpk.pair_tile_count(torch.as_tensor(x), box=box, periodic=per,
                             cutoff=md.cutoff, tr=tr, order=name)
    assert tc == int(jm.sum())
    if name != "kd" or tr == 128:
        # the JAX package names its k-d orders by tile size (kd128, kd256)
        assert tc == jpk.pair_tile_count(
            jnp.asarray(x), box=box, periodic=per, cutoff=md.cutoff, tr=tr,
            order=JAX_ORDER[name])
    assert tc < ni * njp


def _inputs(system, x):
    u = system.units()
    kw = dict(box=system.box, periodic=system.periodic, cutoff=5.0,
              g_ewald=0.35, qqr2e=u.qqr2e)
    return kw, jnp.asarray(x), jnp.asarray(system.q0), jnp.asarray(
        system.type)


@pytest.mark.parametrize("name", ["kd", "morton"])
def test_item_sweep_matches_jax_interpret(morton_case, name):
    system, md, x = morton_case
    kw, jx, jq, jt = _inputs(system, x)
    n = system.natoms
    excl = (jnp.full((n, 1), n), jnp.ones((n, 1)))
    jtab = jtables(system.lj_eps, system.lj_sigma, system.type)
    jcnt = jpk.pair_tile_count(jx, box=system.box, periodic=system.periodic,
                               cutoff=md.cutoff, tr=128,
                               order=JAX_ORDER[name])
    jf, jev, jec = jpk.pair_forces_pallas(
        jx, jq, jt, jtab, excl, tr=128, tc=128, order=JAX_ORDER[name],
        pair_cap=jcnt + 8, interpret=True, **kw)
    tx = torch.as_tensor(x)
    targs = (tx, torch.as_tensor(system.q0), torch.as_tensor(system.type),
             make_pair_tables(system.lj_eps, system.lj_sigma), None)
    cnt = tpk.pair_tile_count(tx, box=system.box, periodic=system.periodic,
                              cutoff=md.cutoff, order=name)
    tf, tev, tec = tpk.pair_forces(*targs, order=name, pair_cap=cnt + 8,
                                   **kw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=F_RTOL,
                               atol=F_ATOL)
    assert float(tev) == pytest.approx(float(jev), rel=E_RTOL)
    assert float(tec) == pytest.approx(float(jec), rel=E_RTOL)
    # a cap below the live count: NaN in both packages
    _, jev2, _ = jpk.pair_forces_pallas(
        jx, jq, jt, jtab, excl, tr=128, tc=128, order=JAX_ORDER[name],
        pair_cap=max(jcnt // 2, 1), interpret=True, **kw)
    tf2, tev2, tec2 = tpk.pair_forces(*targs, order=name,
                                      pair_cap=max(cnt // 2, 1), **kw)
    assert not np.isfinite(float(jev2))
    assert not np.isfinite(float(tev2)) and not np.isfinite(float(tec2))
    assert bool(torch.isnan(tf2).all())


def test_item_sweep_fused_and_excluded_match_dense():
    """The item sweep with the fused CONP correction and special-bond
    exclusions on S3 (ions 1 A from the walls, random electrode charges,
    listed pairs among the ions) against the plain dense sweep and the
    plain correction: the same function, f to rtol 1e-10 of max|f|."""
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels.pair_kernel import (
        pair_forces_plain)
    from torch_cells import charges_with_electrodes, x_close
    system, md, cfg = twl.synthetic(**S3)
    eng = build_engine(system, md, tsetup(system, md, cfg, **SOLVE64),
                       **CPU64)
    n = system.natoms
    x = torch.as_tensor(x_close(system))
    q = torch.as_tensor(charges_with_electrodes(system))
    rng = np.random.default_rng(4)
    ions = np.arange(eng.conp.ne, n)
    a, b = rng.choice(ions, 30, replace=False).reshape(2, 15)
    exi = np.full((n, 2), n, np.int64)
    exv = np.ones((n, 2))
    exi[a, 0], exi[b, 0] = b, a
    exv[a, 0] = exv[b, 0] = 0.5
    excl = (torch.as_tensor(exi), torch.as_tensor(exv))
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=eng.ksp_force.g_ewald, qqr2e=system.units().qqr2e)
    ref = pair_forces_plain(x, q, eng.type_idx, eng.tables, excl,
                            conp_fuse=fuse, **kw)
    got = tpk.pair_forces(x, q, eng.type_idx, eng.tables, excl, order="kd",
                          conp_fuse=fuse, ele_idx=eng.conp.ele_idx_t, **kw)
    scale = float(ref[0].abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= 1e-10 * scale
    for k in (1, 2, 3):
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-10)
    assert abs(float(ref[3])) > 1e-3


def test_item_list_and_column_index(morton_case):
    """Each live tile pair is an item once, i-major; row_off brackets each
    row tile's items; the by-column index lists every item exactly once,
    each under its column tile, in item order; pads sit past the count."""
    system, md, x = morton_case
    tx = torch.as_tensor(x)
    perm, _ = tpk.order_atoms(tx, system.box, system.periodic, "kd")
    items = tpk.tile_items(tx, perm, box=system.box, periodic=system.periodic,
                           cutoff=md.cutoff)
    ni = items.row_off.shape[0] - 1
    njp = (ni + 1) // 2
    cap = items.ti.shape[0]
    cnt = int(items.count[0])
    assert cap == ni * njp and 0 < cnt < cap
    ti, tj = items.ti.long().numpy(), items.tj.long().numpy()
    meta = items.meta.numpy()
    live = np.arange(cap) < cnt
    assert (meta[live] & 1).all() and not meta[~live].any()
    assert (ti[~live] == ni).all() and (tj[~live] == ni).all()
    jp = (tj[live] - ti[live]) % ni
    keys = ti[live] * njp + jp
    assert (np.diff(keys) > 0).all()          # i-major, each pair once
    assert ((meta[live] & 2) != 0).tolist() == (jp == 0).tolist()
    assert ((meta[live] & 4) != 0).sum() == len(np.unique(ti[live]))
    row_off = items.row_off.long().numpy()
    col_off = items.col_off.long().numpy()
    col = items.col_items.long().numpy()
    for t in range(ni):
        assert (ti[row_off[t]:row_off[t + 1]] == t).all()
        mine = col[col_off[t]:col_off[t + 1]]
        assert (tj[mine] == t).all() and (np.diff(mine) > 0).all()
    assert row_off[-1] == cnt and col_off[-1] == cnt
    assert sorted(col[:cnt].tolist()) == list(range(cnt))
    packed = items.packed.numpy()
    assert packed.dtype == np.int32 and packed.shape == (4 * cap + 2 * (
        ni + 1) + 1,)


def test_tile_drift_exceeded_matches_jax():
    js, jmd, jcfg = pppm_cell(jwl, JK, cell=S3)
    ts, tmd, tcfg = pppm_cell(twl, TK, cell=S3)
    jgrid = jsetup(js, jmd, jcfg).pppm_grid
    tgrid = tsetup(ts, tmd, tcfg, **SOLVE64).pppm_grid
    x0 = np.asarray(x_near(ts))
    n = ts.natoms
    geom = tpppm._tile_geometry(tgrid, n)
    cell = np.array([tgrid.box[0] / tgrid.nx, tgrid.box[1] / tgrid.ny,
                     tgrid.zprd_grid / tgrid.nz])
    lim = 0.9 * geom.dm * cell
    tasg = tpppm.tile_assign(tgrid, torch.as_tensor(x0))
    jasg = jpppm.TileAssign(None, None, None, jnp.asarray(x0))
    rng = np.random.default_rng(0)
    for ax in range(3):
        for scale, want in ((0.5, False), (0.999, False), (1.001, True),
                            (2.0, True)):
            x = x0 + rng.uniform(-0.4, 0.4, x0.shape) * lim
            x[7, ax] = x0[7, ax] + scale * lim[ax]
            j = bool(jpppm.tile_drift_exceeded(jgrid, jasg, jnp.asarray(x)))
            t = bool(tpppm.tile_drift_exceeded(tgrid, tasg,
                                               torch.as_tensor(x)))
            assert t == j == want, (ax, scale)


def test_tile_path_off_the_card_builds_what_jax_builds():
    # above 8,192 atoms in a box four cutoffs wide: the Verlet list
    js, jmd, _ = jwl.synthetic(n_elyte=8200, nele_side=4, lz=40.0, lxy=24.0)
    ts, tmd, _ = twl.synthetic(n_elyte=8200, nele_side=4, lz=40.0, lxy=24.0)
    jmd = dataclasses.replace(jmd, pair_path="tile")
    tmd = dataclasses.replace(tmd, pair_path="tile")
    jeng = jbuild(js, jmd, None)
    teng = tbuild(ts, tmd, None, **CPU64)
    assert jeng.ncfg is not None and teng.ncfg is not None
    assert jeng.ncfg.block == teng.ncfg.block == 0
    assert jeng.pair_cap is None and teng.pair_cap is None
    assert teng.cell_grid is None and teng.split_step
    # S2 (640 atoms): the dense sweep, one step equal to JAX's
    js, jmd, jcfg = jwl.synthetic(**S2)
    ts, tmd, tcfg = twl.synthetic(**S2)
    jmd = dataclasses.replace(jmd, pair_path="tile")
    tmd = dataclasses.replace(tmd, pair_path="tile")
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    assert jeng.ncfg is None and teng.ncfg is None
    assert jeng.pair_cap is None and teng.pair_cap is None
    assert not teng.split_step
    x0 = x_near(ts)
    jst, _ = jeng.run(jeng.init_state(x0=x0), 1, thermo_every=1)
    tst = teng.step(teng.init_state(x0=x0))
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                               atol=1e-10)
    assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-10)
