"""Port vs JAX package: the sharded step's helpers in one process, float64,
each rank's share computed in turn and put together as the ranks would,
held to 1e-10 relative (or bit for bit where stated).

* ``pairs.pair_rowblock`` over row blocks (the last one padded and masked)
  on the test-size ionic-liquid file, with its special-bond exclusions,
  against the JAX ``pair_rowblock`` over the same blocks and against
  ``dense_pair_forces``;
* ``neighbors.pad_block_list`` plus ``block_pair_rows`` over d block
  slices, their slot forces gathered and ``binv`` applied, against the JAX
  ``block_pair_forces`` on S3 (and its ``block_pair_rows`` slices);
* ``b_realspace_from_list`` and ``conp_correction_rows_from_list`` over
  d electrode shards (padded rows masked), put together and summed,
  against the JAX functions on the whole list; K6's wrapper
  ``conp_correction`` over each shard's real rows (the sharded dense
  path) summed against ``conp_correction_forces``;
* the sharded rebuild (``row_keys`` over d row ranges, the keys put
  together, ``list_from_keys``) against ``build_neighbor_list``, bit for
  bit, with and without the block form;
* the ``*_fkv`` sums over d padded kxy shards (``kxy_shard``) on S4, whose
  1,411 xy vectors take the chunked path at d = 1, against the JAX sums
  over the whole table;
* ``pppm.gather3_ad_tiled`` (the tiled ad readout that replaced the
  port's NotImplementedError) against the JAX ``gather3_ad_tiled`` and the
  port's dense ``gather3_ad``, with ``_use_dense`` patched to False in both
  packages as test_torch_fullmesh.py does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.electrodes import make_kernels as jkernels
from lammps_user_conp2_tpu.models.system import exclusion_lists as jexcl
from lammps_user_conp2_tpu.ops import ewald_factored as jewf
from lammps_user_conp2_tpu.ops import neighbors as JN
from lammps_user_conp2_tpu.ops import pairs as JPR
from lammps_user_conp2_tpu.ops import pppm as JP
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.electrodes import make_kernels
from lammps_user_conp2_tpu_torch.models.system import exclusion_lists
from lammps_user_conp2_tpu_torch.ops import ewald_factored as tewf
from lammps_user_conp2_tpu_torch.ops import neighbors as TN
from lammps_user_conp2_tpu_torch.ops import pairs as TPR
from lammps_user_conp2_tpu_torch.ops import pppm as TP
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k6
from test_torch_pppm import _periodic, _slab
from torch_cells import (S3, S4, SOLVE64, charges_with_electrodes,
                         il_small, il_small_file, rel_err, x_close, x_near)

torch.set_num_threads(2)
G = 0.35
TOL = 1e-10
DS = (2, 3, 4)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _shards(n, d):
    """(i0, nl) of each of d shards of n rows, padded to d nl."""
    nl = -(-n // d)
    return [(r * nl, nl) for r in range(d)]


# --------------------------------------------------------- pair rows
@pytest.fixture(scope="module")
def il_cell(tmp_path_factory):
    path = il_small_file(tmp_path_factory.mktemp("il"))
    ts, tmd, _ = il_small(twl, path)
    js, _, _ = il_small(jwl, path)
    return ts, js, tmd


@pytest.mark.parametrize("block", [96, 125])
def test_pair_rowblock_matches_jax(il_cell, block):
    ts, js, md = il_cell
    n = ts.natoms
    x = np.asarray(ts.x0, np.float64)
    q = np.random.default_rng(3).normal(size=n)
    qqr2e = ts.units().qqr2e
    kw = dict(box=ts.box, periodic=ts.periodic, cutoff=md.cutoff,
              g_ewald=G, qqr2e=qqr2e)
    exi, exv = exclusion_lists(ts)
    assert (exi < n).any()
    tt = TPR.make_pair_tables(ts.lj_eps, ts.lj_sigma)
    jt = JPR.make_pair_tables(js.lj_eps, js.lj_sigma, js.type, jnp.float64)
    jexi, jexv = jexcl(js)
    tx, tq, ty = _t(x), _t(q), _t(ts.type)
    fs, js_f, ev, ec, jev, jec = [], [], 0.0, 0.0, 0.0, 0.0
    for i0, nl in _shards(n, -(-n // block)):
        rows = np.arange(i0, i0 + nl)
        valid = rows < n
        r = np.minimum(rows, n - 1)
        pad = lambda a, fill: np.where(valid.reshape((-1,) + (1,) * (
            a.ndim - 1)), a[r], fill)
        f_b, ev_b, ec_b = TPR.pair_rowblock(
            _t(pad(x, 0.0)), _t(pad(q, 0.0)), _t(pad(ts.type, 0)),
            _t(pad(exi, n)), _t(pad(exv, 1.0)), _t(valid), i0, tx, tq, ty,
            tt, **kw)
        jf_b, jev_b, jec_b = JPR.pair_rowblock(
            jnp.asarray(pad(x, 0.0)), jnp.asarray(pad(q, 0.0)),
            jnp.asarray(pad(js.type, 0)), jnp.asarray(pad(jexi, n)),
            jnp.asarray(pad(jexv, 1.0)), jnp.asarray(valid), i0,
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(js.type), jt, **kw)
        fs.append(f_b.numpy()[valid])
        js_f.append(np.asarray(jf_b)[valid])
        ev, ec = ev + float(ev_b), ec + float(ec_b)
        jev, jec = jev + float(jev_b), jec + float(jec_b)
    f = np.concatenate(fs)
    assert rel_err(f, np.concatenate(js_f)) < TOL
    assert ev == pytest.approx(jev, rel=TOL)
    assert ec == pytest.approx(jec, rel=TOL)
    whole = TPR.dense_pair_forces(tx, tq, ty, tt, (_t(exi), _t(exv)), **kw)
    assert rel_err(f, whole[0].numpy()) < TOL
    assert ev == pytest.approx(float(whole[1]), rel=TOL)
    assert ec == pytest.approx(float(whole[2]), rel=TOL)


# ------------------------------------------------------------- lists
@pytest.fixture(scope="module")
def s3():
    system, md, cfg = twl.synthetic(**S3)
    jsys, _, jcfg = jwl.synthetic(**S3)
    kw = dict(periodic=system.periodic, x0=system.x0, block=8)
    tcfg = TN.make_neighbor_config(system.box, tuple(system.box_lo),
                                   md.cutoff, system.natoms, **kw)
    jncfg = JN.make_neighbor_config(system.box, tuple(system.box_lo),
                                    md.cutoff, system.natoms, **kw)
    tt = TPR.make_pair_tables(system.lj_eps, system.lj_sigma)
    jt = JPR.make_pair_tables(jsys.lj_eps, jsys.lj_sigma, jsys.type,
                              jnp.float64)
    return system, jsys, md, cfg, jcfg, tcfg, jncfg, tt, jt


def _sharded_list(ncfg, x, tables, types, d):
    """The list as the ranks rebuild it: each one's row keys, put
    together in rank order."""
    n = x.shape[0]
    prep = TN.nlist_prep(ncfg, x, types)
    keys, ovf = [], torch.zeros((), dtype=torch.bool)
    for i0, nl in _shards(n, d):
        k, o = TN.row_keys(ncfg, x, prep, min(i0, n), min(i0 + nl, n))
        keys.append(k)
        ovf = ovf | o
    return TN.list_from_keys(ncfg, x, prep, torch.cat(keys), ovf, tables,
                             types)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("block", [0, 8])
def test_sharded_rebuild_bit_for_bit(s3, d, block):
    system, _, _, _, _, tcfg, _, tt, _ = s3
    cfg = dataclasses.replace(tcfg, block=block)
    x = _t(x_near(system))
    types = _t(system.type)
    whole = TN.build_neighbor_list(cfg, x, tt, types)
    got = _sharded_list(cfg, x, tt, types, d)
    assert torch.equal(got.idx, whole.idx)
    assert torch.equal(got.overflow, whole.overflow)
    assert not bool(got.overflow)
    if block:
        for name in ("bun", "brows", "binv"):
            assert torch.equal(getattr(got, name), getattr(whole, name))
    else:
        assert torch.equal(got.lj, whole.lj)
    # a small K overflows in the sharded rebuild too
    small = dataclasses.replace(cfg, k_max=4)
    assert bool(_sharded_list(small, x, tt, types, d).overflow)


def _jax_list(s3, x):
    system, jsys, _, _, _, _, jncfg, _, jt = s3
    return jax.jit(JN.build_neighbor_list, static_argnums=0)(
        jncfg, jnp.asarray(x), jt, jnp.asarray(jsys.type))


@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_block_pair_rows_match_jax(s3, d, fused):
    system, jsys, md, cfg, _, tcfg, jncfg, tt, jt = s3
    x = x_close(system)
    q = charges_with_electrodes(system)
    qqr2e = system.units().qqr2e
    n = system.natoms
    tl = TN.build_neighbor_list(tcfg, _t(x), tt, _t(system.type))
    jl = _jax_list(s3, x)
    kern = make_kernels(cfg, system)
    tfuse = jfuse = None
    if fused:
        flags = ((system.elecheck != 0).astype(float),
                 (~system.ele_mask).astype(float))
        tfuse = tuple(_t(a) for a in flags + (kern.eta_ij, kern.fo_ij))
        jfuse = tuple(jnp.asarray(a) for a in flags + (
            kern.eta_ij, kern.fo_ij)) + (jnp.asarray(jsys.type),)
    tp = TN.pad_block_list(tl, n, d)
    jp = JN.pad_block_list(jl, n, d)
    nb_l = tp.bun.shape[0] // d
    assert tp.bun.shape[0] % d == 0 and nb_l == jp.bun.shape[0] // d
    kw = dict(g_ewald=G, qqr2e=qqr2e)
    parts = [TN.block_pair_rows(tcfg, tp, _t(x), _t(q), r * nb_l, nb_l,
                                _t(system.type), tt, None, conp_fuse=tfuse,
                                **kw) for r in range(d)]
    # the JAX ranks' share: its own slices of its padded list, the last one
    jlast = jax.jit(lambda xx, qq: JN.block_pair_rows(
        jncfg, jp, xx, qq, (d - 1) * nb_l, nb_l, use_pallas=False,
        conp_fuse=jfuse, **kw))(jnp.asarray(x), jnp.asarray(q))
    assert rel_err(parts[-1][0].numpy(), jlast[0]) < TOL
    f = torch.cat([p[0] for p in parts])[:tl.brows.numel()][tl.binv]
    jex = tuple(jnp.asarray(a) for a in jexcl(jsys))
    out = jax.jit(lambda xx, qq: JN.block_pair_forces(
        jncfg, jl, xx, qq, jnp.asarray(jsys.type), jt, jex, use_pallas=False,
        conp_fuse=jfuse, **kw))(jnp.asarray(x), jnp.asarray(q))
    assert rel_err(f.numpy(), out[0]) < TOL
    for i in range(1, 4 if fused else 3):
        tot = sum(float(p[i]) for p in parts)
        assert tot == pytest.approx(float(out[i]), rel=TOL, abs=1e-12)
    if fused:
        assert abs(sum(float(p[3]) for p in parts)) > 1e-3


def _ele_shards(system, d, dev=None):
    """Each shard's (eidx, evalid, eslot) as the sharded engine builds
    them: pad rows point at the first electrode."""
    ele = np.nonzero(system.ele_mask)[0]
    ne, n = len(ele), system.natoms
    out = []
    for e0, nl in _shards(ne, d):
        gid = np.arange(e0, e0 + nl)
        valid = gid < ne
        eidx = ele[np.where(valid, gid, 0)]
        eslot = np.full(n + 1, nl)
        eslot[eidx[valid]] = np.arange(nl)[valid]
        out.append((_t(eidx), _t(valid), _t(eslot)))
    return out


_JREF = {}


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_electrode_rows_over_shards(s3, d, positions):
    system, jsys, md, cfg, jcfg, tcfg, jncfg, tt, _ = s3
    ncfg = dataclasses.replace(tcfg, block=0)
    jnc = dataclasses.replace(jncfg, block=0)
    x = positions(system)
    q = charges_with_electrodes(system)
    ele = np.nonzero(system.ele_mask)[0]
    elyte = ~system.ele_mask
    q_elyte = np.where(elyte, q, 0.0)
    tl = TN.build_neighbor_list(ncfg, _t(x), tt, _t(system.type))
    tk = make_kernels(cfg, system)
    qqr2e = system.units().qqr2e
    cut_coulsq = md.cutoff ** 2
    key = positions.__name__
    if key not in _JREF:
        jk = jkernels(jcfg, jsys)
        jt = jnp.asarray(jsys.type)
        jl = jax.jit(JN.build_neighbor_list, static_argnums=0)(
            jnc, jnp.asarray(x), s3[8], jt)
        _JREF[key] = (JN.b_realspace_from_list(
            jnc, jl, jnp.asarray(x), jnp.asarray(q_elyte), jnp.asarray(ele),
            elyte, jt, jk.potential, g_ewald=G, cut_coulsq=cut_coulsq),
        ) + tuple(JN.conp_correction_from_list(
            jnc, jl, jnp.asarray(x), jnp.asarray(q), jnp.asarray(ele), elyte,
            jt, jk.force, jk.potential, cutoff=md.cutoff, qqr2e=qqr2e))
    jb, jfc, jec = _JREF[key]
    bs, fsum, esum = [], np.zeros((system.natoms, 3)), 0.0
    dsum, desum = np.zeros((system.natoms, 3)), 0.0
    ty = _t(system.type)
    for eidx, evalid, eslot in _ele_shards(system, d):
        b = TN.b_realspace_from_list(
            ncfg, tl, _t(x), _t(q_elyte), eidx, _t(elyte), ty,
            tk.potential, g_ewald=G, cut_coulsq=cut_coulsq)
        bs.append(b.numpy()[evalid.numpy()])
        fc, ec = TN.conp_correction_rows_from_list(
            ncfg, tl, _t(x), _t(q), eidx, evalid, eslot, _t(elyte), ty,
            tk.force, tk.potential, cutoff=md.cutoff, qqr2e=qqr2e)
        fsum, esum = fsum + fc.numpy(), esum + float(ec)
        # the dense path: K6's wrapper on the shard's real rows, with the
        # shard's electrode flags
        mine = eidx[evalid]
        ele_f = torch.zeros(system.natoms, dtype=torch.float64)
        ele_f[mine] = 1.0
        fd, ed = k6.conp_correction(
            _t(x), _t(q), ty, mine, ele_f, _t(elyte, torch.float64),
            _t(tk.eta_ij), _t(tk.fo_ij), box=system.box,
            periodic=system.periodic, cutoff=md.cutoff, qqr2e=qqr2e)
        dsum, desum = dsum + fd.numpy(), desum + float(ed)
    np.testing.assert_allclose(np.concatenate(bs), np.asarray(jb), rtol=0,
                               atol=1e-12)
    assert np.abs(np.asarray(jb)).max() > 0.0
    sc = max(np.abs(np.asarray(jfc)).max(), 1e-300)
    assert np.abs(fsum - np.asarray(jfc)).max() <= max(TOL * sc, 1e-12)
    assert esum == pytest.approx(float(jec), rel=TOL, abs=1e-12)
    whole, ew = TPR.conp_correction_forces(
        _t(x), _t(q), _t(ele), _t(elyte), tk.force, tk.potential, ty,
        box=system.box, periodic=system.periodic, cutoff=md.cutoff,
        qqr2e=qqr2e)
    assert np.abs(dsum - whole.numpy()).max() <= max(
        TOL * float(whole.abs().max()), 1e-12)
    assert desum == pytest.approx(float(ew), rel=TOL, abs=1e-12)
    if positions is x_close:
        assert abs(esum) > 1e-3


# ----------------------------------------------------------- k-space
@pytest.fixture(scope="module")
def s4():
    system, md, cfg = twl.synthetic(**S4)
    sol = tsetup(system, md, cfg, **SOLVE64)
    return system, sol.fksp, jewf.factorize(sol.ksp)


@pytest.mark.parametrize("d", (1,) + DS)
def test_fkv_over_kxy_shards(s4, d):
    system, tfk, jfk = s4
    x = x_near(system)
    q = charges_with_electrodes(system, seed=7)
    ne = int(system.ele_mask.sum())
    assert tfk.nxy > tewf.KXY_CHUNK
    tx, tq = _t(x), _t(q)
    if "fkv" not in _JREF:
        jx, jq = jnp.asarray(x), jnp.asarray(q)
        kz, kv = jnp.asarray(jfk.kz), jnp.asarray(jfk.kxy)
        jsr, jsi = jewf.structure_factor_fkv(jx, jq, kv, kz, jfk.unitk)
        _JREF["fkv"] = (jewf.potential_on_points_fkv(
            jx[:ne], jsr, jsi, kv, kz, jfk.unitk, jfk.ug),) + tuple(
            jewf.energy_forces_fkv(jx, jq, kv, kz, jfk.unitk, jfk.ug)) + (
            jewf.make_phi_operator_kv(jx[:ne], kv, kz, jfk.unitk, jfk.ug)(
                jnp.asarray(q[:ne])),)
    jphi, je, jf, jop = _JREF["fkv"]
    phi = e = f = op = 0.0
    rows = 0
    for r in range(d):
        kx, ky, ug = tewf.kxy_shard(tfk, d, r)
        assert kx.shape[0] == ky.shape[0] == ug.shape[0] == -(-tfk.nxy // d)
        rows += int((ug != 0).any(dim=1).sum())
        sr, si = tewf.structure_factor_fkv(tx, tq, kx, ky, tfk.kz_t,
                                           tfk.unitk)
        phi = phi + tewf.potential_on_points_fkv(tx[:ne], sr, si, kx, ky,
                                                 tfk.kz_t, tfk.unitk, ug)
        e_r, f_r = tewf.energy_forces_fkv(tx, tq, kx, ky, tfk.kz_t,
                                          tfk.unitk, ug)
        e, f = e + e_r, f + f_r
        op = op + tewf.make_phi_operator_kv(tx[:ne], kx, ky, tfk.kz_t,
                                            tfk.unitk, ug)(_t(q[:ne]))
    assert rows == tfk.nxy
    assert rel_err(phi.numpy(), jphi) < TOL
    assert float(e) == pytest.approx(float(je), rel=TOL)
    assert rel_err(f.numpy(), jf) < TOL
    assert rel_err(op.numpy(), jop) < TOL


# -------------------------------------------------------- ad gather
@pytest.fixture(scope="module", params=["slab", "periodic"])
def grids(request):
    box, x, q, kw = (_slab if request.param == "slab" else _periodic)()
    args = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0, **kw)
    return JP.setup_pppm(**args), TP.setup_pppm(**args), x, q


def test_gather3_ad_tiled_matches_jax(grids, monkeypatch):
    jg, tg, x, q = grids
    dense = TP.gather3_ad(tg, TP.poisson_u(tg, TP.spread(tg, _t(x), _t(q))),
                          _t(x))
    monkeypatch.setattr(JP, "_use_dense", lambda grid, n: False)
    monkeypatch.setattr(TP, "_use_dense", lambda grid, n: False)
    u = TP.poisson_u(tg, TP.spread(tg, _t(x), _t(q)))
    got = TP.gather3_ad(tg, u, _t(x))
    direct = TP.gather3_ad_tiled(tg, u, _t(x))
    assert torch.equal(got, direct)
    ref = JP.gather3_ad_tiled(jg, jnp.asarray(u.numpy()), jnp.asarray(x))
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), ref) < TOL
    assert rel_err(got.numpy(), dense.numpy()) < TOL
    # tile overflow poisons the readout
    small = dataclasses.replace(tg, tile_cap=2)
    assert torch.isnan(TP.gather3_ad_tiled(small, u, _t(x))).all()
