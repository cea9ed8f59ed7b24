"""Port vs JAX package: the Verlet list, its block form and the sweeps over
them, on S3 (float64 unless stated).

The lists must be identical element for element (rows sorted by id in both
packages): the per-atom ids, the block unions and binv.  The sweeps match
to 1e-10 relative (forces, energies), the electrode rows to 1e-12 absolute.
K1's plain version is held to the JAX XLA twin (float64) and to the JAX
Mosaic kernel in interpret mode (float32, 2e-6 of the largest force), fused
and unfused, at positions 5 A and 3 A from the walls; fused must equal the
unfused sweep plus the separate electrode-row correction."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.system import exclusion_lists
from lammps_user_conp2_tpu.ops import neighbors as JN
from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.electrodes import make_kernels
from lammps_user_conp2_tpu_torch.ops import neighbors as TN
from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
from lammps_user_conp2_tpu_torch.ops.pairs import make_pair_tables
from torch_cells import S3, charges_with_electrodes, rel_err, x_close, x_near

torch.set_num_threads(2)
G = 0.35


@pytest.fixture(scope="module")
def cell():
    system, md, cfg = twl.synthetic(**S3)
    jsys, _, _ = jwl.synthetic(**S3)
    kw = dict(periodic=system.periodic, x0=system.x0)
    jcfg = JN.make_neighbor_config(system.box, tuple(system.box_lo),
                                   md.cutoff, system.natoms, block=8, **kw)
    tcfg = TN.make_neighbor_config(system.box, tuple(system.box_lo),
                                   md.cutoff, system.natoms, block=8, **kw)
    return system, jsys, md, cfg, jcfg, tcfg


_LISTS = {}


def _lists(cell, positions, dtype=np.float64):
    """Both packages' lists (block 0 and 8) at these positions, built once
    per (positions, dtype)."""
    key = (positions.__name__, np.dtype(dtype).name)
    if key not in _LISTS:
        _LISTS[key] = _build_lists(cell, positions, dtype)
    return _LISTS[key]


def _build_lists(cell, positions, dtype):
    system, jsys, md, cfg, jcfg, tcfg = cell
    x = positions(system).astype(dtype)
    jt = jtables(jsys.lj_eps, jsys.lj_sigma, jsys.type, jnp.dtype(dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tt = make_pair_tables(system.lj_eps, system.lj_sigma, dtype=tdt)
    ti = torch.as_tensor(system.type)
    out = {}
    for block in (0, 8):
        jc = jcfg.__class__(**{**jcfg.__dict__, "block": block})
        tc = tcfg.__class__(**{**tcfg.__dict__, "block": block})
        jl = jax.jit(JN.build_neighbor_list, static_argnums=0)(
            jc, jnp.asarray(x), jt, jnp.asarray(jsys.type))
        tl = TN.build_neighbor_list(tc, torch.as_tensor(x), tt, ti)
        out[block] = (jc, jl, tc, tl)
    return x, jt, tt, ti, out


def test_config_sizing_matches(cell):
    _, _, _, _, jcfg, tcfg = cell
    assert (tcfg.k_max, tcfg.grid.cap, tcfg.grid.ncells, tcfg.u_max) == (
        jcfg.k_max, jcfg.grid.cap, jcfg.grid.ncells, jcfg.u_max)


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_lists_identical(cell, positions):
    _, _, _, _, jcfg, _ = cell
    x, _, _, _, lists = _lists(cell, positions)
    for block in (0, 8):
        jc, jl, tc, tl = lists[block]
        assert not bool(tl.overflow) and not bool(jl.overflow)
        np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
        np.testing.assert_array_equal(tl.x_ref.numpy(), x)
        if block:
            np.testing.assert_array_equal(tl.bun.numpy(), np.asarray(jl.bun))
            np.testing.assert_array_equal(tl.brows.numpy(),
                                          np.asarray(jl.brows))
            np.testing.assert_array_equal(tl.binv.numpy(),
                                          np.asarray(jl.binv))
        else:
            np.testing.assert_array_equal(tl.lj.numpy(), np.asarray(jl.lj))
    xt = torch.as_tensor(x)
    assert TN.max_union_count(lists[8][2], xt, lists[0][3]) == \
        JN.max_union_count(lists[8][0], jnp.asarray(x), lists[0][1])


def test_overflow_and_rebuild_flags(cell):
    """A too-small K sets the overflow flag; a move beyond skin/2 asks for
    a rebuild in both packages."""
    system, jsys, md, cfg, jcfg, tcfg = cell
    x, jt, tt, ti, lists = _lists(cell, x_near)
    small = tcfg.__class__(**{**tcfg.__dict__, "k_max": 4, "block": 0})
    tl = TN.build_neighbor_list(small, torch.as_tensor(x), tt, ti)
    assert bool(tl.overflow)
    _, jl, tc, tl = lists[0]
    x2 = x.copy()
    for step in (0.49 * tc.skin, 0.51 * tc.skin):
        x2[7, 0] = x[7, 0] + step
        assert bool(TN.needs_rebuild(tc, tl, torch.as_tensor(x2))) == bool(
            JN.needs_rebuild(lists[0][0], jl, jnp.asarray(x2))) == (
            step > 0.5 * tc.skin)


@pytest.mark.parametrize("path", ["nlist", "block"])
@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_sweeps_match_f64(cell, path, positions):
    system, jsys, md, cfg, _, _ = cell
    x, jt, tt, ti, lists = _lists(cell, positions)
    q = charges_with_electrodes(system)
    qqr2e = system.units().qqr2e
    jc, jl, tc, tl = lists[8 if path == "block" else 0]
    jsweep = JN.block_pair_forces if path == "block" else JN.nlist_pair_forces
    tsweep = TN.block_pair_forces if path == "block" else TN.nlist_pair_forces
    jex = tuple(jnp.asarray(a) for a in exclusion_lists(jsys))
    jf, jev, jec, _ = jax.jit(lambda xx, qq: jsweep(
        jc, jl, xx, qq, jnp.asarray(jsys.type), jt, jex, g_ewald=G,
        qqr2e=qqr2e))(jnp.asarray(x), jnp.asarray(q))
    tf, tev, tec, ov = tsweep(tc, tl, torch.as_tensor(x), torch.as_tensor(q),
                              ti, tt, None, g_ewald=G, qqr2e=qqr2e)
    assert not bool(ov)
    assert rel_err(tf.numpy(), jf) < 1e-10
    assert float(tev) == pytest.approx(float(jev), rel=1e-10)
    assert float(tec) == pytest.approx(float(jec), rel=1e-10)


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_electrode_rows_from_list(cell, positions):
    system, jsys, md, cfg, _, _ = cell
    x, jt, tt, ti, lists = _lists(cell, positions)
    jc, jl, tc, tl = lists[0]
    q = charges_with_electrodes(system)
    ele = np.nonzero(system.ele_mask)[0]
    elyte = ~system.ele_mask
    q_elyte = np.where(elyte, q, 0.0)
    from lammps_user_conp2_tpu.models.electrodes import make_kernels as jmk
    jk, tk = jmk(jwl.synthetic(**S3)[2], jsys), make_kernels(cfg, system)
    cut_coulsq = md.cutoff ** 2
    jb = JN.b_realspace_from_list(
        jc, jl, jnp.asarray(x), jnp.asarray(q_elyte), jnp.asarray(ele), elyte,
        jnp.asarray(jsys.type), jk.potential, g_ewald=G, cut_coulsq=cut_coulsq)
    tb = TN.b_realspace_from_list(
        tc, tl, torch.as_tensor(x), torch.as_tensor(q_elyte),
        torch.as_tensor(ele), torch.as_tensor(elyte), ti, tk.potential,
        g_ewald=G, cut_coulsq=cut_coulsq)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-12)
    assert np.abs(np.asarray(jb)).max() > 0.0
    qqr2e = system.units().qqr2e
    jfc, jec = JN.conp_correction_from_list(
        jc, jl, jnp.asarray(x), jnp.asarray(q), jnp.asarray(ele), elyte,
        jnp.asarray(jsys.type), jk.force, jk.potential, cutoff=md.cutoff,
        qqr2e=qqr2e)
    tfc, tec = TN.conp_correction_from_list(
        tc, tl, torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(ele),
        torch.as_tensor(elyte), ti, tk.force, tk.potential, cutoff=md.cutoff,
        qqr2e=qqr2e)
    np.testing.assert_allclose(tfc.numpy(), np.asarray(jfc), rtol=0,
                               atol=1e-12)
    assert float(tec) == pytest.approx(float(jec), rel=1e-12, abs=1e-12)


def _k1_inputs(cell, positions, dtype):
    system, jsys, md, cfg, _, _ = cell
    x, jt, tt, ti, lists = _lists(cell, positions, dtype)
    jc, jl, tc, tl = lists[8]
    q = charges_with_electrodes(system).astype(dtype)
    kern = make_kernels(cfg, system)
    ele_f = (system.elecheck != 0).astype(dtype)
    ely_f = (~system.ele_mask).astype(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    tfuse = (f(ele_f), f(ely_f), f(kern.eta_ij), f(kern.fo_ij))
    jfuse = (jnp.asarray(ele_f), jnp.asarray(ely_f),
             jnp.asarray(kern.eta_ij, dtype), jnp.asarray(kern.fo_ij, dtype),
             jnp.asarray(jsys.type))
    targs = (torch.as_tensor(x), torch.as_tensor(q), ti, tl.bun, tl.brows, tt)
    tkw = dict(box=tc.grid.box, periodic=tc.grid.periodic, cutoff=tc.cutoff,
               g_ewald=G, qqr2e=system.units().qqr2e)
    return system, jsys, x, q, jc, jl, jt, tc, tl, tfuse, jfuse, targs, tkw


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_k1_plain_matches_jax_twin_f64(cell, positions, fused):
    (system, jsys, x, q, jc, jl, jt, tc, tl, tfuse, jfuse, targs,
     tkw) = _k1_inputs(cell, positions, np.float64)
    jout = JN._block_sweep(jc, jnp.asarray(x), jnp.asarray(q), jl.bun,
                           jl.brows, jl.bcr, jl.btu, system.natoms,
                           g_ewald=G, qqr2e=tkw["qqr2e"], use_pallas=False,
                           conp_fuse=jfuse if fused else None)
    tout = k1.block_pair(*targs, conp_fuse=tfuse if fused else None, **tkw)
    assert len(tout) == len(jout) == (4 if fused else 3)
    assert rel_err(tout[0].numpy(), jout[0]) < 1e-10
    for a, b in zip(tout[1:], jout[1:]):
        assert float(a) == pytest.approx(float(b), rel=1e-10, abs=1e-12)
    if fused and positions is x_close:
        assert abs(float(tout[3])) > 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_k1_plain_matches_jax_kernel_f32(cell, positions, fused):
    """The JAX Mosaic kernel (interpret mode) in float32."""
    from lammps_user_conp2_tpu.ops.pallas.block_pair import block_pair_pallas
    (system, jsys, x, q, jc, jl, jt, tc, tl, tfuse, jfuse, targs,
     tkw) = _k1_inputs(cell, positions, np.float32)
    cols = [jnp.asarray(x), jnp.asarray(q)[:, None]]
    sent = [1e6, 1e6, 1e6, 0.0]
    bcr = jl.bcr.astype(jnp.float32)
    if fused:
        cols.append((jfuse[0] - jfuse[1])[:, None])
        sent.append(0.0)
        tr = jnp.pad(jnp.asarray(jsys.type), (0, 1))[jl.brows]
        bcr = jnp.concatenate([bcr, jfuse[2][tr][None], jfuse[3][tr][None]])
    xqp = jnp.concatenate([jnp.concatenate(cols, axis=1),
                           jnp.asarray([sent], jnp.float32)])
    jout = jax.jit(lambda xqp, bcr: block_pair_pallas(
        xqp[jl.bun], xqp[jl.brows], jl.bun, jl.brows, bcr, jl.btu,
        box=jc.grid.box, periodic=jc.grid.periodic, cutoff=jc.cutoff,
        g_ewald=G, qqr2e=tkw["qqr2e"], npts=system.natoms,
        interpret=True))(xqp, bcr)
    tout = k1.block_pair(*targs, conp_fuse=tfuse if fused else None, **tkw)
    sc = float(np.abs(np.asarray(jout[0])).max())
    assert np.abs(tout[0].numpy() - np.asarray(jout[0])).max() < 2e-6 * sc
    for a, b in zip(tout[1:], jout[1:]):
        assert float(a) == pytest.approx(float(b), rel=2e-5, abs=1e-4)


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_k1_fused_equals_unfused_plus_correction(cell, positions):
    (system, jsys, x, q, jc, jl, jt, tc, tl, tfuse, jfuse, targs,
     tkw) = _k1_inputs(cell, positions, np.float64)
    kern = make_kernels(cell[3], system)
    ti, tt = targs[2], targs[5]
    xt, qt = targs[0], targs[1]
    kw = dict(g_ewald=G, qqr2e=tkw["qqr2e"])
    ff, evf, ecf, ecorr_f, _ = TN.block_pair_forces(
        tc, tl, xt, qt, ti, tt, None, conp_fuse=tfuse, **kw)
    f0, ev0, ec0, _ = TN.block_pair_forces(tc, tl, xt, qt, ti, tt, None, **kw)
    fc, ecorr_s = TN.conp_correction_from_list(
        tc, tl, xt, qt, torch.as_tensor(np.nonzero(system.ele_mask)[0]),
        torch.as_tensor(~system.ele_mask), ti, kern.force, kern.potential,
        cutoff=tc.cutoff, qqr2e=tkw["qqr2e"])
    assert rel_err(ff.numpy(), (f0 + fc).numpy()) < 1e-12
    assert float(ecorr_f) == pytest.approx(float(ecorr_s), rel=1e-12,
                                           abs=1e-14)
    assert (float(evf), float(ecf)) == (float(ev0), float(ec0))


def test_exclusion_correction_matches(cell):
    """Special-bond exclusions on random exclusion lists (the synthetic
    cells have no bonds): the port applies them per pair in both sweeps
    (per-atom rows and K1's plain version), the JAX package sweeps at s = 1
    and adds its ``ops/cells.exclusion_correction`` afterwards; both give
    the same forces and energies in float64."""
    from lammps_user_conp2_tpu.ops.cells import exclusion_correction as jex
    system, jsys, md, cfg, _, _ = cell
    x, jt, tt, ti, lists = _lists(cell, x_near)
    n = system.natoms
    rng = np.random.default_rng(3)
    idx = np.full((n, 3), n, np.int64)
    jc, jl, tc, tl = lists[0]
    for i in range(0, n, 3):                    # list neighbours, factor 0/0.5
        nb = np.asarray(jl.idx[i])
        nb = nb[nb < n][:2]
        idx[i, :len(nb)] = nb
    val = rng.choice([0.0, 0.5], size=(n, 3))
    q = charges_with_electrodes(system)
    qqr2e = system.units().qqr2e
    jexcl = (jnp.asarray(idx), jnp.asarray(val))
    texcl = (torch.as_tensor(idx), torch.as_tensor(val))
    djf = jex(jnp.asarray(x), jnp.asarray(q), jnp.asarray(jsys.type), jt,
              jexcl, box=tc.grid.box, periodic=tc.grid.periodic,
              cutsq=md.cutoff ** 2, qqr2e=qqr2e)[0]
    assert np.abs(np.asarray(djf)).max() > 0.0
    for block, jsweep, tsweep in ((0, JN.nlist_pair_forces,
                                   TN.nlist_pair_forces),
                                  (8, JN.block_pair_forces,
                                   TN.block_pair_forces)):
        jc, jl, tc, tl = lists[block]
        jf, jev, jec, _ = jsweep(
            jc, jl, jnp.asarray(x), jnp.asarray(q), jnp.asarray(jsys.type),
            jt, jexcl, g_ewald=G, qqr2e=qqr2e)
        tf, tev, tec, _ = tsweep(
            tc, tl, torch.as_tensor(x), torch.as_tensor(q), ti, tt, texcl,
            g_ewald=G, qqr2e=qqr2e)
        assert rel_err(tf.numpy(), jf) < 1e-10
        assert float(tev) == pytest.approx(float(jev), rel=1e-10)
        assert float(tec) == pytest.approx(float(jec), rel=1e-10)
