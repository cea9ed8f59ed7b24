"""CUDA kernels against their plain versions on the card (float32, S2 and
S3 at the near-wall positions): max|kernel - plain| / max|plain| <= 2e-5
per output (tools/kernel_oracle.py's measure; 5e-5 for SHAKE/RATTLE on
the test-size ionic-liquid cell, also across the periodic x face), a CUDA
float64 tensor takes the plain version on the card (no launch) and a
float16 one raises, and the engines' main paths launch their kernels
(K4 and K5 on the mid-size path; K1, K2a and K3 on the Verlet-list +
tiled-PPPM path; K7 and K8 on the ionic-liquid deck; K1 with the cations'
exclusions on the deck's block path; K6 and not K4 with
use_pallas_pair=False, whose correction energy from anions 2 A off the
sheets agrees with the CPU float64 engine's; K2b on the mobile-electrode
tiled mesh); K9, the window gather probe, equals its plain version
bit for bit (the probe's shapes, R = 8, 1 and 3, one block, W off the
TMA box, idx at the ends), one kernel per call.  K1's packed rows equal their plain version, and K1 (unfused,
fused, with exclusions) with its unions swept whole or in segments; K2a on
slot rows of 1, 2 and 9 tiles per axis and on a tile over two staging
passes; both bit-identical across two launches.  K5 on shuffled atoms
(electrodes not first), its electrolyte
order kernel equal to ``elyte_order_plain``; K4 also on clusters of 33
and 100 atoms (ragged tiles), its tile-pair schedule kernel equal to
``tile_schedule_plain``, and K4 and K5 bit-identical across two
launches.  The step replayed as CUDA graphs (``Engine.run``) equals the
eager steps, and two eager runs each other, bit for bit (mid-size, tiled
list, ionic-liquid, bonded block, unfused and mobile-electrode cells, and
S2 under CG with nevery 2 and with a float64 solve under a float32
engine); the blocked CG equals a per-iteration host loop bit for bit; the
bonded forces are bit-identical across calls; the launch counters reading as after
eager steps, no host sync per step on the dense path and one on the list
path, and new graphs captured after a capacity growth; K6 over the
correction's range against its plain version over the full cutoff with the
anions 1 and 1.2 A off the sheets, bit-identical across two launches;
K7 and K8 equal to their plain versions bit for bit (every LAMMPS cluster
shape, the il decks' cation, clusters across the periodic face, a cluster
within 1e-6 of a minimum-image tie, unaligned arrays, the il and bonded
cells), two launches alike, one CUDA kernel per call.  The cell-list and
tile paths (S3 on the tiled mesh, the il cell on the tile path): graphed
against eager bit for bit, one flag read per step on the tile path and
none on the cell path; K4's item-list entry against its plain version
(kd bricks, fused, with exclusions), bit-identical across launches, NaN
at half the live count; ``run`` recovering from a short cell cap and a
short pair cap.
K10 (one half step of the integrator) at 432, 3,776 and 100,000 rows (the
one-CTA and the two-launch forms), 1 and 2 thermostats: the chain state
within a float32 ulp of the plain version in float64, the rows within
float32 rounding of it, the kick alone equal to the plain version bit for
bit, two launches alike; the integrator's part of a step is 2 CUDA
kernels at the dilute deck and 6 at the il cell (K10 3 times, K7, K8 and
the SHAKE velocity add), K10 launching 2 and 3 times per graphed step.
The sharded run at d = 1 over NCCL replays CUDA graphs equal to the eager
sharded steps bit for bit.  The graphs captured under ``timers.tracing``
(timing events at the layer boundaries) step the same bits as the
unmarked ones (il, tiled list, CG), their marks adding up to the step's
device time at il; the list path counts one flag read per step.
Needs a CUDA device: skipped on the CPU.  Run on the card with
``python -m pytest --noconftest tests/test_torch_gpu.py -q``."""

import numpy as np
import pytest
import torch

from torch_cells import (S2, S3, SHAKE_SHAPES, charges_with_electrodes,
                         il_small, il_small_file, integrator_case, shake_case,
                         tile_rows, x_close, x_near)

pytestmark = pytest.mark.gpu
TOL = 2e-5
SHAKE_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _cell(cuda, positions):
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    system, md, cfg = workloads.synthetic(**S2)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=cuda)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
    x = torch.as_tensor(positions(system), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    return system, md, conp, eng, x, q


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_kernels_match_plain_on_card(cuda, positions):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, positions)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    for cf in (None, fuse):
        got = k4.pair_forces(x, q, eng.type_idx, eng.tables, None,
                             conp_fuse=cf, **kw)
        ref = k4.pair_forces_plain(x, q, eng.type_idx, eng.tables, None,
                                   conp_fuse=cf, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    args = (x, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
            conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    b = k5.b_realspace(*args, **bkw)
    assert _rel(b, k5.b_realspace_plain(*args, **bkw)) <= TOL
    # float64 on the card takes the plain version; float16 raises
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    n0 = k5.launches.count
    assert torch.equal(k5.b_realspace(*a64, **bkw),
                       k5.b_realspace_plain(*a64, **bkw))
    assert k5.launches.count == n0
    with pytest.raises(TypeError):
        k5.b_realspace(*(a.half() if a.is_floating_point() else a
                         for a in args), **bkw)


def test_engine_launches_kernels(cuda):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, x_near)
    k4.launches.reset()
    k5.launches.reset()
    st, _ = eng.run(eng.init_state(x0=x.cpu().numpy()), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert (k4.launches.count, k5.launches.count) == (4, 4)
    assert np.isfinite(float(st.energy))


def test_kernels_periodic_z_on_card(cuda):
    """The periodic-z branches: K4's minimum-image tile gap and K5's three
    z windows, in a fully periodic box, against the plain versions."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, x_close)
    periodic = (True, True, True)
    kw = dict(box=system.box, periodic=periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    # shift z so atoms straddle the periodic z face
    xs = x.clone()
    xs[:, 2] = torch.remainder(xs[:, 2] + 0.5 * system.box[2] - 1.0,
                               system.box[2]) - 0.3
    got = k4.pair_forces(xs, q, eng.type_idx, eng.tables, None,
                         conp_fuse=fuse, **kw)
    ref = k4.pair_forces_plain(xs, q, eng.type_idx, eng.tables, None,
                               conp_fuse=fuse, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    args = (xs, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
            conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    b = k5.b_realspace(*args, **bkw)
    ref_b = k5.b_realspace_plain(*args, **bkw)
    assert float(ref_b.abs().max()) > 0.0 and _rel(b, ref_b) <= TOL


def test_b_rows_any_layout_on_card(cuda):
    """K5 takes its columns from the electrolyte mask, not from the atoms'
    order: the S2 atoms shuffled (electrodes no longer first) give the
    plain version's rows, and its first kernel's electrolyte order equals
    its plain version exactly."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
    system, md, conp, eng, x, q = _cell(cuda, x_near)
    order = torch.as_tensor(np.random.default_rng(5).permutation(
        system.natoms), device=cuda)
    where = torch.empty_like(order)
    where[order] = torch.arange(system.natoms, device=cuda)
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    args = (x[order].contiguous(), q_elyte[order].contiguous(),
            where[conp.ele_idx_t].contiguous(),
            conp.elyte_f[order].contiguous(), conp.eta_rows, conp.fo_rows,
            conp.type_t[order].contiguous())
    assert not bool((args[2] == torch.arange(conp.ne, device=cuda)).all())
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    b = k5.b_realspace(*args, **bkw)
    ref_b = k5.b_realspace_plain(*args, **bkw)
    assert float(ref_b.abs().max()) > 0.0 and _rel(b, ref_b) <= TOL
    for periodic in (system.periodic, (True, True, True)):
        perm, zs = z_perm(args[0], system.box, periodic)
        got = k5.elyte_order(perm, zs, args[3])
        ref = k5.elyte_order_plain(perm, zs, args[3])
        assert torch.equal(got[0].long(), ref[0])
        assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("n", [33, 100])
def test_pair_kernel_small_n_on_card(cuda, n):
    """K4 on the n atoms of the S2 cell nearest a point 2 A inside the left
    wall (electrodes and ions, one ragged tile or four), fused and not."""
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, x_close)
    p = x[conp.ele_idx_t].mean(0)
    p[2] = float(x[:conp.ne // 2, 2].mean()) + 2.0
    idx = torch.argsort(((x - p) ** 2).sum(1))[:n].sort().values
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = tuple(t[idx].contiguous() for t in (eng.ele_flag, eng.elyte_flag))
    fuse = fuse + (eng.eta_tab, eng.fo_tab)
    assert float(fuse[0].sum()) > 0 and float(fuse[1].sum()) > 0
    args = (x[idx].contiguous(), q[idx].contiguous(),
            eng.type_idx[idx].contiguous(), eng.tables, None)
    for cf in (None, fuse):
        got = k4.pair_forces(*args, conp_fuse=cf, **kw)
        ref = k4.pair_forces_plain(*args, conp_fuse=cf, **kw)
        torch.cuda.synchronize()
        assert float(ref[0].abs().max()) > 0.0
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_tile_schedule_kernel_matches_plain_on_card(cuda, positions):
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
    system, md, conp, eng, x, q = _cell(cuda, positions)
    for periodic, cut in ((system.periodic, md.cutoff),
                          ((True, True, True), md.cutoff),
                          ((True, True, True), 0.6 * system.box[2])):
        _, zs = z_perm(x, system.box, periodic)
        kw = dict(box=system.box, periodic=periodic, cutoff=cut)
        got = k4.tile_schedule(zs, system.natoms, **kw)
        ref = k4.tile_schedule_plain(zs, system.natoms, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g.long(), r)


def test_kernels_bit_identical_across_launches_on_card(cuda, tmp_path):
    """Fixed-order sums, no atomics: two launches on the same input give
    the same bits (K4 fused, with the il fixture's exclusions; K5)."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, eng = _il_cell(cuda, tmp_path)
    conp = eng.conp
    x = torch.as_tensor(system.x0, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    run = lambda: k4.pair_forces(x, q, eng.type_idx, eng.tables,
                                 eng.exclusions, conp_fuse=fuse, **kw)
    a, b = run(), run()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    bargs = (x, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
             conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    assert torch.equal(k5.b_realspace(*bargs, **bkw),
                       k5.b_realspace(*bargs, **bkw))


def _tiled_cell(cuda, positions, monkeypatch=None, pair_path="block"):
    """S3 with PPPM, the block list (or ``pair_path``) and the tiled
    z-binned mesh forced (through ``monkeypatch`` when given)."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import pppm
    from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
    if monkeypatch is not None:
        monkeypatch.setattr(pppm, "_use_dense", lambda grid, n: False)
    system, md, cfg = workloads.synthetic(**S3)
    md = dataclasses.replace(md, pair_path=pair_path, pppm_diff="ad",
                             kspace_style=KSpaceStyle.PPPM)
    cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=cuda)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
    x = torch.as_tensor(positions(system), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    return system, md, conp, eng, x, q, pppm


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_large_path_kernels_match_plain_on_card(cuda, positions, monkeypatch):
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    system, md, conp, eng, x, q, pppm = _tiled_cell(cuda, positions)
    nbr, tasg = eng.derived_state(x)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    args = (x, q, eng.type_idx, nbr.bun, nbr.brows, eng.tables)
    # the periodic-z minimum image too: z shifted so pairs straddle the face
    xs = x.clone()
    xs[:, 2] = torch.remainder(xs[:, 2] + 0.5 * system.box[2] - 1.0,
                               system.box[2]) - 0.3
    kwp = dict(kw, periodic=(True, True, True))
    for xx, kk in ((x, kw), (xs, kwp)):
        pargs = (xx,) + args[1:]
        for cf in (None, fuse):
            got = k1.block_pair(*pargs, conp_fuse=cf, **kk)
            ref = k1.block_pair_plain(*pargs, conp_fuse=cf, **kk)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    grid = eng.pppm_grid
    geom = P._tile_geometry(grid, system.natoms)
    slots = P.refresh_tile_slots(grid, tasg, x, q)
    cfd = P._coeffs(grid, torch.float32, cuda)
    m = k2.spread_mesh(slots.rows, cfd, geom)
    assert _rel(m, k2.spread_mesh_plain(slots.rows, cfd, geom)) <= TOL
    _, uz = P.pppm_energy_u_zbin(grid, P._spread_rhok_tiled(
        grid, x, q, slots), system.natoms)
    up = P._wrap_pad_xy(uz, geom.hw + geom.dm).contiguous()
    g3 = k3.gather3(up, slots.rows, cfd, geom)
    assert _rel(g3, k3.gather3_plain(up, slots.rows, cfd, geom)) <= TOL
    n0 = k3.launches.count
    a64 = (up.double(), slots.rows.double(), cfd.double(), geom)
    assert torch.equal(k3.gather3(*a64), k3.gather3_plain(*a64))
    assert k3.launches.count == n0
    with pytest.raises(TypeError):
        k3.gather3(up.half(), slots.rows.half(), cfd.half(), geom)


def test_large_engine_launches_kernels(cuda, monkeypatch):
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    system, md, conp, eng, x, q, pppm = _tiled_cell(cuda, x_near)
    for k in (k1, k2, k3):
        k.launches.reset()
    st, _ = eng.run(eng.init_state(x0=x.cpu().numpy()), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert (k1.launches.count, k2.launches.count, k3.launches.count) == (
        4, 4, 4)
    assert np.isfinite(float(st.energy))


def _il_cell(cuda, directory, n=0, **md_kw):
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    system, md, cfg = il_small(workloads, il_small_file(directory), n=n)
    md = dataclasses.replace(md, **md_kw)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=cuda)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
    return system, md, eng


@pytest.mark.parametrize("straddle", [False, True],
                         ids=["interior", "straddles_x"])
def test_shake_kernels_match_plain_on_card(cuda, tmp_path, straddle):
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k
    system, md, eng = _il_cell(cuda, tmp_path)
    rng = np.random.default_rng(5)
    x_old = np.array(system.x0)
    if straddle:    # every cation shifted so its middle site sits at x=0.2
        cats = np.flatnonzero(system.groups["bmi"]).reshape(-1, 3)
        for c in cats:
            x_old[c, 0] = (x_old[c, 0] - x_old[c[1], 0] + 0.2) % system.box[0]
    x_new = x_old + md.dt * (system.v0 + rng.normal(0.0, 0.005,
                                                    x_old.shape))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    kw = dict(box=system.box, periodic=system.periodic)
    x, dv = k.shake_positions(eng.cons, t(x_new), t(x_old), md.dt, **kw)
    px, pdv = k.shake_positions_plain(eng.cons, t(x_new), t(x_old), md.dt,
                                      **kw)
    torch.cuda.synchronize()
    assert _rel(x, px) <= SHAKE_TOL and _rel(dv, pdv) <= SHAKE_TOL
    v = t(system.v0 + rng.normal(0.0, 0.005, x_old.shape))
    vk = k.rattle_velocities(eng.cons, x, v, **kw)
    assert _rel(vk, k.rattle_velocities_plain(eng.cons, x, v, **kw)) <= (
        SHAKE_TOL)
    n0 = k.shake_launches.count
    assert k.shake_positions(eng.cons, t(x_new).double(), t(x_old).double(),
                             md.dt, **kw)[0].dtype == torch.float64
    assert k.shake_launches.count == n0
    with pytest.raises(TypeError):
        k.shake_positions(eng.cons, t(x_new).half(), t(x_old).half(),
                          md.dt, **kw)


def test_pair_kernel_with_exclusions_on_card(cuda, tmp_path):
    """K4 applies the cations' special-bond exclusions per pair, as the
    plain version does (fused and unfused), on the ionic-liquid cell."""
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, eng = _il_cell(cuda, tmp_path)
    assert eng.exclusions is not None
    x = torch.as_tensor(system.x0, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=eng.conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    for cf in (None, fuse):
        got = k4.pair_forces(x, q, eng.type_idx, eng.tables, eng.exclusions,
                             conp_fuse=cf, **kw)
        ref = k4.pair_forces_plain(x, q, eng.type_idx, eng.tables,
                                   eng.exclusions, conp_fuse=cf, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL


def _k78_case(cuda, case, unaligned=False):
    """(cons, x_new, x_old, v, kw) on the card from a ``shake_case``; with
    ``unaligned`` the arrays start 4 bytes into their buffers."""
    from lammps_user_conp2_tpu_torch.models.shake import ShakeConstraints
    cons = ShakeConstraints(*case["tables"], natoms=case["natoms"],
                            dtype=torch.float32, device=cuda)

    def t(a):
        a = torch.as_tensor(a, dtype=torch.float32, device=cuda)
        if not unaligned:
            return a
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        return out

    kw = dict(box=case["box"], periodic=case["periodic"])
    return cons, t(case["x_new"]), t(case["x_old"]), t(case["v"]), kw


def _k78_bits(cons, xn, xo, v, dt, kw):
    """K7 and K8 against their plain versions, bit for bit, and two
    launches bit for bit."""
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k
    x, dv = k.shake_positions(cons, xn, xo, dt, **kw)
    px, pdv = k.shake_positions_plain(cons, xn, xo, dt, **kw)
    vk = k.rattle_velocities(cons, px, v, **kw)
    pv = k.rattle_velocities_plain(cons, px, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(x, px) and torch.equal(dv, pdv)
    assert torch.equal(vk, pv)
    x2, dv2 = k.shake_positions(cons, xn, xo, dt, **kw)
    assert torch.equal(x2, x) and torch.equal(dv2, dv)
    assert torch.equal(k.rattle_velocities(cons, px, v, **kw), vk)


@pytest.mark.parametrize("kind", ["interior", "straddle", "near_tie"])
@pytest.mark.parametrize("shape", list(SHAKE_SHAPES))
def test_k7k8_bit_identical_on_card(cuda, shape, kind):
    """Every LAMMPS cluster shape, the il decks' linear cation (compile-time
    columns) and a mixed, padded table; clusters across the periodic x
    face; a cluster with |d / L| within 1e-6 of 1/2 (the exact rerun);
    dt = 2 fs, the decks'."""
    cons, xn, xo, v, kw = _k78_case(cuda, shake_case(shape, kind, seed=4))
    _k78_bits(cons, xn, xo, v, 2.0, kw)


def test_k7k8_unaligned_rows_on_card(cuda):
    """Arrays that do not start on 16 bytes."""
    cons, xn, xo, v, kw = _k78_case(cuda, shake_case("mixed", "straddle",
                                                     seed=5), unaligned=True)
    assert xn.data_ptr() % 16 != 0
    _k78_bits(cons, xn, xo, v, 2.0, kw)


@pytest.mark.parametrize("cell", ["il", "bonded"])
def test_k7k8_bit_identical_at_cells(cuda, tmp_path, cell):
    """The 3,776-atom il cell (its cations take the compile-time columns)
    and the 8,772-atom bonded cell, from phase 11's inputs of
    chip_smoke.py (a drift step with noise, one cation across x)."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.shake import build_constraints
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k
    extra = {} if cell == "il" else dict(n_pairs=1329, sheets=1, nx=27,
                                         ny=16)
    path = workloads.write_il_data(str(tmp_path / "il.data"), **extra)
    system, md, _ = workloads.il_onelayer(0, data_path=path)
    cons = build_constraints(system, md.shake, dtype=torch.float32,
                             device=cuda)
    assert cons.code == k.LINEAR3_CODE
    rng = np.random.default_rng(11)
    x_old = np.array(system.x0)
    cats = np.flatnonzero(system.groups["bmi"]).reshape(-1, 3)
    dx = x_old[cats[:, 2], 0] - x_old[cats[:, 0], 0]
    dx -= system.box[0] * np.round(dx / system.box[0])
    cat = cats[np.argmax(np.abs(dx))]
    x_old[cat, 0] = (x_old[cat, 0] - x_old[cat[1], 0] + 0.2) % system.box[0]
    v_np = system.v0 + rng.normal(0.0, 0.005, x_old.shape)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    _k78_bits(cons, t(x_old + md.dt * v_np), t(x_old),
              t(v_np + rng.normal(0.0, 0.005, x_old.shape)), md.dt,
              dict(box=system.box, periodic=system.periodic))


def test_k7_dv_at_a_dt_not_a_power_of_two(cuda):
    """dt = 1.7 fs, where neither the IEEE division nor a multiply by
    1.0f / 1.7f rounds as PyTorch's CUDA division by a Python float (a
    multiply by 1 / dt formed in double, rounded to float32): K7's x and
    dv equal the plain version's bit for bit, as does K8."""
    cons, xn, xo, v, kw = _k78_case(cuda, shake_case("mixed", "straddle",
                                                     seed=6))
    _k78_bits(cons, xn, xo, v, 1.7, kw)


def test_k7k8_one_kernel_per_call(cuda):
    """A torch.profiler trace of one shake_positions call and of one
    rattle_velocities call shows one CUDA kernel each (no copy, no fill).
    The profiler can return a trace with no kernel records: such a trace
    is taken again (up to five times); the first trace with records must
    hold exactly one."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k
    cons, xn, xo, v, kw = _k78_case(cuda, shake_case("mixed", "interior"))
    x, _ = k.shake_positions(cons, xn, xo, 2.0, **kw)
    k.rattle_velocities(cons, x, v, **kw)
    torch.cuda.synchronize()
    for call in (lambda: k.shake_positions(cons, xn, xo, 2.0, **kw),
                 lambda: k.rattle_velocities(cons, x, v, **kw)):
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            if names:
                break
        assert len(names) == 1 and "rows_kernel" in names[0], names


def test_il_engine_launches_shake_kernels(cuda, tmp_path):
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k
    system, md, eng = _il_cell(cuda, tmp_path)
    k.shake_launches.reset()
    k.rattle_launches.reset()
    st, _ = eng.run(eng.init_state(), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert (k.shake_launches.count, k.rattle_launches.count) == (3, 3)
    assert np.isfinite(float(st.energy))


def test_block_pair_with_exclusions_on_card(cuda, tmp_path):
    """K1 applies the cations' special-bond exclusions per pair, as the
    plain version does (fused and unfused), on the deck's block path."""
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    system, md, eng = _il_cell(cuda, tmp_path, pair_path="block")
    assert eng.ncfg.block == 8 and eng.exclusions is not None
    x = torch.as_tensor(system.x0, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    nbr, _ = eng.derived_state(x)
    kw = dict(box=eng.ncfg.grid.box, periodic=eng.ncfg.grid.periodic,
              cutoff=md.cutoff, g_ewald=eng.conp.ksp.g_ewald,
              qqr2e=system.units().qqr2e, exclusions=eng.exclusions)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    args = (x, q, eng.type_idx, nbr.bun, nbr.brows, eng.tables)
    for cf in (None, fuse):
        got = k1.block_pair(*args, conp_fuse=cf, **kw)
        ref = k1.block_pair_plain(*args, conp_fuse=cf, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    k1.launches.reset()
    st, _ = eng.run(eng.init_state(), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert k1.launches.count == 4 and np.isfinite(float(st.energy))


@pytest.mark.parametrize("split", ["auto", "whole_union"])
def test_block_pair_pieces_on_card(cuda, tmp_path, monkeypatch, split):
    """K1's packed rows equal their plain version; K1 unfused, fused and
    with exclusions, with its blocks' unions swept whole or in segments,
    against the plain version; two launches bit-identical."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    if split == "whole_union":
        monkeypatch.setattr(k1, "SWEEP_ITEMS_TARGET", 2)
    system, md, conp, eng, x, q, _ = _tiled_cell(cuda, x_close)
    isys, imd, ieng = _il_cell(cuda, tmp_path, pair_path="block")
    ix = torch.as_tensor(isys.x0, dtype=torch.float32, device=cuda)
    iq = torch.as_tensor(charges_with_electrodes(isys), dtype=torch.float32,
                         device=cuda)
    for sy, m, e, xx, qq in ((system, md, eng, x, q),
                             (isys, imd, ieng, ix, iq)):
        fuse = (e.ele_flag, e.elyte_flag, e.eta_tab, e.fo_tab)
        pk = k1.pack_rows(xx, qq, e.type_idx, fuse[:2])
        ref = k1.pack_rows_plain(xx, qq, e.type_idx, fuse[:2])
        assert all(torch.equal(a, b) for a, b in zip(pk, ref))
        nbr, _ = e.derived_state(xx)
        seg, nseg = k1.block_segments(*nbr.bun.shape)
        assert (nseg == 1) == (split == "whole_union")
        kw = dict(box=e.ncfg.grid.box, periodic=e.ncfg.grid.periodic,
                  cutoff=m.cutoff, g_ewald=e.conp.ksp.g_ewald,
                  qqr2e=sy.units().qqr2e, exclusions=e.exclusions)
        args = (xx, qq, e.type_idx, nbr.bun, nbr.brows, e.tables)
        for cf in (None, fuse):
            got = k1.block_pair(*args, conp_fuse=cf, **kw)
            ref = k1.block_pair_plain(*args, conp_fuse=cf, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
            again = k1.block_pair(*args, conp_fuse=cf, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("ntx,nty,heavy", [(1, 1, None), (2, 2, None),
                                           (9, 9, None), (2, 1, 2)])
def test_spread_mesh_bins_on_card(cuda, ntx, nty, heavy):
    """K2a on slot rows of 1, 2 and 9 tiles per axis with empty tiles and
    origins in the drift margin, and on a full tile over two staging
    passes, against its plain version; two launches bit-identical; the
    pass capacity equals ``spread_pass_cap``."""
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.ops.pppm import TileGeom, rho_coeffs
    geom = TileGeom(5, 2, 8, 8, 8, ntx, nty, 2, ntx * nty * 2, 40, False, 1)
    kcap = k2.spread_pass_cap(geom)
    assert build.load_library().conp2_spread_mesh_pass_cap(8, 8, 14) == kcap
    if heavy is not None:
        geom = geom._replace(cap=2 * kcap + 7)
    rows = tile_rows(geom, seed=ntx + 10 * nty, heavy=heavy).to(
        torch.float32).to(cuda)
    cf = torch.as_tensor(rho_coeffs(5), dtype=torch.float32, device=cuda)
    got = k2.spread_mesh(rows, cf, geom)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, k2.spread_mesh_plain(rows, cf, geom)) <= TOL
    assert torch.equal(got, k2.spread_mesh(rows, cf, geom))


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_conp_correction_matches_plain_on_card(cuda, positions):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k6
    system, md, conp, eng, x, q = _cell(cuda, positions)
    args = (x, q, eng.type_idx, conp.ele_idx_t, eng.ele_flag, eng.elyte_flag,
            eng.eta_tab, eng.fo_tab)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              qqr2e=system.units().qqr2e)
    got = k6.conp_correction(*args, **kw)
    ref = k6.conp_correction_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    if positions is x_close:
        assert abs(float(ref[1])) > 1e-3
    n0 = k6.corr_launches.count
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    for g, r in zip(k6.conp_correction(*a64, **kw),
                    k6.conp_correction_plain(*a64, **kw)):
        assert torch.equal(g, r)
    assert k6.corr_launches.count == n0
    with pytest.raises(TypeError):
        k6.conp_correction(*(a.half() if a.is_floating_point() else a
                             for a in args), **kw)


def test_unfused_engine_launches_k6_not_k4(cuda, tmp_path):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, eng = _il_cell(cuda, tmp_path, use_pallas_pair=False)
    for c in (k4.launches, k56.launches, k56.corr_launches):
        c.reset()
    st, _ = eng.run(eng.init_state(), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert (k4.launches.count, k56.launches.count,
            k56.corr_launches.count) == (0, 4, 4)
    assert np.isfinite(float(st.energy))


def test_unfused_engine_correction_near_sheets_on_card(cuda, tmp_path,
                                                       monkeypatch):
    """The engine feeds K6 on the card (the solver's z order, the flags):
    from anions 2 A off the inner sheets its correction energy is nonzero
    and within 1e-3 of the CPU float64 engine's."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models import md as md_mod
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
    seen = {}
    real = md_mod.conp_correction

    def spy(x, *a, **k):
        out = real(x, *a, **k)
        seen[x.device.type] = float(out[1])
        return out

    monkeypatch.setattr(md_mod, "conp_correction", spy)
    system, md, eng = _il_cell(cuda, tmp_path, use_pallas_pair=False)
    cfg = il_small(workloads, il_small_file(tmp_path))[2]
    md64 = dataclasses.replace(md, use_pallas_pair=False)
    eng64 = md_mod.build_engine(
        system, md64, setup_conp(system, md64, cfg, solve_dtype=torch.float64,
                                 device="cpu"),
        dtype=torch.float64, device="cpu")
    x0 = workloads.near_sheet_positions(system, gap=2.0, count=4)
    k56.corr_launches.reset()
    eng.init_state(x0=x0)
    eng64.init_state(x0=x0)
    assert k56.corr_launches.count == 1
    assert abs(seen["cpu"]) > 1e-7
    assert abs(seen["cuda"] - seen["cpu"]) <= 1e-3 * abs(seen["cpu"])


def test_spread_tiles_matches_plain_on_card(cuda, monkeypatch):
    """K2b on the electrode slots of the forced tiled S3 mesh (the grid's
    slot capacity, almost every slot empty) and on all atoms."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    system, md, conp, eng, x, q, pppm = _tiled_cell(cuda, x_near)
    grid = eng.pppm_grid
    cfd = P._coeffs(grid, torch.float32, cuda)
    ne = conp.ne
    for xx, qq in ((x[:ne], q[:ne]), (x, q)):
        geom = P._tile_geometry(grid, xx.shape[0])
        slots = P.tile_slots(grid, xx, qq)
        got = k2.spread_tiles(slots.rows, cfd, geom)
        ref = k2.tile_patches_plain(slots.rows, cfd, geom)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= TOL
    n0 = k2.tiles_launches.count
    assert torch.equal(k2.spread_tiles(slots.rows.double(), cfd.double(),
                                       geom),
                       k2.tile_patches_plain(slots.rows.double(),
                                             cfd.double(), geom))
    assert k2.tiles_launches.count == n0
    with pytest.raises(TypeError):
        k2.spread_tiles(slots.rows.half(), cfd.half(), geom)


def test_mobile_tiled_engine_launches_k2b(cuda, monkeypatch):
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    system, md, cfg = workloads.synthetic(**S3)
    md = dataclasses.replace(md, pair_path="block", pppm_diff="ad",
                             kspace_style=KSpaceStyle.PPPM)
    cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM,
                              mobile_electrodes=True)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=cuda)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
    assert conp.ele_zplanes is None
    k2.tiles_launches.reset()
    st, _ = eng.run(eng.init_state(x0=x_near(system)), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert k2.tiles_launches.count == 4 and np.isfinite(float(st.energy))


@pytest.mark.parametrize("nb,W", [(4, 512), (2, 8192), (32, 2048),
                                  (32, 4096), (8, 8192), (1, 2048),
                                  (3, 1000), (2, 2049), (1, 40)])
@pytest.mark.parametrize("R", [8, 1, 3])
def test_window_gather_matches_plain_on_card(cuda, nb, W, R):
    """K9 bit for bit against its plain version: the probe's three shapes,
    one block, W not a multiple of the 256-row box or of a pass, idx at 0
    and W - 1; one launch per call."""
    from lammps_user_conp2_tpu_torch.exp_vmem_gather import probe_inputs
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
    win, idx = probe_inputs(nb, W, cuda)
    idx[0, :5] = 0
    idx[-1, -5:] = W - 1
    k9.launches.reset()
    got = k9.window_gather(win, idx, R)
    torch.cuda.synchronize()
    assert k9.launches.count == 1
    assert torch.equal(got, k9.window_gather_plain(win, idx, R))
    assert torch.equal(k9.window_gather(win.double(), idx, R),
                       k9.window_gather_plain(win.double(), idx, R))
    assert k9.launches.count == 1
    with pytest.raises(TypeError):
        k9.window_gather(win.half(), idx, R)


def test_window_gather_one_kernel_per_call(cuda):
    """K9 is one CUDA kernel per call, at each of the probe's shapes."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_user_conp2_tpu_torch.exp_vmem_gather import (PROBE_SHAPES,
                                                             probe_inputs)
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
    for nb, W in PROBE_SHAPES:
        win, idx = probe_inputs(nb, W, cuda)
        k9.window_gather(win, idx, 8)
        torch.cuda.synchronize()
        for _ in range(5):          # a trace can come back without records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                k9.window_gather(win, idx, 8)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            if names:
                break
        assert len(names) == 1 and "window_gather" in names[0], names


def test_window_gather_refuses_unaligned_window(cuda):
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
    flat = torch.zeros(2 * 64 * 128 + 1, device=cuda)
    win = flat[1:].view(2, 64, 128)
    idx = torch.zeros((2, 64, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        k9.window_gather(win, idx, 8)


# ---------------------------------------------------------------- graphs
def _steps(eng, st, n):
    for _ in range(n):
        st = eng.step(st)
    return st


def _graph_cell(cuda, cell, tmp_path, monkeypatch):
    """(engine, init_state kwargs) of a cell for the graph tests."""
    if cell == "mid":
        system, md, conp, eng, x, q = _cell(cuda, x_near)
        return eng, dict(x0=x.cpu().numpy())
    if cell in ("mid_cg_nevery2", "mid_mixed"):
        import dataclasses
        from lammps_user_conp2_tpu_torch import workloads
        from lammps_user_conp2_tpu_torch.models.conp import setup_conp
        from lammps_user_conp2_tpu_torch.models.md import build_engine
        from lammps_user_conp2_tpu_torch.utils.config import Solver
        system, md, cfg = workloads.synthetic(**S2)
        sd = torch.float64 if cell == "mid_mixed" else torch.float32
        if cell == "mid_cg_nevery2":
            cfg = dataclasses.replace(cfg, solver=Solver.CG, nevery=2)
        conp = setup_conp(system, md, cfg, solve_dtype=sd, device=cuda)
        eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
        return eng, dict(x0=x_near(system))
    if cell == "tiled":
        from lammps_user_conp2_tpu_torch.ops import pppm as P
        monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
        system, md, conp, eng, x, q, _ = _tiled_cell(cuda, x_near)
        return eng, dict(x0=x.cpu().numpy())
    from lammps_user_conp2_tpu_torch import workloads
    if cell == "dilute":
        from lammps_user_conp2_tpu_torch.models.conp import setup_conp
        from lammps_user_conp2_tpu_torch.models.md import build_engine
        path = workloads.write_dilute_data(tmp_path / "dilute.data")
        system, md, cfg = workloads.dilute(0, data_path=path)
        eng = build_engine(system, md, setup_conp(
            system, md, cfg, solve_dtype=torch.float32, device=cuda),
            dtype=torch.float32, device=cuda)
        return eng, {}
    if cell == "fullmesh":
        import dataclasses
        from lammps_user_conp2_tpu_torch.models.conp import setup_conp
        from lammps_user_conp2_tpu_torch.models.md import build_engine
        from lammps_user_conp2_tpu_torch.ops import pppm as P
        from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
        monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
        system, md, cfg = workloads.synthetic(**S3)
        md = dataclasses.replace(md, pair_path="block", pppm_diff="ad",
                                 kspace_style=KSpaceStyle.PPPM)
        cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM,
                                  mobile_electrodes=True)
        conp = setup_conp(system, md, cfg, solve_dtype=torch.float32,
                          device=cuda)
        eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
        return eng, dict(x0=x_near(system))
    if cell == "bonded":
        system, md, eng = _il_cell(cuda, tmp_path, pair_path="block")
        return eng, {}
    if cell in ("cell", "tile"):
        system, md, conp, eng, x, q, _ = _tiled_cell(
            cuda, x_near, monkeypatch, pair_path=cell)
        return eng, dict(x0=x.cpu().numpy())
    if cell == "il_tile":
        system, md, eng = _il_cell(cuda, tmp_path, pair_path="tile")
        return eng, {}
    if cell == "il4":
        system, md, eng = _il_cell(cuda, tmp_path, n=4)
        return eng, {}
    system, md, eng = _il_cell(cuda, tmp_path,
                               use_pallas_pair=(cell != "unfused"))
    if cell == "unfused":
        return eng, dict(x0=workloads.near_sheet_positions(system, gap=2.0,
                                                           count=4))
    return eng, {}


def _diff(a, b):
    return max(float((u - w).abs().max()) for u, w in
               ((a.x, b.x), (a.v, b.v), (a.q, b.q), (a.energy, b.energy)))


def _same(a, b):
    return all(torch.equal(u, w) for u, w in
               ((a.x, b.x), (a.v, b.v), (a.q, b.q), (a.energy, b.energy)))


@pytest.mark.parametrize("cell", ["mid", "tiled", "il", "bonded", "unfused",
                                  "fullmesh", "mid_cg_nevery2", "mid_mixed",
                                  "cell", "tile", "il_tile", "dilute", "il4"])
def test_graphed_run_matches_eager_on_card(cuda, cell, tmp_path,
                                          monkeypatch):
    """``Engine.run`` replays CUDA graphs: 20 replayed steps equal 20 eager
    steps bit for bit, and two eager runs equal each other, at every cell
    (no step path adds floats with atomics: the bonded forces and the
    list's correction sum in a fixed order), the thermo rows included; the
    cells include S2 under CG solving every second step (the CG blocks and
    the skip variant replayed), S2 with a float64 solve under a float32
    engine, the dilute deck (K10's second half in one launch) and the il
    deck's trial 4 (the dense mesh's stencil kernels)."""
    eng, kw = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    e1 = _steps(eng, st0, 20)
    e2 = _steps(eng, st0, 20)
    g, th = eng.run(st0, 20, thermo_every=10)
    torch.cuda.synchronize()
    assert len(eng._step_graphs) == 1
    assert _same(e1, e2), _diff(e1, e2)
    assert _same(g, e1), _diff(g, e1)
    assert float(th["pe"][-1]) == float(e1.energy)
    assert th["step"].tolist() == [10, 20]
    assert np.isfinite(float(g.energy))


def test_bonded_forces_bit_identical_on_card(cuda, tmp_path):
    """The bonded forces of the il topology sum each atom's terms in a fixed
    order: two calls give the same bits, within float32 rounding of an
    index_add of the same terms."""
    from lammps_user_conp2_tpu_torch.ops import bonded as B
    system, md, eng = _il_cell(cuda, tmp_path)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(system.x0 + 0.05 * rng.standard_normal(
        system.x0.shape), dtype=torch.float32, device=cuda)
    geo = dict(box=tuple(system.box), periodic=tuple(system.periodic))
    args = (eng.bonds, eng.bond_coeffs, eng.angles, eng.angle_coeffs)
    f1, e1 = B.bonded_forces(x, *args, table=eng.bonded_tab, **geo)
    f2, e2 = B.bonded_forces(x, *args, table=eng.bonded_tab, **geo)
    torch.cuda.synchronize()
    assert torch.equal(f1, f2) and torch.equal(e1, e2)
    assert float(f1.abs().max()) > 0.0
    vals, _ = B.bonded_terms(x, *args, **geo)
    ref = torch.zeros_like(x).index_add(0, B.term_rows(eng.bonds, eng.angles),
                                        vals)
    assert _rel(f1, ref) <= 1e-6


def test_launch_counters_under_replay_on_card(cuda, tmp_path):
    """The counters read after replayed steps what they read after eager
    ones: the captures count nothing, every replay counts its launches."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    system, md, eng = _il_cell(cuda, tmp_path)
    counters = (k4.launches, k5.launches, k78.shake_launches,
                k78.rattle_launches)
    for c in counters:
        c.reset()
    st = eng.init_state()
    st, _ = eng.run(st, 3, thermo_every=0)            # captures, replays 3
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [4, 4, 3, 3]
    st, _ = eng.run(st, 5, thermo_every=1)
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [9, 9, 8, 8]


@pytest.mark.parametrize("cell", ["mid", "tiled", "cell", "tile"])
def test_graphed_run_host_syncs_on_card(cuda, cell, tmp_path, monkeypatch):
    """No host sync per replayed step on the dense and cell paths, one (the
    skin flag, or the mesh tiles' drift flag) on the list and tile paths,
    beside the end-of-run finiteness check."""
    import warnings
    eng, kw = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    eng.run(st0, 2, thermo_every=0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(st0, 10, thermo_every=5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) <= (10 if eng.split_step else 0) + 1, syncs


def test_recapture_after_capacity_growth_on_card(cuda, monkeypatch):
    """A grown list capacity keys new graphs, captured on the next run,
    which equals the eager steps at the new capacity."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    monkeypatch.setattr(P, "_use_dense", lambda grid, n: False)
    system, md, conp, eng, x, q, _ = _tiled_cell(cuda, x_near)
    st0 = eng.init_state(x0=x.cpu().numpy())
    eng.run(st0, 3, thermo_every=0)
    k0 = eng.ncfg.k_max
    eng._grow_neighbor_capacity()
    st1 = eng._heal_state(st0)
    assert st1.nbr.idx.shape[1] == 2 * k0
    g, _ = eng.run(st1, 5, thermo_every=0)
    e1, e2 = _steps(eng, st1, 5), _steps(eng, st1, 5)
    torch.cuda.synchronize()
    assert len(eng._step_graphs) == 2
    assert _same(g, e1) if _same(e1, e2) else _diff(g, e1) <= 1e-3


@pytest.mark.parametrize("gap", [1.0, 1.2])
def test_k6_near_sheets_matches_plain_on_card(cuda, tmp_path, gap):
    """K6 over the correction's range (r_corr) against its plain version
    over the full cutoff, anions ``gap`` A off the inner sheets: 2e-5, two
    launches bit-identical; its two z orders equal their plain version."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k6
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
    system, md, eng = _il_cell(cuda, tmp_path, use_pallas_pair=False)
    assert eng.r_corr < md.cutoff
    x = torch.as_tensor(workloads.near_sheet_positions(system, gap=gap,
                                                       count=4),
                        dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    zsort = z_perm(x, system.box, system.periodic)
    args = (x, q, eng.type_idx, eng.conp.ele_idx_t, eng.ele_flag,
            eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              qqr2e=system.units().qqr2e)
    got = k6.conp_correction(*args, zsort=zsort, r_corr=eng.r_corr,
                             gtab=eng.corr_gtab, **kw)
    again = k6.conp_correction(*args, zsort=zsort, r_corr=eng.r_corr,
                               gtab=eng.corr_gtab, **kw)
    ref = k6.conp_correction_plain(*args, **kw)
    torch.cuda.synchronize()
    assert abs(float(ref[1])) > 1e-3
    for g, a, r in zip(got, again, ref):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
        assert torch.equal(g, a)
    orders = k6.corr_orders(*zsort, eng.elyte_flag, eng.ele_flag)
    plain = k6.corr_orders(zsort[0].cpu(), zsort[1].cpu(),
                           eng.elyte_flag.cpu(), eng.ele_flag.cpu())
    for (i, z), (pi, pz) in zip(orders, plain):
        assert torch.equal(i.cpu().long(), pi) and torch.equal(z.cpu(), pz)


# card float64 against CPU float64, 3 steps, relative to the largest |q|
# and to |pe|: the figure ROADMAP names for the float64 engine
F64_CARD_REL = 1e-10


def _f64_cell(cell, tmp_path):
    """(system, md, cfg, x0) of chip_smoke.py's mid-size, il and 100k
    cells."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell
    if cell == "il":
        path = workloads.write_il_data(tmp_path / "il.data")
        return (*workloads.il_onelayer(0, data_path=path), None)
    if cell == "mid":
        system, md, cfg = workloads.synthetic(n_elyte=6144, nele_side=24,
                                              lz=60.0, lxy=50.0)
    else:
        system, md, cfg = large_cell()
    return system, md, cfg, workloads.near_wall_positions(system)


@pytest.mark.parametrize("cell", ["mid", "il", "100k"])
def test_float64_engine_on_card(cuda, cell, tmp_path):
    """``build_engine(..., dtype=torch.float64)`` on the card: 3 steps of
    ``Engine.run`` (replayed as CUDA graphs) hold the CPU float64 run's
    charges and pe to F64_CARD_REL, and no hand kernel launches."""
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    system, md, cfg, x0 = _f64_cell(cell, tmp_path)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eng = build_engine(system, md, setup_conp(
            system, md, cfg, solve_dtype=torch.float64, device=dev),
            dtype=torch.float64, device=dev)
        for c in build.COUNTERS:
            c.reset()
        st, _ = eng.run(eng.init_state(x0=x0), 3, thermo_every=0)
        assert all(c.count == 0 for c in build.COUNTERS)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert len(eng._step_graphs) == 1
            assert (eng.ncfg is None) == (cell != "100k")
            assert eng.ncfg is None or eng.ncfg.block == 0
        out[dev.type] = st
    g, c = out["cuda"], out["cpu"]
    dq = float((g.q.cpu() - c.q).abs().max()) / float(c.q.abs().max())
    dpe = abs(float(g.energy) - float(c.energy)) / abs(float(c.energy))
    assert dq <= F64_CARD_REL and dpe <= F64_CARD_REL, (dq, dpe)


def test_kernel_build_failure_raises_on_card(cuda, monkeypatch):
    """A float32 call whose kernel library cannot be built raises; it does
    not fall back to the plain version.  A float64 call never builds."""
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
    win = torch.rand((2, 64, 128), device=cuda)
    idx = torch.randint(0, 64, (2, 64, 128), dtype=torch.int32,
                        device=cuda)

    def refuse():
        raise RuntimeError("nvcc failed: refused by the test")

    monkeypatch.setattr(build, "load_library", refuse)
    with pytest.raises(RuntimeError, match="refused by the test"):
        k9.window_gather(win, idx, 2)
    assert torch.equal(k9.window_gather(win.double(), idx, 2),
                       k9.window_gather_plain(win.double(), idx, 2))


def test_cg_block_matches_while_loop_on_card(cuda):
    """The blocked CG (``CG_BLOCK`` iterations per host read, the finished
    iterations masked on the device) equals a loop that reads the flag on
    the host after every iteration, as the JAX ``lax.while_loop`` tests it:
    the same iteration count and the iterate bit for bit, float32, S2 under
    CG_MATFREE from a cold start and from a warm start."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models import conp as C
    from lammps_user_conp2_tpu_torch.utils.config import Solver
    system, md, cfg = workloads.synthetic(**S2)
    cfg = dataclasses.replace(cfg, solver=Solver.CG_MATFREE)
    conp = C.setup_conp(system, md, cfg, solve_dtype=torch.float32,
                        device=cuda)
    x = torch.as_tensor(x_near(system), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    tol, maxiter = cfg.cg_tolerance, cfg.cg_maxiter
    for warm in (False, True):
        pend = conp.solve_begin(x, q, step=torch.ones((), dtype=torch.int64,
                                                      device=cuda))
        op = conp.operator(pend)
        x0 = pend.cg.x if warm else None
        cg = C.cg_start(op, pend.b, tol, maxiter, x0)
        ref = C.cg_start(op, pend.b, tol, maxiter, x0)
        while bool(cg.active):
            cg = C.cg_block(op, cg, tol, maxiter)
        while bool(ref.active):
            ref = C.cg_block(op, ref, tol, maxiter, nblock=1)
        torch.cuda.synchronize()
        assert int(cg.it) == int(ref.it) > 0
        assert torch.equal(cg.x, ref.x)


# ------------------------------------------- the user's surface (phases 35-38)
def test_scrambled_electrodes_on_card(cuda):
    """Phase 35 at the test size: S2 with its electrode rows spread through
    the atoms runs K4 (fused correction) and K5 every step, the graphed
    run equals the eager one bit for bit, and 3 steps map by tag onto the
    electrodes-first run within phase 5's bounds."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, cfg = workloads.synthetic(**S2)
    perm = np.random.default_rng(7).permutation(system.natoms)
    scr = reorder_atoms(system, perm)
    f32 = dict(device=cuda)
    engs = [build_engine(s, md, setup_conp(s, md, cfg, solve_dtype=torch.float32,
                                           **f32), dtype=torch.float32, **f32)
            for s in (system, scr)]
    assert engs[0].conp.ele_contig and not engs[1].conp.ele_contig
    x0 = x_near(system)
    st = engs[1].init_state(x0=x0[perm])
    n4, n5 = k4.launches.count, k5.launches.count
    g, _ = engs[1].run(st, 10, thermo_every=0)
    torch.cuda.synchronize()
    assert k4.launches.count - n4 >= 10 and k5.launches.count - n5 >= 10
    assert _same(g, _steps(engs[1], st, 10))
    a, b = engs[0].init_state(x0=x0), st
    for _ in range(3):
        a, b = engs[0].step(a), engs[1].step(b)
    dq = float((a.q[perm] - b.q).abs().max())
    assert dq <= 1e-4 * float(a.q.abs().max()) + 1e-6
    assert abs(float(a.energy - b.energy)) <= 1e-4 * abs(float(a.energy))
    assert _rel(b.f, a.f[perm]) <= 1e-3


def test_cli_run_matches_engine_run_on_card(cuda, tmp_path, monkeypatch):
    """Phase 36 at the test size: ``cli.main(["run", ..., "--f32"])`` on the
    352-atom file prints the thermo rows of an ``Engine.run`` of the same
    deck, as printed."""
    from lammps_user_conp2_tpu_torch import cli
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.utils.lammps_log import \
        parse_thermo_blocks
    import os
    os.makedirs(tmp_path / "il_onelayer")
    from lammps_user_conp2_tpu_torch.workloads import write_il_data
    from torch_cells import IL_SMALL
    write_il_data(str(tmp_path / "il_onelayer" / "data"), **IL_SMALL)
    monkeypatch.setenv("CONP_REF_TESTS", str(tmp_path))
    log = str(tmp_path / "log")
    assert cli.main(["run", "il_onelayer", "0", "--f32", "--steps", "20",
                     "--thermo", "5", "--log", log, "--no-timing"]) == 0
    system, md, cfg = cli.load_deck("il_onelayer", 0)
    eng = build_engine(system, md, setup_conp(system, md, cfg,
                                              solve_dtype=torch.float32,
                                              device=cuda),
                       dtype=torch.float32, device=cuda)
    st0 = eng.init_state()
    _, th = eng.run(st0, 20, thermo_every=5)
    rows = [cli.thermo_line(eng.thermo(st0))] + [
        cli.thermo_line(r) for r in cli.thermo_rows(th)]
    lines = open(log).read().splitlines()
    assert lines[1:6] == rows
    assert len(parse_thermo_blocks(log)[0]["Step"]) == 5


@pytest.mark.parametrize("cell", ["il", "mid_cg_nevery2"])
def test_checkpoint_resume_bit_identical_on_card(cuda, cell, tmp_path,
                                                monkeypatch):
    """Phase 38 at the test size: 10 graphed steps, a checkpoint, a fresh
    engine, the file loaded and 10 more graphed steps equal 20 graphed
    steps bit for bit (the warm start and nevery's step counter carried)."""
    from lammps_user_conp2_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    eng, kw = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    full, th_full = eng.run(st0, 20, thermo_every=5)
    half, _ = eng.run(st0, 10, thermo_every=5)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, eng, half)
    fresh, _ = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    end, th_end = fresh.run(load_checkpoint(path, fresh), 10, thermo_every=5)
    torch.cuda.synchronize()
    assert _same(end, full), _diff(end, full)
    assert torch.equal(end.step_t, full.step_t)
    for k in th_full:
        assert torch.equal(torch.as_tensor(th_end[k]).cpu(),
                           torch.as_tensor(th_full[k])[2:].cpu()), k


@pytest.mark.parametrize("cell", ["mid", "il"])
def test_sharded_d1_nccl_matches_engine_on_card(cuda, cell, tmp_path):
    """The sharded step at d = 1 over a one-rank NCCL group (a FileStore
    in tmp_path), float32: 3 steps against ``Engine.step`` on the card
    (charges 1e-4 of max|q_ele|, pe 1e-4 and forces 1e-3 relative, phase
    5's bounds of chip_smoke.py), two sharded runs bit for bit, and K7
    and K8 every step at the il cell, with K5 and K6 on its dense path."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel
    from lammps_user_conp2_tpu_torch.parallel import comm as C
    from lammps_user_conp2_tpu_torch.parallel.sharded import (
        build_sharded_engine)
    if cell == "mid":
        system, md, cfg = workloads.synthetic(6144, 24, lz=60.0, lxy=50.0)
        x0 = workloads.near_wall_positions(system)
    else:
        path = workloads.write_il_data(str(tmp_path / "il.data"))
        system, md, cfg = workloads.il_onelayer(0, data_path=path)
        x0 = None
    eng = build_engine(system, md, setup_conp(
        system, md, cfg, solve_dtype=torch.float32, device=cuda),
        dtype=torch.float32, device=cuda)
    ne = eng.conp.ne
    comm = C.init_group(cuda, 0, 1, str(tmp_path / "store"))
    try:
        sheng = build_sharded_engine(eng, comm, x0=x0)
        st0 = eng.init_state(x0=x0)
        counters = (shake_kernel.shake_launches, shake_kernel.rattle_launches)
        dense = (k56.launches, k56.corr_launches)
        for c in counters + dense:
            c.reset()
        runs = []
        for _ in range(2):
            st, out = st0, []
            for _ in range(3):
                st = sheng.step(st)
                out.append(st)
            runs.append(out)
        torch.cuda.synchronize()
    finally:
        C.close_group()
    assert all(_same(a, b) for a, b in zip(*runs))
    if cell == "il":
        assert all(c.count == 6 for c in counters)
        assert all(c.count >= 6 for c in dense)
    st = st0
    for s_sh in runs[0]:
        st = eng.step(st)
        dq = float((s_sh.q[:ne] - st.q[:ne]).abs().max())
        assert dq <= 1e-4 * float(st.q[:ne].abs().max()) + 1e-6
        assert abs(float(s_sh.energy) - float(st.energy)) <= 1e-4 * abs(
            float(st.energy))
        assert float((s_sh.f - st.f).abs().max()) <= 1e-3 * float(
            st.f.abs().max())


@pytest.mark.parametrize("cell", ["tiled", "il", "dilute"])
def test_sharded_graphed_run_matches_eager_on_card(cuda, cell, tmp_path,
                                                  monkeypatch):
    """``ShardedEngine.run`` at d = 1 over a one-rank NCCL group replays
    CUDA graphs (the collectives captured): 10 replayed steps equal 10
    eager sharded steps bit for bit, the thermo rows included, and a second
    replayed run the first (S3 on the block list and the tiled mesh with
    the rank's tile assignment, the test-size il cell, the dilute deck)."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.parallel import comm as C
    from lammps_user_conp2_tpu_torch.parallel.sharded import (
        build_sharded_engine)
    x0 = None
    if cell == "tiled":
        system, md, conp, eng, x, q, _ = _tiled_cell(cuda, x_near,
                                                     monkeypatch)
        x0 = x.cpu().numpy()
    elif cell == "il":
        system, md, eng = _il_cell(cuda, tmp_path)
    else:
        path = workloads.write_dilute_data(tmp_path / "dilute.data")
        system, md, cfg = workloads.dilute(0, data_path=path)
        eng = build_engine(system, md, setup_conp(
            system, md, cfg, solve_dtype=torch.float32, device=cuda),
            dtype=torch.float32, device=cuda)
    comm = C.init_group(cuda, 0, 1, str(tmp_path / "store"))
    try:
        sheng = build_sharded_engine(eng, comm, x0=x0)
        st0 = eng.init_state(x0=x0)
        e1 = _steps(sheng, st0, 10)
        g1, th = sheng.run(st0, 10, thermo_every=5)
        g2, _ = sheng.run(st0, 10, thermo_every=0)
        torch.cuda.synchronize()
        captured = len(sheng._step_graphs)
    finally:
        C.close_group()
    assert captured == 1
    assert _same(g1, e1), _diff(g1, e1)
    assert _same(g2, g1), _diff(g2, g1)
    assert float(th["pe"][-1]) == float(e1.energy)
    assert th["step"].tolist() == [5, 10]
    if cell == "tiled":
        assert type(g1.tasg).__name__ == "RankTileAssign"


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_tile_items_kernel_matches_plain_on_card(cuda, positions,
                                                 monkeypatch):
    """K4's item-list entry (the tile path: kd bricks, the fused
    correction) against its plain version (2e-5), two launches
    bit-identical, the side buffer sized by the cap; NaN at half the live
    count."""
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q, _ = _tiled_cell(cuda, positions,
                                                 monkeypatch, "tile")
    assert eng.pair_order == "kd" and eng.pair_cap is not None
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    perm, _ = k4.order_atoms(x, system.box, system.periodic, "kd")
    items = k4.tile_items(x, perm, pair_cap=eng.pair_cap, conp_fuse=fuse,
                          box=system.box, periodic=system.periodic,
                          cutoff=md.cutoff)
    args = (x, q, eng.type_idx, eng.tables, None)
    k4.launches.reset()
    got = k4.pair_forces(*args, order="kd", pair_cap=eng.pair_cap,
                         conp_fuse=fuse, ele_idx=conp.ele_idx_t, **kw)
    again = k4.pair_forces(*args, order="kd", pair_cap=eng.pair_cap,
                           conp_fuse=fuse, ele_idx=conp.ele_idx_t, **kw)
    ref = k4.pair_items_plain(*args, perm, items, conp_fuse=fuse,
                              ele_idx=conp.ele_idx_t, **kw)
    torch.cuda.synchronize()
    assert k4.launches.count == 2
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, r) <= TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    cnt = int(items.count[0])
    short = k4.pair_forces(*args, order="kd", pair_cap=cnt // 2,
                           conp_fuse=fuse, ele_idx=conp.ele_idx_t, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isnan(t).all()) for t in short)


def test_tile_items_kernel_with_exclusions_on_card(cuda, tmp_path):
    """The item-list entry with the il cations' special bonds, per pair,
    against its plain version (2e-5)."""
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, eng = _il_cell(cuda, tmp_path, pair_path="tile")
    x = torch.as_tensor(system.x0, dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=eng.ksp_force.g_ewald, qqr2e=system.units().qqr2e)
    perm, _ = k4.order_atoms(x, system.box, system.periodic, "kd")
    items = k4.tile_items(x, perm, pair_cap=eng.pair_cap, conp_fuse=fuse,
                          box=system.box, periodic=system.periodic,
                          cutoff=md.cutoff)
    args = (x, q, eng.type_idx, eng.tables, eng.exclusions)
    got = k4.pair_forces(*args, order="kd", pair_cap=eng.pair_cap,
                         conp_fuse=fuse, ele_idx=eng.conp.ele_idx_t, **kw)
    ref = k4.pair_items_plain(*args, perm, items, conp_fuse=fuse,
                              ele_idx=eng.conp.ele_idx_t, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("path", ["cell", "tile"])
def test_run_recovers_from_short_cap_on_card(cuda, monkeypatch, path):
    """A cell cap or a pair cap at half its need: ``run`` grows it,
    recaptures and ends finite, equal to the eager steps at the grown
    cap."""
    import dataclasses
    system, md, conp, eng, x, q, _ = _tiled_cell(cuda, x_near, monkeypatch,
                                                 path)
    st0 = eng.init_state(x0=x.cpu().numpy())
    if path == "cell":
        eng.cell_grid = dataclasses.replace(eng.cell_grid,
                                            cap=eng.cell_grid.cap // 4)
    else:
        eng.pair_cap = eng.pair_cap // 3
    g, _ = eng.run(st0, 5, thermo_every=0)
    torch.cuda.synchronize()
    assert np.isfinite(float(g.energy))
    e1 = _steps(eng, eng._heal_state(st0), 5)
    assert _same(g, e1), _diff(g, e1)


def test_marked_graph_equals_unmarked_on_card(cuda, tmp_path, monkeypatch):
    """The il graphs captured under ``timers.tracing`` (timing events at
    the layer boundaries) are another set of graphs, keyed by the flag,
    and step the same bits as the unmarked graphs; the marks of a step
    give each layer a device time, none negative, the five layers and the
    step's self time adding up to the step's device time."""
    from lammps_user_conp2_tpu_torch.models import graphs
    from lammps_user_conp2_tpu_torch.utils import timers
    eng, kw = _graph_cell(cuda, "il", tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    off, th_off = eng.run(st0, 20, thermo_every=10)
    with timers.tracing():
        on, th_on = eng.run(st0, 20, thermo_every=10)
    torch.cuda.synchronize()
    assert len(eng._step_graphs) == 2
    assert _same(on, off), _diff(on, off)
    assert torch.equal(th_on["pe"], th_off["pe"])
    unmarked = [sg for k, sg in eng._step_graphs.items() if not k[-1]]
    assert unmarked[0].marks == {}
    with timers.tracing():
        st, _ = eng.run(st0, 1, thermo_every=0)
    torch.cuda.synchronize()
    sg = eng._step_graphs[graphs.graph_key(eng, st0)[:-1] + (True,)]
    m = sg.mark_ms()
    assert {"step", "integrate.pre", "solve", "forces", "forces.pair",
            "forces.kspace", "integrate.post"} <= set(m)
    lay = timers._layers(m)
    five = ("integrate", "solve", "pair", "kspace", "forces_other")
    assert all(lay[k] > 0.0 for k in five), lay
    assert lay["step_self"] >= 0.0, lay
    assert sum(lay[k] for k in five) + lay["step_self"] == pytest.approx(
        lay["step"], rel=0.01)
    timers.reset()


@pytest.mark.parametrize("cell", ["tiled", "mid_cg_nevery2"])
def test_traced_split_graphs_on_card(cuda, cell, tmp_path, monkeypatch):
    """A list-path cell and a CG cell capture and replay under
    ``timers.tracing``, equal to the unmarked graphs bit for bit; the list
    path counts one flag read per step."""
    from lammps_user_conp2_tpu_torch.utils import timers
    eng, kw = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    off, _ = eng.run(st0, 6, thermo_every=0)
    timers.reset()
    with timers.tracing():
        on, _ = eng.run(st0, 6, thermo_every=0)
    torch.cuda.synchronize()
    assert _same(on, off), _diff(on, off)
    c = timers.counters()
    if eng.split_step:
        assert c["host_read.rebuild_flag"] == 6
    else:
        assert c["host_read.cg_flag"] >= 3
    timers.reset()


K10_STAGES = [("nhc", "kick", "drift"), ("kick", "nhc"), ("kick",), ("nhc",)]


def _k10_check(itg, args, stages):
    """K10 on ``args`` against the plain version on the card in float32
    and in float64 (the float64 integrator on the same float32 masses; the
    thermostats of ("kick", "nhc") read the float32 kick, which K10 forms
    as the plain version does).  Returns K10's launches in the call."""
    from lammps_user_conp2_tpu_torch.models.integrate import Integrator
    from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
    n0 = ik.launches.count
    got = ik.integrate_half(itg, *args, stages)
    torch.cuda.synchronize()
    n_launch = ik.launches.count - n0
    again = ik.integrate_half(itg, *args, stages)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    p32 = ik.integrate_half_plain(itg, *args, stages)
    itg64 = Integrator(dt=itg.dt, units=itg.units, mass=itg.mass.double(),
                       mobile_mask=itg.mobile_mask,
                       thermostats=list(itg.thermostats))
    a64 = [a.double() for a in args]
    if stages == ("kick", "nhc"):
        a64[0] = itg.kick(args[0], args[1]).double()
        p64 = ik.integrate_half_plain(itg64, *a64, ("nhc",))
    else:
        p64 = ik.integrate_half_plain(itg64, *a64, stages)
    if stages == ("kick",):
        assert torch.equal(got[0], p32[0])
    if "nhc" in stages:
        for k, p in zip(got[2:], p64[2:]):
            assert bool(((k.double() - p).abs() <= p.abs() * 2.0 ** -23).all())
        assert not torch.equal(got[3], args[4])
    for k, p, p3 in zip(got[:2], p64[:2], p32[:2]):
        assert _rel(k.double(), p) <= 1e-6
        assert _rel(k, p3) <= max(TOL, 2.0 * _rel(p3.double(), p))
    return n_launch


@pytest.mark.parametrize("stages", K10_STAGES, ids="-".join)
@pytest.mark.parametrize("nthermo", [1, 2])
@pytest.mark.parametrize("n", [432, 3776, 100000])
def test_integrate_half_matches_plain_on_card(cuda, n, nthermo, stages):
    """K10 against its plain version: one launch (two in the split form
    above ``ONE_CTA_MAX_ROWS`` rows with a thermostat half), the groups
    overlapping at 3,776 rows with 2 thermostats."""
    from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
    itg, *args = integrator_case(n, torch.float32, cuda, nthermo,
                                 overlap=(n == 3776 and nthermo == 2))
    split = "nhc" in stages and n > ik.ONE_CTA_MAX_ROWS
    assert _k10_check(itg, args, stages) == 1 + split


@pytest.mark.parametrize("stages", K10_STAGES, ids="-".join)
def test_integrate_half_split_form_on_card(cuda, stages, monkeypatch):
    """K10's two-launch form at the decks' size, 2 overlapping thermostats
    (ONE_CTA_MAX_ROWS patched to 0): the same bounds."""
    from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
    monkeypatch.setattr(ik, "ONE_CTA_MAX_ROWS", 0)
    itg, *args = integrator_case(3776, torch.float32, cuda, 2, overlap=True)
    assert _k10_check(itg, args, stages) == 1 + ("nhc" in stages)


@pytest.mark.parametrize("cell,per_step,kernels", [("dilute", 2, 2),
                                                   ("il", 3, 6)])
def test_integrate_layer_launches_on_card(cuda, cell, per_step, kernels,
                                          tmp_path, monkeypatch):
    """The integrator's part of a step: K10 launches ``per_step`` times per
    graphed step (both halves at the dilute deck; at the il cell the first
    half, and the second half's kick and thermostat half around K8), and
    the eager layer (``_half_pre`` and ``_half_post``) is ``kernels`` CUDA
    kernels (the il cell's: K10 3 times, K7, K8 and the v + dv add)."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
    eng, kw = _graph_cell(cuda, cell, tmp_path, monkeypatch)
    st0 = eng.init_state(**kw)
    ik.launches.reset()
    st, _ = eng.run(st0, 5, thermo_every=0)
    torch.cuda.synchronize()
    assert ik.launches.count == 5 * per_step

    def layer():
        x, v, xi, vxi = eng._half_pre(st)
        return eng._half_post(x, v, st.f, xi, vxi)

    layer()
    torch.cuda.synchronize()
    for _ in range(5):         # the profiler can lose a trace's records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            layer()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if names:
            break
    assert len(names) == kernels, names


# ------------------------------------------------- the dense mesh's stencils
MESH_SITES = ["spread", "spread_zplanes", "gather", "gather3",
              "gather_zplanes", "gather3_ad"]


@pytest.fixture(scope="module")
def mesh_cases(tmp_path_factory):
    """Per mesh, (grid, x, q with zero electrode rows, xe, qe, zp_inv,
    three fields, the potential on the planes), float32 on the card:
    il_onelayer trial 4 on the 3,776-atom file (mesh 30 x 32 x 80, Ne
    2,496, the deck's plane set) at its start with random electrode
    charges; and a coarse mesh (3 x 4 x 16, order 5) with 300 atoms in and
    a little outside its box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(24)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    out = {}
    path = workloads.write_il_data(str(tmp_path_factory.mktemp("il4")
                                       / "il.data"))
    system, md, cfg = workloads.il_onelayer(4, data_path=path)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    grid = conp.pppm_grid
    assert grid.shape == (30, 32, 80) and conp.ne == 2496
    q = system.q0.copy()
    q[system.ele_mask] = 0.0
    xe = system.x0[system.ele_mask]
    qe = 0.05 * rng.standard_normal(len(xe))
    cases = {"il4": (grid, system.x0, q, xe, qe, conp.ele_zpinv)}
    box = (6.0, 7.0, 30.0)
    cgrid = P.setup_pppm(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                         natoms=300, q2=1.0, cutoff=5.0, g_ewald=0.3,
                         grid=(3, 4, 16))
    x = rng.uniform(-0.05, 1.05, size=(300, 3)) * np.asarray(box)
    cq = rng.normal(size=300)
    cq[::3] = 0.0
    cxe = rng.uniform(0, 1, size=(60, 3)) * np.asarray(box)
    cxe[:, 2] = np.where(np.arange(60) % 2 == 0, 3.0, 27.0)
    cases["coarse"] = (cgrid, x, cq, cxe, rng.normal(size=60),
                       P.zplane_inverse(cgrid, P.electrode_zplanes(cgrid,
                                                                   cxe)))
    for name, (g, x, q, xe, qe, zpi) in cases.items():
        npl = int((zpi >= 0).sum())
        out[name] = (g, t(x), t(q), t(xe), t(qe), zpi,
                     [t(rng.normal(size=g.shape)) for _ in range(3)],
                     t(rng.normal(size=(g.nx, g.ny, npl))))
    return out


def _mesh_calls(case):
    """site -> (the routed call, its dense plain version, its counter)."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import mesh_stencil as ms
    g, x, q, xe, qe, zpi, f3, up = case
    sp, ga = ms.spread_launches, ms.gather_launches
    return {
        "spread": (lambda: P.spread(g, x, q),
                   lambda: P._spread_dense(g, x, q), sp),
        "spread_zplanes": (lambda: P.spread_zplanes(g, xe, qe, zpi),
                           lambda: P._spread_zplanes_dense(g, xe, qe, zpi),
                           sp),
        "gather": (lambda: P.gather(g, f3[0], x),
                   lambda: P._gather_dense(g, f3[0], x), ga),
        "gather3": (lambda: P.gather3(g, f3, x, scale=q),
                    lambda: q[:, None] * P._gather3_dense(g, f3, x), ga),
        "gather_zplanes": (lambda: P.gather_zplanes(g, up, xe, zpi,
                                                    scale=-1.0),
                           lambda: -P._gather_zplanes_dense(g, up, xe, zpi),
                           ga),
        "gather3_ad": (lambda: P.gather3_ad(g, f3[0], x),
                       lambda: P._gather3_ad_dense(g, f3[0], x), ga),
    }


@pytest.mark.parametrize("site", MESH_SITES)
@pytest.mark.parametrize("mesh", ["il4", "coarse"])
def test_mesh_stencil_matches_plain_on_card(cuda, mesh_cases, mesh, site):
    """Each dense-mesh function on the card launches its stencil kernel
    once per call, within TOL of its dense plain version in float32 (the
    sums differ in order only), two launches bit-identical, no
    (N, nx*ny) weight matrix formed (``_wxy`` not called)."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    call, plain, counter = _mesh_calls(mesh_cases[mesh])[site]
    ref = plain()
    n0 = counter.count
    wxy = P._wxy
    try:
        P._wxy = None
        got, again = call(), call()
    finally:
        P._wxy = wxy
    torch.cuda.synchronize()
    assert counter.count == n0 + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("mesh", ["il4", "coarse"])
def test_mesh_stencil_off_planes_nan_on_card(cuda, mesh_cases, mesh):
    """A stencil node off the plane set makes the kernels' whole output
    NaN, as the dense versions' (decided on the card: no host read)."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    g, x, q, xe, qe, zpi, f3, up = mesh_cases[mesh]
    far = xe.clone()
    far[0, 2] = 0.5 * g.zprd_grid
    P.gather_zplanes(g, up, xe, zpi)     # the slot tables on the card
    P.spread_zplanes(g, xe, qe, zpi)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rho = P.spread_zplanes(g, far, qe, zpi)
        b = P.gather_zplanes(g, up, far, zpi, scale=-1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isnan(rho).all()) and bool(torch.isnan(b).all())
    assert bool(torch.isnan(P._spread_zplanes_dense(g, far, qe, zpi)).all())


@pytest.mark.parametrize("trial,per_step", [(4, 2), (0, 0)])
def test_mesh_kernels_in_graphed_step_on_card(cuda, tmp_path, monkeypatch,
                                              trial, per_step):
    """il_onelayer trial 4 (PPPM on a dense mesh, electrodes on z planes)
    spreads twice and reads twice per graphed step through the stencil
    kernels (the electrolyte and the electrodes; b and the ik forces), and
    forms no dense weight matrix; trial 0 (the factored Ewald sum) never
    launches them."""
    from lammps_user_conp2_tpu_torch.ops import pppm as P
    from lammps_user_conp2_tpu_torch.ops.kernels import mesh_stencil as ms

    def dense(*args):
        raise AssertionError("a dense weight matrix on the card")

    system, md, eng = _il_cell(cuda, tmp_path, n=trial)
    monkeypatch.setattr(P, "_weight_matrix", dense)
    monkeypatch.setattr(P, "_wxy", dense)
    st = eng.init_state()
    ms.spread_launches.reset()
    ms.gather_launches.reset()
    st, _ = eng.run(st, 5, thermo_every=0)
    torch.cuda.synchronize()
    assert ms.spread_launches.count == 5 * per_step
    assert ms.gather_launches.count == 5 * per_step
    assert np.isfinite(float(st.energy))
