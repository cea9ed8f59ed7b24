"""The pieces of the block pair sweep (K1) and the z-binned PPPM spread
(K2a) as their kernels order the work, held in float64 on the CPU against
the plain versions of the whole functions.

K1: the packed 32-byte row per atom holds x, q, the type and the sign of
ele_f - ely_f; the work split (``block_segments``) covers every union
chunk at K1's shapes; the test-then-compact pair queue
(``pair_queue_plain``), over the block lists ``ops/neighbors.py`` builds,
holds exactly the in-range (block atom, union member) pairs, each once, in
the kernel's order (chunk, lane, block atom); and the sweep evaluated over
that queue and summed as the kernel sums it (``block_pair_queue_plain``)
equals ``block_pair_plain`` to 1e-12: S3 from ions near the walls and 3 A
from them (where the fused correction is large), and the ionic-liquid
test cell's block path with its special-bond exclusions; one and several
union segments per block.

K2a: the origin bins (``spread_bins_plain``) hold every kept atom once
(charged, before its source's count, footprint reaching the tile), sorted
stably by origin cell, and walked as the kernel walks them, a run of
origin cells per accumulator row (``spread_from_bins_plain``), give
``spread_mesh_plain`` to 1e-12: 1, 2 and 9 tiles per axis, empty tiles,
origins in the drift margin, and tiles over one staging pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch import workloads
from lammps_user_conp2_tpu_torch.models.conp import setup_conp
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
from lammps_user_conp2_tpu_torch.ops.pairs import min_image
from lammps_user_conp2_tpu_torch.ops.pppm import TileGeom, rho_coeffs
from torch_cells import (CPU64, S3, SOLVE64, charges_with_electrodes,
                         il_small, il_small_file, rel_err, tile_rows, x_close,
                         x_near)

TOL = 1e-12


@pytest.fixture(scope="module")
def block_cells(tmp_path_factory):
    """name -> (x, q, engine, nbr, sweep kwargs), float64 on the CPU."""
    out = {}
    system, md, cfg = workloads.synthetic(**S3)
    md = dataclasses.replace(md, pair_path="block")
    conp = setup_conp(system, md, cfg, **SOLVE64)
    eng = build_engine(system, md, conp, **CPU64)
    for name, pos in (("s3_near", x_near), ("s3_3A", x_close)):
        out[name] = (system, md, eng, pos(system))
    system, md, cfg = il_small(workloads, il_small_file(
        tmp_path_factory.mktemp("il")))
    md = dataclasses.replace(md, pair_path="block")
    conp = setup_conp(system, md, cfg, **SOLVE64)
    eng = build_engine(system, md, conp, **CPU64)
    out["il_excl"] = (system, md, eng, system.x0)
    cells = {}
    for name, (system, md, eng, pos) in out.items():
        assert eng.ncfg.block == 8
        x = torch.as_tensor(np.asarray(pos), dtype=torch.float64)
        q = torch.as_tensor(charges_with_electrodes(system))
        nbr, _ = eng.derived_state(x)
        assert not bool(nbr.overflow)
        kw = dict(box=eng.ncfg.grid.box, periodic=eng.ncfg.grid.periodic,
                  cutoff=md.cutoff, g_ewald=eng.conp.ksp.g_ewald,
                  qqr2e=system.units().qqr2e, exclusions=eng.exclusions)
        cells[name] = (x, q, eng, nbr, kw)
    assert cells["il_excl"][4]["exclusions"] is not None
    return cells


def test_pack_rows_plain():
    rng = np.random.default_rng(3)
    n = 57
    x = torch.as_tensor(rng.uniform(-5, 20, (n, 3)))
    q = torch.as_tensor(rng.standard_normal(n))
    ti = torch.as_tensor(rng.integers(0, 9, n))
    kind = rng.integers(0, 3, n)
    ele_f = torch.as_tensor((kind == 1).astype(np.float64))
    ely_f = torch.as_tensor((kind == 2).astype(np.float64))
    for flags, want in (((ele_f, ely_f), np.array([0, 1, -1])[kind]),
                        (None, np.zeros(n))):
        xq, tf = k1.pack_rows(x, q, ti, flags)
        assert xq.dtype == torch.float64 and tf.dtype == torch.int32
        assert torch.equal(xq[:, :3], x) and torch.equal(xq[:, 3], q)
        assert np.array_equal(tf[:, 0].numpy(), ti.numpy())
        assert np.array_equal(tf[:, 1].numpy(), want)
        assert not tf[:, 2:].any()


@pytest.mark.parametrize("nb,usz", [(12421, 160), (1097, 1888), (71, 216),
                                    (1, 32), (8192, 40), (8191, 40)])
def test_block_segments_cover_the_union(nb, usz):
    seg, nseg = k1.block_segments(nb, usz)
    nchunk = -(-usz // 32)
    assert seg >= 1 and nseg >= 1
    assert seg * nseg >= nchunk and seg * (nseg - 1) < nchunk
    if nb >= k1.SWEEP_ITEMS_TARGET // 2:
        assert nseg == 1
    else:
        assert nb * nseg >= min(k1.SWEEP_ITEMS_TARGET, nb * nchunk) // 2


def _in_range_pairs(x, kw, n):
    """Every ordered pair (i, j), i != j, within the cutoff: all pairs."""
    d = min_image(x[:, None, :] - x[None, :, :], kw["box"], kw["periodic"])
    rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    m = (rsq < kw["cutoff"] ** 2) & ~torch.eye(n, dtype=torch.bool)
    return set(map(tuple, torch.nonzero(m).tolist()))


@pytest.mark.parametrize("cell", ["s3_near", "s3_3A", "il_excl"])
def test_pair_queue_holds_each_in_range_pair_once(block_cells, cell):
    x, q, eng, nbr, kw = block_cells[cell]
    un, rows = nbr.bun, nbr.brows
    nb, usz = un.shape
    n = x.shape[0]
    for seg, nseg in (k1.block_segments(nb, usz), (-(-usz // 32), 1)):
        item, b, k, e = k1.pair_queue_plain(
            x, un, rows, box=kw["box"], periodic=kw["periodic"],
            cutoff=kw["cutoff"], seg=seg, nseg=nseg)
        blk = item // nseg
        keyed = set(zip(blk.tolist(), b.tolist(), k.tolist()))
        assert len(keyed) == item.shape[0]                  # each once
        pairs = set(zip(rows[blk, b].tolist(), un[blk, k].tolist()))
        assert len(pairs) == item.shape[0]
        assert pairs == _in_range_pairs(x, kw, n)
        # the kernel's order: items in turn, within each (chunk, lane,
        # block atom), queue places 0, 1, ... and chunks of the item's
        # own segment
        assert np.all(np.diff(item) >= 0)
        order = (item * (-(-usz // 32)) + k // 32) * 32 * 8 + k % 32 * 8 + b
        assert np.all(np.diff(order) > 0)
        starts = np.flatnonzero(np.diff(np.concatenate([[-1], item])))
        assert np.all(e[starts] == 0)
        assert np.all(np.diff(e)[np.diff(item) == 0] == 1)
        assert np.all((k // 32) // seg == item % nseg)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("split", ["auto", "one", "two"])
@pytest.mark.parametrize("cell", ["s3_near", "s3_3A", "il_excl"])
def test_queue_sweep_matches_block_pair_plain(block_cells, cell, split,
                                              fused):
    x, q, eng, nbr, kw = block_cells[cell]
    un, rows = nbr.bun, nbr.brows
    nchunk = -(-un.shape[1] // 32)
    seg = {"auto": k1.block_segments(*un.shape),
           "one": (nchunk, 1),
           "two": (-(-nchunk // 2), 2)}[split]
    fuse = ((eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
            if fused else None)
    args = (x, q, eng.type_idx, un, rows, eng.tables)
    ref = k1.block_pair_plain(*args, conp_fuse=fuse, **kw)
    got = k1.block_pair_queue_plain(*args, conp_fuse=fuse, seg=seg[0],
                                    nseg=seg[1], **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= TOL
    if fused and cell == "s3_3A":
        assert abs(float(ref[3])) > 1e-3        # the correction is large


def _geom(ntx, nty, cap):
    return TileGeom(5, 2, 8, 8, 8, ntx, nty, 2, ntx * nty * 2, cap, False, 1)


def _kept(rows, geom, t):
    """Brute force: the (source, slot) codes output tile t keeps."""
    bw = geom.hw + geom.dm
    tz, ty, tx = (t % geom.ntz, (t // geom.ntz) % geom.nty,
                  t // (geom.ntz * geom.nty))
    out = set()
    for nb in range(9):
        dx, dy = nb // 3 - 1, nb % 3 - 1
        nt = ((((tx + dx) % geom.ntx) * geom.nty + (ty + dy) % geom.nty)
              * geom.ntz + tz)
        for s in range(geom.cap):
            ox = int(rows[nt, 0, s]) + dx * geom.tlx - bw
            oy = int(rows[nt, 1, s]) + dy * geom.tly - bw
            if (rows[nt, 6, s] != 0 and -5 < ox < geom.tlx
                    and -5 < oy < geom.tly):
                out.add(nb * geom.cap + s)
    return out


@pytest.mark.parametrize("staging", ["kernel", "small"])
@pytest.mark.parametrize("ntx,nty", [(1, 1), (2, 2), (9, 9), (1, 2),
                                     (2, 9)])
def test_spread_bins_walk_to_spread_mesh_plain(ntx, nty, staging):
    cap = 40
    geom = _geom(ntx, nty, cap)
    rows = tile_rows(geom, seed=10 * ntx + nty, heavy=0)
    kw = {} if staging == "kernel" else dict(round_size=8, pass_cap=16)
    bins = k2.spread_bins_plain(rows, geom, **kw)
    r = rows.numpy()
    nwy = geom.tly + 4
    for t, passes in enumerate(bins):
        items = np.concatenate([p[1] for p in passes]) if passes else []
        assert len(set(items)) == len(items)
        assert set(items) == _kept(r, geom, t)
        for ends, it in passes:
            assert ends[-1] == len(it)
            nb, sl = np.divmod(it, cap)
            src = k2._mesh_sources(r, geom, t)
            ox = np.array([int(src[a][0][0, s]) + src[a][2]
                           for a, s in zip(nb, sl)])
            oy = np.array([int(src[a][0][1, s]) + src[a][3]
                           for a, s in zip(nb, sl)])
            cell = (ox + 4) * nwy + oy + 4
            assert np.all(np.diff(cell) >= 0)            # sorted by cell
            same = np.diff(cell) == 0
            assert np.all(np.diff(it)[same] > 0)         # stable
            assert np.array_equal(np.searchsorted(
                cell, np.arange(len(ends)), side="right"), ends)
    cf = torch.as_tensor(rho_coeffs(5))
    got = k2.spread_from_bins_plain(rows, cf, geom, bins)
    ref = k2.spread_mesh_plain(rows, cf, geom).numpy()
    assert rel_err(got, ref) <= TOL
    if staging == "small":
        assert max(len(p) for p in bins) > 1             # over one pass
    assert any(not p for p in bins)                      # empty tiles
    if ntx * nty >= 9:
        margin = r[:, 0][r[:, 6] != 0]
        assert (margin == 0).any() and (margin == geom.tlx + 1).any()


def test_spread_bins_tile_over_one_pass():
    """A full tile whose kept atoms fill the kernel's pass three times."""
    geom = _geom(2, 2, 3 * k2.spread_pass_cap(_geom(2, 2, 1)) // 2)
    rows = tile_rows(geom, seed=5, heavy=2)
    bins = k2.spread_bins_plain(rows, geom)
    assert len(bins[2]) >= 2
    assert sum(len(p[1]) for p in bins[2]) >= geom.cap
    cf = torch.as_tensor(rho_coeffs(5))
    assert rel_err(k2.spread_from_bins_plain(rows, cf, geom, bins),
                   k2.spread_mesh_plain(rows, cf, geom).numpy()) <= TOL
