"""The work schedules of the pair sweep (K4) and the electrode b rows (K5).

K4's tile-pair schedule (``pair_kernel.tile_schedule_plain``, the plain
version of the kernel's ``pair_schedule``) against a brute-force count: its
work items are exactly the (row tile, column tile >= row tile) pairs whose
minimum-image z gap is within cutoff + Z_MARGIN, each once, so every
unordered pair within the cutoff lies in exactly one item; the reduction's
column lookup finds exactly the items of each column tile; and the Newton
sweep and reduction the kernel runs, emulated in numpy over the schedule,
equal a dense all-pairs sum (float64, 1e-12).  Random and lattice
positions, periodic and open z, a cutoff over half the box, N = 1, 31, 33,
100 and 7,296.  K5's electrolyte-only z order (the compaction of the full
z order its first kernel makes) holds exactly the electrolyte atoms, by
their mask and in any layout, in z order.  The special-bond lists the sweep reads from the row side are
symmetric.
"""

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
from lammps_user_conp2_tpu_torch.ops.kernels.ele_rows_kernel import \
    elyte_order_plain
from lammps_user_conp2_tpu_torch.ops.kernels.zorder import (Z_MARGIN, wrap_z,
                                                            z_perm)

TILE = k4.TILE
BOX = (24.0, 24.0, 60.0)


def _positions(kind, n, box, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(box)
    # a simple cubic lattice: many atoms share each z plane (ties in the
    # sort), filled plane by plane
    side = int(np.ceil(np.sqrt(n / 4.0)))
    nz = -(-n // (side * side))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3)
    order = np.lexsort((g[:, 1], g[:, 0], g[:, 2]))
    frac = (g[order[:n]] + 0.5) / np.array([side, side, nz])
    return frac * np.asarray(box)


def _setup(kind, n, pz, cutoff, box=BOX, dtype=torch.float64):
    periodic = (True, True, pz)
    x = torch.as_tensor(_positions(kind, n, box), dtype=dtype)
    perm, zs = z_perm(x, box, periodic)
    s = k4.tile_schedule_plain(zs, n, box=box, periodic=periodic,
                               cutoff=cutoff)
    return x, perm, zs, s, periodic


def _tile_gap_pairs(zs, n, pz, lz, zcut):
    """(I, J <= ...) tile pairs I <= J within the z cull, by brute force."""
    nt = -(-n // TILE)
    z = zs.double().numpy()
    lo = np.array([z[TILE * t] for t in range(nt)])
    hi = np.array([z[min(n, TILE * t + TILE) - 1] for t in range(nt)])
    out = set()
    for i in range(nt):
        for j in range(i, nt):
            gap = max(lo[j] - hi[i], lo[i] - hi[j], 0.0)
            if pz:
                span = max(hi[i], hi[j]) - min(lo[i], lo[j])
                gap = min(gap, max(lz - span, 0.0))
            if gap <= zcut:
                out.add((i, j))
    return out


def _min_image(d, box, periodic):
    d = d.copy()
    for ax in range(3):
        if periodic[ax]:
            d[..., ax] -= box[ax] * np.round(d[..., ax] / box[ax])
    return d


CASES = [("random", 1, False, 5.0), ("random", 31, True, 5.0),
         ("lattice", 33, False, 5.0), ("random", 33, True, 5.0),
         ("lattice", 100, True, 5.0), ("random", 100, False, 40.0),
         ("random", 100, True, 31.0), ("random", 500, True, 8.0),
         ("lattice", 7296, True, 5.0),
         ("random", 7296, False, 5.0)]
IDS = [f"{k}-n{n}-{'pz' if p else 'open'}-rc{c:g}" for k, n, p, c in CASES]


@pytest.mark.parametrize("kind,n,pz,cutoff", CASES, ids=IDS)
def test_tile_schedule_covers_each_pair_once(kind, n, pz, cutoff):
    x, perm, zs, s, periodic = _setup(kind, n, pz, cutoff)
    nt = -(-n // TILE)
    ti, tj = k4.schedule_items(s)
    items = list(zip(ti.tolist(), tj.tolist()))
    # each tile pair at most once, row tile first, in the order the
    # reduction reads the row slots
    assert len(set(items)) == len(items)
    assert all(i <= j for i, j in items)
    assert ti.tolist() == sorted(ti.tolist())
    assert int(s.off[-1]) <= nt * (nt + 1) // 2
    if pz and kind == "random" and n >= 100:   # wrapped ranges exercised
        assert bool((s.wp < nt).any()) and bool((s.wc > 0).any())
    # exactly the z cull's tile pairs (the old kernel's per-tile test)
    assert set(items) == _tile_gap_pairs(zs, n, pz, BOX[2],
                                         cutoff + Z_MARGIN)
    # every unordered pair within the cutoff falls in an item
    pos = torch.empty(n, dtype=torch.long)
    pos[perm] = torch.arange(n)
    tile = (pos // TILE).numpy()
    xn = x.numpy()
    need = set()
    for i0 in range(0, n, 1024):
        d = _min_image(xn[i0:i0 + 1024, None, :] - xn[None, :, :], BOX,
                       periodic)
        a, b = np.nonzero((d * d).sum(-1) < cutoff * cutoff)
        keep = a + i0 < b
        ta, tb = tile[a[keep] + i0], tile[b[keep]]
        need |= set(zip(np.minimum(ta, tb).tolist(),
                        np.maximum(ta, tb).tolist()))
    assert need <= set(items)
    # the reduction's column lookup: row tiles [0, wc) and [lo_col, J]
    index = {it: k for k, it in enumerate(items)}
    off, hi, wp = s.off.tolist(), s.hi.tolist(), s.wp.tolist()
    for j in range(nt):
        rows = (list(range(int(s.wc[j]))) +
                list(range(int(s.lo_col[j]), j + 1)))
        assert rows == sorted(i for i, jj in items if jj == j)
        for i in rows:
            k = (off[i] + j - i if j <= hi[i]
                 else off[i] + hi[i] - i + 1 + j - wp[i])
            assert index[(i, j)] == k


def _pair_force(d):
    """An antisymmetric test force on each pair: d * (1 + |d|^2)^-2."""
    r2 = (d * d).sum(-1)
    return d * (1.0 / (1.0 + r2) ** 2)[..., None]


@pytest.mark.parametrize("kind,n,pz,cutoff", [c for c in CASES
                                               if c[1] <= 500],
                         ids=[i for i, c in zip(IDS, CASES) if c[1] <= 500])
def test_newton_sweep_over_schedule_equals_dense_sum(kind, n, pz, cutoff):
    """The sweep's arithmetic structure on the schedule: a diagonal item
    takes column > row only, each item writes its row and column partials
    to its own slot, and each atom sums its row slots then its column slots
    in index order; equal to the dense sum over all ordered pairs."""
    x, perm, zs, s, periodic = _setup(kind, n, pz, cutoff)
    xn, pm = x.numpy(), perm.numpy()
    nt = -(-n // TILE)
    ti, tj = k4.schedule_items(s)
    slots = np.zeros((len(ti), 2, TILE, 3))
    pairs = 0
    for k, (i, j) in enumerate(zip(ti.tolist(), tj.tolist())):
        ri = pm[TILE * i:min(n, TILE * i + TILE)]
        cj = pm[TILE * j:min(n, TILE * j + TILE)]
        d = _min_image(xn[ri][:, None, :] - xn[cj][None, :, :], BOX, periodic)
        on = (d * d).sum(-1) < cutoff * cutoff
        if i == j:
            on &= np.arange(len(cj))[None, :] > np.arange(len(ri))[:, None]
        pairs += int(on.sum())
        fp = _pair_force(d) * on[..., None]
        slots[k, 0, :len(ri)] = fp.sum(1)
        slots[k, 1, :len(cj)] = -fp.sum(0)
    off, hi, wp = s.off.tolist(), s.hi.tolist(), s.wp.tolist()
    f = np.zeros((n, 3))
    for j in range(nt):
        acc = slots[off[j]:off[j + 1], 0].sum(0)
        for i in (list(range(int(s.wc[j]))) +
                  list(range(int(s.lo_col[j]), j + 1))):
            k = (off[i] + j - i if j <= hi[i]
                 else off[i] + hi[i] - i + 1 + j - wp[i])
            acc = acc + slots[k, 1]
        cnt = min(n, TILE * j + TILE) - TILE * j
        f[pm[TILE * j:TILE * j + cnt]] = acc[:cnt]
    d = _min_image(xn[:, None, :] - xn[None, :, :], BOX, periodic)
    on = ((d * d).sum(-1) < cutoff * cutoff) & ~np.eye(n, dtype=bool)
    ref = (_pair_force(d) * on[..., None]).sum(1)
    assert pairs == int(on.sum()) // 2          # each pair evaluated once
    np.testing.assert_allclose(f, ref, rtol=0, atol=1e-12)


def test_tile_schedule_float32_keys_cover_pairs():
    """Float32 keys, as on the card: the schedule still holds every pair
    (the cull carries Z_MARGIN) on the 7,296-atom lattice."""
    x, perm, zs, s, periodic = _setup("lattice", 7296, True, 5.0,
                                      dtype=torch.float32)
    assert zs.dtype == torch.float32
    items = set(zip(*(t.tolist() for t in k4.schedule_items(s))))
    ref = _tile_gap_pairs(zs, 7296, True, BOX[2], 5.0)
    assert ref <= items
    assert k4.schedule_pairs(s, 7296) >= 0


def _check_elyte_order(x, elyte, box, periodic):
    """The order K5 searches (its first kernel's plain version): exactly
    the electrolyte atoms, in the order the full z order holds them, with
    their own sorted keys."""
    perm, zs = z_perm(x, box, periodic)
    cperm, czs = elyte_order_plain(perm, zs, elyte.double())
    assert sorted(cperm.tolist()) == torch.nonzero(elyte)[:, 0].tolist()
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(perm.shape[0])
    assert bool((pos[cperm][1:] > pos[cperm][:-1]).all())    # stable
    assert bool((czs[1:] >= czs[:-1]).all())
    keys = wrap_z(x[:, 2], box[2], periodic[2])
    assert torch.equal(keys[cperm], czs)
    return cperm


def test_elyte_order_takes_the_electrolyte():
    """Under electrodes_first the electrolyte is the atoms [Ne, N)."""
    from lammps_user_conp2_tpu_torch import workloads
    from torch_cells import S2, x_near
    system, _, _ = workloads.synthetic(**S2)
    ne = int(system.ele_mask.sum())
    assert system.ele_mask[:ne].all() and not system.ele_mask[ne:].any()
    x = torch.as_tensor(x_near(system))
    elyte = torch.as_tensor(~system.ele_mask)
    for periodic in (system.periodic, (True, True, True)):
        cperm = _check_elyte_order(x, elyte, system.box, periodic)
        assert sorted(cperm.tolist()) == list(range(ne, system.natoms))


@pytest.mark.parametrize("pz", [False, True], ids=["open", "pz"])
def test_elyte_order_any_layout(pz):
    """The order is taken by the mask, not by index: electrodes and
    electrolyte interleaved at random, as a direct caller may lay them
    out."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(_positions("random", 300, BOX))
    elyte = torch.as_tensor(rng.uniform(size=300) < 0.6)
    _check_elyte_order(x, elyte, BOX, (True, True, pz))


def test_exclusion_lists_are_symmetric(tmp_path):
    """K4 looks each pair's special factor up from its row atom's list:
    j lists i with the factor i lists j with (the il fixture's cations)."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.system import exclusion_lists
    from torch_cells import il_small, il_small_file
    system, _, _ = il_small(workloads, il_small_file(tmp_path))
    idx, val = exclusion_lists(system)
    n = system.natoms
    listed = {(i, int(j)): float(v) for i in range(n)
              for j, v in zip(idx[i], val[i]) if j < n}
    assert listed
    assert all(listed.get((j, i)) == v for (i, j), v in listed.items())
