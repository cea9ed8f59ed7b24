"""Pair sweep (LJ + real-space Coulomb, optional fused CONP correction):
the CUDA kernel ``csrc/pair_kernel.cu`` and its plain PyTorch version.

``pair_forces`` launches the kernel for CUDA float32 tensors and takes
``pair_forces_plain`` for CPU and CUDA float64 tensors
(``build.kernel_route``).  Same inputs and return values as
the JAX package's ``pair_forces_pallas``, except that atom types index the
(T+1, T+1) tables directly (no one-hot operands).

The kernel evaluates each unordered pair once (Newton's third law, as the
TPU kernel does) over a schedule of (row tile, column tile) work items:
tiles of ``TILE`` consecutive atoms of the z order, each row tile paired
with the tiles at or after it whose z span lies within the cutoff
(``tile_schedule``).  Every work item has its own slot in a side buffer
sized by the tile-pair triangle, so nothing can overflow and nothing is
regrown.  Special-bond exclusions are applied per pair inside the kernel,
from the row atom's list (the lists are symmetric), as the plain version
applies them (the JAX package sweeps at s = 1 and corrects afterwards,
which cancels catastrophically in float32 at bonded distances).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..pairs import (PairTables, conp_correction_forces, dense_pair_forces,
                     gauss_table_kernels)
from . import build
from .zorder import Z_MARGIN, z_perm

launches = build.LaunchCounter("pair_forces")
TILE = 32          # atoms per tile: one warp lane each (csrc/pair_kernel.cu)
SLOT = 6 * TILE    # side-buffer floats per work item (row and column forces)


class TileSchedule(NamedTuple):
    """The tile-pair work items of the z-sorted atoms, T = ceil(N / TILE)
    tiles.  Row tile I pairs with the direct range [I, hi[I]] and the
    wrapped range [wp[I], T) (empty: wp[I] = T; periodic z only); its items
    are [off[I], off[I+1]), in ascending column tile.  Column tile J is
    reached by the row tiles [lo_col[J], J] (direct) and [0, wc[J])
    (wrapped)."""
    off: torch.Tensor       # (T + 1,)
    hi: torch.Tensor        # (T,)
    wp: torch.Tensor        # (T,)
    lo_col: torch.Tensor    # (T,)
    wc: torch.Tensor        # (T,)


def tile_schedule_plain(zs, n, *, box, periodic, cutoff) -> TileSchedule:
    """The schedule from the sorted z keys ``zs`` (N,) with searchsorted on
    the tiles' first and last keys, the cull of ``cutoff + Z_MARGIN``: the
    plain version of the kernel's ``pair_schedule`` (the same float32
    bounds on float32 keys).  int64 tensors on ``zs``'s device."""
    nt = -(-n // TILE)
    zcut = float(cutoff) + Z_MARGIN
    tiles = torch.arange(nt, device=zs.device)
    t_lo = zs[::TILE].contiguous()
    t_hi = zs[torch.clamp((tiles + 1) * TILE, max=n) - 1].contiguous()
    hi = torch.maximum(torch.searchsorted(t_lo, t_hi + zcut, right=True) - 1,
                       tiles)
    if periodic[2]:
        w = torch.searchsorted(t_hi, t_lo + (float(box[2]) - zcut))
        wp = torch.maximum(w, hi + 1)
    else:
        w = wp = torch.full_like(hi, nt)
    cnt = hi - tiles + 1 + (nt - wp)
    off = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    lo_col = torch.searchsorted(hi, tiles)
    wc = torch.minimum(torch.searchsorted(w, tiles, right=True), lo_col)
    return TileSchedule(off, hi, wp, lo_col, wc)


def tile_schedule(zs, n, *, box, periodic, cutoff) -> TileSchedule:
    """``tile_schedule_plain`` for CPU and CUDA float64 keys; for CUDA
    float32 keys the kernel's own schedule (``pair_schedule``, int32),
    which ``pair_forces`` computes inside its launch."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff)
    if not build.kernel_route("tile_schedule", zs):
        return tile_schedule_plain(zs, n, **kw)
    build.check_cuda("tile_schedule", torch.float32, zs)
    nt = -(-n // TILE)
    zcut = float(cutoff) + Z_MARGIN
    sched = torch.empty(6 * nt + 1 + nt * (nt + 1) // 2, dtype=torch.int32,
                        device=zs.device)
    lib = build.load_library()
    build.check_status("tile_schedule", lib.conp2_pair_schedule_i32(
        zs.data_ptr(), n, int(bool(periodic[2])), zcut,
        float(box[2]) - zcut, sched.data_ptr(), build.stream_ptr(zs.device)))
    return TileSchedule(*torch.split(sched[:5 * nt + 1],
                                     [nt + 1, nt, nt, nt, nt]))


def schedule_items(s: TileSchedule):
    """(I, J): the row and column tile of every work item, in item order,
    decoded as the sweep decodes them."""
    nt = s.hi.shape[0]
    off, hi, wp = s.off.long(), s.hi.long(), s.wp.long()
    k = torch.arange(int(off[-1]), device=off.device)
    ti = torch.searchsorted(off, k, right=True) - 1
    d = k - off[ti]
    nd = hi[ti] - ti + 1
    tj = torch.where(d < nd, ti + d, wp[ti] + d - nd)
    assert nt == 0 or int(tj.max()) < nt
    return ti, tj


def schedule_pairs(s: TileSchedule, n: int) -> int:
    """Unordered atom pairs the sweep tests: every row x column pair of an
    off-diagonal item, r (r - 1) / 2 of a diagonal one."""
    ti, tj = schedule_items(s)
    size = lambda t: torch.clamp(n - t * TILE, max=TILE)
    ri, cj = size(ti), size(tj)
    return int(torch.where(ti == tj, ri * (ri - 1) // 2, ri * cj).sum())


def pair_forces_plain(x, q, type_idx, tables: PairTables, exclusions, *, box,
                      periodic, cutoff, g_ewald, qqr2e, conp_fuse=None,
                      ele_idx=None):
    """Dense row-blocked sweep: ``dense_pair_forces`` plus, with
    ``conp_fuse = (ele_flag, elyte_flag, eta_tab, fo_tab)``, the electrode-row
    ``conp_correction_forces`` over the rows ``ele_idx`` (the atoms whose
    ele_flag is set; found from the flag, with a host sync, when None).
    Returns (f, evdwl, ecoul[, ecorr])."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff)
    f, ev, ec = dense_pair_forces(x, q, type_idx, tables, exclusions,
                                  g_ewald=g_ewald, qqr2e=qqr2e, **kw)
    if conp_fuse is None:
        return f, ev, ec
    ele_f, ely_f, eta_tab, fo_tab = conp_fuse
    potential, force = gauss_table_kernels(eta_tab, fo_tab)
    if ele_idx is None:
        ele_idx = torch.nonzero(ele_f > 0).squeeze(1)
    fc, ecorr = conp_correction_forces(x, q, ele_idx, ely_f > 0, force,
                                       potential, type_idx, qqr2e=qqr2e, **kw)
    return f + fc, ev, ec, ecorr


def pair_forces(x, q, type_idx, tables: PairTables, exclusions, *, box,
                periodic, cutoff, g_ewald, qqr2e, zsort=None, conp_fuse=None,
                ele_idx=None):
    """LJ + erfc Coulomb forces and energies over all pairs in range.

    ``zsort``: (perm, z_sorted) from ``zorder.z_perm`` at these positions
    (computed here when None).  ``exclusions``: (excl_idx (N, m) int64,
    excl_val (N, m)) with m <= 16 and symmetric lists (j lists i with the
    factor i lists j with), or None.  ``conp_fuse``: optional (ele_flag,
    elyte_flag, eta_tab, fo_tab) -- per-atom 0/1 float flags (N,) and the
    (T+1, T+1) Gaussian width / overlap tables; the forces then include the
    CONP Gaussian correction and a fourth value ``ecorr`` is returned.
    ``ele_idx``: the electrode rows, which the plain version sweeps (the
    kernel reads the flag); pass it on the card, where finding them from
    the flag would sync the host.
    Returns (f (N,3), evdwl, ecoul[, ecorr])."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff, g_ewald=g_ewald,
              qqr2e=qqr2e)
    if not build.kernel_route("pair_forces", x):
        return pair_forces_plain(x, q, type_idx, tables, exclusions,
                                 conp_fuse=conp_fuse, ele_idx=ele_idx, **kw)
    n = x.shape[0]
    nt1 = tables.lj1.shape[0]
    if zsort is None:
        zsort = z_perm(x, box, periodic)
    perm, zs = zsort
    build.check_cuda("pair_forces", torch.float32, x, q, zs, *tables)
    build.check_cuda("pair_forces", torch.int64, type_idx, perm)
    if (x.shape != (n, 3) or q.shape != (n,) or type_idx.shape != (n,)
            or perm.shape != (n,) or zs.shape != (n,)):
        raise ValueError("pair_forces: expected x (N,3) and q, types, perm, "
                         "z keys (N,)")
    if tables.lj1.shape != (nt1, nt1) or not (
            tables.lj1.shape == tables.lj2.shape == tables.lj3.shape
            == tables.lj4.shape):
        raise ValueError("pair_forces: LJ tables must be (T+1, T+1)")
    ptrs = [None] * 4                             # ele_f, ely_f, eta, fo
    if conp_fuse is not None:
        build.check_cuda("pair_forces", torch.float32, *conp_fuse)
        if (conp_fuse[0].shape != (n,) or conp_fuse[1].shape != (n,)
                or conp_fuse[2].shape != (nt1, nt1)
                or conp_fuse[3].shape != (nt1, nt1)):
            raise ValueError("pair_forces: conp_fuse flags must be (N,) and "
                             "tables (T+1, T+1)")
        ptrs = [t.data_ptr() for t in conp_fuse]
    exi = exv = None
    m = 0
    if exclusions is not None:
        exi, exv = exclusions
        m = exi.shape[1]
        build.check_cuda("pair_forces", torch.int64, exi)
        build.check_cuda("pair_forces", torch.float32, exv)
        if exi.shape != (n, m) or exv.shape != (n, m) or m > 16:
            raise ValueError("pair_forces: exclusions must be (N, m), m <= 16")
    lib = build.load_library()
    nt = -(-n // TILE)
    items_cap = nt * (nt + 1) // 2
    nctas = sweep_ctas(conp_fuse is not None, m, items_cap)
    if nctas <= 0:
        raise RuntimeError("pair_forces: the card refused the sweep's shared "
                           f"memory for {m} special partners per atom")
    # one workspace: the side buffer, the sweep's per-CTA energies and the
    # schedule with each item's row tile (int32); one output: f, then
    # evdwl, ecoul, ecorr
    nbuf = items_cap * SLOT + 3 * nctas
    ws = torch.empty(nbuf + 6 * nt + 1 + items_cap, dtype=x.dtype,
                     device=x.device)
    out = torch.empty(3 * n + 3, dtype=x.dtype, device=x.device)
    wsp, outp = ws.data_ptr(), out.data_ptr()
    zcut = float(cutoff) + Z_MARGIN
    status = lib.conp2_pair_forces_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ptrs[0], ptrs[1],
        perm.data_ptr(), zs.data_ptr(), *[t.data_ptr() for t in tables],
        ptrs[2], ptrs[3], None if exi is None else exi.data_ptr(),
        None if exv is None else exv.data_ptr(), m, n, nt1,
        *[float(b) for b in box], *[int(bool(p)) for p in periodic],
        float(cutoff) ** 2, zcut, float(box[2]) - zcut, float(g_ewald),
        float(qqr2e), nctas, wsp + 4 * nbuf, wsp,
        wsp + 4 * items_cap * SLOT,
        outp, outp + 4 * 3 * n, build.stream_ptr(x.device))
    build.check_status("pair_forces", status)
    launches.count += 1
    ev, ec, ecorr = out[3 * n:]
    f = out[:3 * n].view(n, 3)
    if conp_fuse is not None:
        return f, ev, ec, ecorr
    return f, ev, ec


@functools.lru_cache(maxsize=None)
def sweep_ctas(fuse: bool, m: int, items_cap: int) -> int:
    """The persistent sweep's CTA count on the current card: its occupancy
    with the shared memory of m special partners per row, at most one CTA
    per 8 items; -1 if the card refuses that memory.  Asked of the library
    once per shape: this is its only cache."""
    return build.load_library().conp2_pair_sweep_ctas(int(fuse), m,
                                                       items_cap)
