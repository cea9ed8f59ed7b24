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

The tile path (``order`` other than "z", or a ``pair_cap``; the engine's
``pair_path="tile"``) is the JAX kernel's other schedule: the atoms in a
spatial order (``zorder.ORDERINGS``, k-d bricks on the engine's path),
the tile pairs of the round-robin pairing (tile i with (i + jp) mod ni for
jp < (ni + 1) / 2, ni made odd) culled by the tiles' 3-D bounding boxes
(``tile_mask3``), the live ones compacted i-major into at most
``pair_cap`` items with a by-column index (``tile_items``), all in plain
PyTorch as the JAX package computes them outside its kernel; then the
kernel's item-list entry sweeps them, one side-buffer slot per item.  A
live count above the cap gives NaN forces and energies.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..pairs import (PairTables, conp_correction_forces, dense_pair_forces,
                     gauss_table_kernels, min_image, special_factors)
from ..erfc import A1, A2, A3, A4, A5, EWALD_F, EWALD_P
from . import build
from .zorder import ORDERINGS, Z_MARGIN, kd_perm, wrap_coords, z_perm

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
    fc, ecorr = _correction_plain(x, q, type_idx, conp_fuse, ele_idx,
                                  qqr2e=qqr2e, **kw)
    return f + fc, ev, ec, ecorr


def _correction_plain(x, q, type_idx, conp_fuse, ele_idx, *, box, periodic,
                      cutoff, qqr2e):
    """The fused correction's plain version: ``conp_correction_forces``
    over the electrode rows ``ele_idx`` (found from the flag, with a host
    sync, when None).  Returns (f, ecorr)."""
    ele_f, ely_f, eta_tab, fo_tab = conp_fuse
    potential, force = gauss_table_kernels(eta_tab, fo_tab)
    if ele_idx is None:
        ele_idx = torch.nonzero(ele_f > 0).squeeze(1)
    return conp_correction_forces(x, q, ele_idx, ely_f > 0, force, potential,
                                  type_idx, box=box, periodic=periodic,
                                  cutoff=cutoff, qqr2e=qqr2e)


def pair_forces(x, q, type_idx, tables: PairTables, exclusions, *, box,
                periodic, cutoff, g_ewald, qqr2e, zsort=None, conp_fuse=None,
                ele_idx=None, order="z", pair_cap=None):
    """LJ + erfc Coulomb forces and energies over all pairs in range.

    ``order``/``pair_cap``: "z" with no cap is the z schedule; any other
    order (``zorder.ORDERINGS``) or a cap takes the tile path
    (``pair_forces_items``).
    ``zsort``: (perm, z_sorted) from the order's function at these
    positions (computed here when None).  ``exclusions``: (excl_idx (N, m) int64,
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
    if order != "z" or pair_cap is not None:
        return pair_forces_items(x, q, type_idx, tables, exclusions,
                                 zsort=zsort, order=order, pair_cap=pair_cap,
                                 conp_fuse=conp_fuse, ele_idx=ele_idx, **kw)
    if not build.kernel_route("pair_forces", x):
        return pair_forces_plain(x, q, type_idx, tables, exclusions,
                                 conp_fuse=conp_fuse, ele_idx=ele_idx, **kw)
    n = x.shape[0]
    if zsort is None:
        zsort = z_perm(x, box, periodic)
    perm, zs = zsort
    build.check_cuda("pair_forces", torch.float32, zs)
    if zs.shape != (n,):
        raise ValueError("pair_forces: expected z keys (N,)")
    ptrs, exi, exv, m = _check_kernel_args(x, q, type_idx, tables,
                                           exclusions, perm, conp_fuse)
    nt1 = tables.lj1.shape[0]
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


def _check_kernel_args(x, q, type_idx, tables, exclusions, perm,
                       conp_fuse):
    """The kernel entries' checks; (correction pointers, exi, exv, m)."""
    n = x.shape[0]
    nt1 = tables.lj1.shape[0]
    build.check_cuda("pair_forces", torch.float32, x, q, *tables)
    build.check_cuda("pair_forces", torch.int64, type_idx, perm)
    if (x.shape != (n, 3) or q.shape != (n,) or type_idx.shape != (n,)
            or perm.shape != (n,)):
        raise ValueError("pair_forces: expected x (N,3) and q, types, perm "
                         "(N,)")
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
    return ptrs, exi, exv, m


# ------------------------------------------------------------ the tile path
# items per chunk of the plain item sweep (32 x 32 pairs each)
ITEM_CHUNK = 2048


def odd_tiles(n: int, tr: int = TILE) -> int:
    """Tiles of ``tr`` ordered atoms, made odd (one empty pad tile) for the
    round-robin pairing."""
    ni = max(-(-n // tr), 1)
    return ni + 1 - ni % 2


def order_atoms(x, box, periodic, order: str, tr: int = TILE):
    """(perm, wrapped z of the permuted atoms) of ``order``; the k-d
    bricks at tile size ``tr``."""
    if order == "kd":
        return kd_perm(x, box, periodic, tr=tr)
    return ORDERINGS[order](x, box, periodic)


def tile_mask3(xw, valid, ni: int, tr: int, njp: int, cutoff, box,
               periodic):
    """(ni, njp) int32: 1 where tile i and its round-robin partner (i + jp)
    mod ni can hold a pair within cutoff + Z_MARGIN, judged by the tiles'
    bounding boxes of the wrapped coordinates ``xw`` (ni tr, 3) without
    the pads (``valid``); on a periodic axis the gap is the smaller of the
    direct and the around-the-box gap (JAX ``_tile_mask3``).  jp = 0, the
    tile with itself, is always live."""
    big = 1e8
    xt = xw.reshape(ni, tr, 3)
    vt = valid.reshape(ni, tr, 1)
    mins = torch.amin(torch.where(vt, xt, torch.full_like(xt, big)), dim=1)
    maxs = torch.amax(torch.where(vt, xt, torch.full_like(xt, -big)), dim=1)
    tvalid = torch.any(vt[:, :, 0], dim=1)
    cut = float(cutoff) + Z_MARGIN
    ii = torch.arange(ni, device=xw.device)[:, None]
    jj = (ii + torch.arange(njp, device=xw.device)[None, :]) % ni
    gapsq = torch.zeros((ni, njp), dtype=xw.dtype, device=xw.device)
    for ax in range(3):
        mi, ma = mins[:, ax], maxs[:, ax]
        gap = torch.clamp(torch.maximum(mi[jj] - ma[ii], mi[ii] - ma[jj]),
                          min=0.0)
        if periodic[ax]:
            span = (torch.maximum(ma[ii], ma[jj])
                    - torch.minimum(mi[ii], mi[jj]))
            gap = torch.minimum(gap, torch.clamp(float(box[ax]) - span,
                                                 min=0.0))
        gapsq = gapsq + gap * gap
    act = (gapsq <= cut * cut) & tvalid[ii] & tvalid[jj]
    act[:, 0] = True
    return act.to(torch.int32)


class TileItems(NamedTuple):
    """The live tile pairs of the tile path, compacted i-major (JAX
    ``_compact_pairs``) into at most ``cap`` items: row tile ``ti``,
    column tile ``tj`` and ``meta`` bits (1 live, 2 diagonal, 4 the row
    tile's first item, 8 the pair of tiles can hold an (electrode,
    electrolyte) pair); the items of row tile t are [row_off[t],
    row_off[t + 1]); ``col_items`` lists the items by column tile (a
    stable sort), those of tile t at [col_off[t], col_off[t + 1]).  Pads
    past the live items have ti = tj = ni.  ``count`` () is the live count
    before the cap; ``packed`` the int32 array the kernel reads."""
    ti: torch.Tensor
    tj: torch.Tensor
    meta: torch.Tensor
    row_off: torch.Tensor
    col_off: torch.Tensor
    col_items: torch.Tensor
    count: torch.Tensor
    packed: torch.Tensor


def compact_items(act, ni: int, njp: int, cap: int, corr=None) -> TileItems:
    """``TileItems`` of the (ni, njp) live mask ``act`` (and the same
    layout's correction mask ``corr``): an exclusive prefix sum places each
    live tile pair, one index copy of distinct targets writes them (no
    sort, no host read)."""
    dev = act.device
    flat = act.reshape(-1).to(torch.int64)
    ntp = flat.numel()
    pos = torch.cumsum(flat, 0) - flat
    count = torch.sum(flat)
    tgt = torch.where((flat > 0) & (pos < cap), pos, cap)
    idx = torch.full((cap + 1,), ntp, dtype=torch.int64, device=dev)
    idx.scatter_(0, tgt, torch.arange(ntp, device=dev))
    idx = idx[:cap]
    live = idx < ntp
    safe = torch.where(live, idx, torch.zeros_like(idx))
    ti = torch.where(live, safe // njp, ni)
    jp = safe % njp
    tj = torch.where(live, (ti + jp) % ni, ni)
    first = live.clone()
    first[1:] = live[1:] & (ti[1:] != ti[:-1])
    meta = (live.to(torch.int64) | ((live & (jp == 0)).to(torch.int64) << 1)
            | (first.to(torch.int64) << 2))
    if corr is not None:
        meta = meta | ((corr.reshape(-1)[safe].to(torch.int64)
                        & live.to(torch.int64)) << 3)
    tiles = torch.arange(ni + 1, device=dev)
    row_off = torch.searchsorted(ti, tiles)
    col_items = torch.sort(tj, stable=True).indices
    col_off = torch.searchsorted(tj[col_items], tiles)
    parts = [ti, tj, meta, row_off, col_off, col_items, count.view(1)]
    packed = torch.cat(parts).to(torch.int32)
    return TileItems(*(p for p in torch.split(
        packed, [cap, cap, cap, ni + 1, ni + 1, cap, 1])), packed)


def _live_tiles(x, perm, box, periodic, cutoff, tr):
    """(the (ni, njp) live mask, the (ni tr,) valid rows, ni, njp) of the
    atoms in the order ``perm``, cut into tiles of ``tr``."""
    n = x.shape[0]
    ni = odd_tiles(n, tr)
    njp = (ni + 1) // 2
    xw = torch.cat([wrap_coords(x[perm], box, periodic),
                    x.new_zeros(ni * tr - n, 3)])
    valid = torch.arange(ni * tr, device=x.device) < n
    return (tile_mask3(xw, valid, ni, tr, njp, cutoff, box, periodic), valid,
            ni, njp)


def tile_items(x, perm, *, box, periodic, cutoff, pair_cap=None,
               conp_fuse=None, tr: int = TILE) -> TileItems:
    """The live tile pairs of the atoms in the order ``perm``: the
    bounding-box mask, its correction mask (``conp_fuse``'s flags: one
    tile holds an electrode and the other an electrolyte atom), the
    compacted items at ``pair_cap`` (None: every tile pair)."""
    act, valid, ni, njp = _live_tiles(x, perm, box, periodic, cutoff, tr)
    pad = ni * tr - x.shape[0]
    corr = None
    if conp_fuse is not None:
        ele_f, ely_f = conp_fuse[0], conp_fuse[1]
        he = torch.any(torch.cat([ele_f[perm] > 0, valid.new_zeros(pad)])
                       .reshape(ni, tr), dim=1)
        hy = torch.any(torch.cat([ely_f[perm] > 0, valid.new_zeros(pad)])
                       .reshape(ni, tr), dim=1)
        ii = torch.arange(ni, device=x.device)[:, None]
        jj = (ii + torch.arange(njp, device=x.device)[None, :]) % ni
        corr = (he[ii] & hy[jj]) | (hy[ii] & he[jj])
    ntp = ni * njp
    cap = ntp if pair_cap is None else min(int(pair_cap), ntp)
    return compact_items(act, ni, njp, cap, corr)


def pair_tile_count(x, *, box, periodic, cutoff, tr: int = TILE,
                    order: str = "kd") -> int:
    """The live tile-pair count at positions ``x`` in ``order`` (JAX
    ``pair_tile_count``): the engine sizes ``pair_cap`` from it at x0.
    One host read."""
    perm, _ = order_atoms(x, box, periodic, order, tr)
    return int(torch.sum(_live_tiles(x, perm, box, periodic, cutoff, tr)[0]))


def pair_items_plain(x, q, type_idx, tables: PairTables, exclusions, perm,
                     items: TileItems, *, box, periodic, cutoff, g_ewald,
                     qqr2e, conp_fuse=None, ele_idx=None):
    """The item sweep's plain version: each live item's 32 x 32 pairs (on
    a diagonal item the column after the row), each unordered pair once,
    exclusions per pair; row forces plus the columns' reactions, summed
    per atom.  The correction as ``pair_forces_plain`` adds it (the item's
    correction bit only skips items where it is zero).  NaN forces and
    energies when the live count is above the cap.  Returns (f, evdwl,
    ecoul[, ecorr])."""
    n = x.shape[0]
    dtype = x.dtype
    dev = x.device
    cap = items.ti.shape[0]
    lane = torch.arange(TILE, device=dev)
    cutsq = float(cutoff) ** 2
    live_all = torch.arange(cap, device=dev) < items.count.to(torch.int64)
    f = torch.zeros((n, 3), dtype=dtype, device=dev)
    ev = torch.zeros((), dtype=dtype, device=dev)
    ec = torch.zeros((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for c0 in range(0, cap, ITEM_CHUNK):
        ti = items.ti[c0:c0 + ITEM_CHUNK].to(torch.int64)
        tj = items.tj[c0:c0 + ITEM_CHUNK].to(torch.int64)
        live = live_all[c0:c0 + ITEM_CHUNK, None]
        pr = ti[:, None] * TILE + lane
        pc = tj[:, None] * TILE + lane
        vr, vc = live & (pr < n), live & (pc < n)
        ai = perm[torch.clamp(pr, max=n - 1)]
        aj = perm[torch.clamp(pc, max=n - 1)]
        d = min_image(x[ai][:, :, None, :] - x[aj][:, None, :, :], box,
                      periodic)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        upper = (ti != tj)[:, None, None] | (lane[None, None, :]
                                            > lane[None, :, None])
        mask = vr[:, :, None] & vc[:, None, :] & upper & (rsq < cutsq)
        rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
        r2inv = 1.0 / rsq_safe
        r6inv = r2inv * r2inv * r2inv
        tij = (type_idx[ai][:, :, None], type_idx[aj][:, None, :])
        l1, l2 = tables.lj1[tij], tables.lj2[tij]
        l3, l4 = tables.lj3[tij], tables.lj4[tij]
        if exclusions is None:
            si = torch.ones_like(rsq)
        else:
            si = special_factors(exclusions[0][ai], exclusions[1][ai],
                                 aj[:, None, :], dtype)
        lj_on = mask & (si > 0.0)
        flj = torch.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv,
                          zero)
        elj = torch.where(lj_on, si * r6inv * (l3 * r6inv - l4), zero)
        r = torch.sqrt(rsq_safe)
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        t = 1.0 / (1.0 + EWALD_P * grij)
        erfc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2
        pref = qqr2e * q[ai][:, :, None] * q[aj][:, None, :] / r
        fcoul = torch.where(mask, pref * (erfc + EWALD_F * grij * expm2)
                            - (1.0 - si) * pref, zero)
        ecoul = torch.where(mask, pref * erfc - (1.0 - si) * pref, zero)
        fpair = flj + fcoul * r2inv
        fv = fpair[..., None] * d                       # (B, 32, 32, 3)
        f.index_add_(0, ai.reshape(-1), fv.sum(dim=2).reshape(-1, 3))
        f.index_add_(0, aj.reshape(-1), -fv.sum(dim=1).reshape(-1, 3))
        ev = ev + torch.sum(elj)
        ec = ec + torch.sum(ecoul)
    over = items.count.to(torch.int64)[0] > cap
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    poison = lambda v: torch.where(over, nan, v)
    out = [poison(f), poison(ev), poison(ec)]
    if conp_fuse is not None:
        fc, ecorr = _correction_plain(x, q, type_idx, conp_fuse, ele_idx,
                                      box=box, periodic=periodic,
                                      cutoff=cutoff, qqr2e=qqr2e)
        out = [poison(out[0] + fc), out[1], out[2], poison(ecorr)]
    return tuple(out)


def pair_forces_items(x, q, type_idx, tables: PairTables, exclusions, *,
                      box, periodic, cutoff, g_ewald, qqr2e, zsort=None,
                      order="kd", pair_cap=None, conp_fuse=None,
                      ele_idx=None, items=None):
    """The tile path: the atoms in ``order`` (or ``zsort``'s), the live
    tile pairs at ``pair_cap`` (``tile_items``, or ``items`` built by the
    caller for this order), then the kernel's item-list entry on CUDA
    float32 tensors and ``pair_items_plain`` elsewhere.  Returns (f,
    evdwl, ecoul[, ecorr]), NaN when the live count passed the cap."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff)
    perm = (zsort if zsort is not None
            else order_atoms(x, box, periodic, order))[0]
    if items is None:
        items = tile_items(x, perm, pair_cap=pair_cap, conp_fuse=conp_fuse,
                           **kw)
    if not build.kernel_route("pair_forces", x):
        return pair_items_plain(x, q, type_idx, tables, exclusions, perm,
                                items, g_ewald=g_ewald, qqr2e=qqr2e,
                                conp_fuse=conp_fuse, ele_idx=ele_idx, **kw)
    n = x.shape[0]
    ptrs, exi, exv, m = _check_kernel_args(x, q, type_idx, tables,
                                           exclusions, perm, conp_fuse)
    cap = items.ti.shape[0]
    nt = items.row_off.shape[0] - 1
    nctas = sweep_ctas(conp_fuse is not None, m, cap, items=True)
    if nctas <= 0:
        raise RuntimeError("pair_forces: the card refused the sweep's shared "
                           f"memory for {m} special partners per atom")
    # one workspace: the side buffer (a slot per item) and the per-CTA
    # energies; one output: f, then evdwl, ecoul, ecorr
    nbuf = cap * SLOT
    ws = torch.empty(nbuf + 3 * nctas, dtype=x.dtype, device=x.device)
    out = torch.empty(3 * n + 3, dtype=x.dtype, device=x.device)
    wsp, outp = ws.data_ptr(), out.data_ptr()
    status = build.load_library().conp2_pair_items_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ptrs[0], ptrs[1],
        perm.data_ptr(), items.packed.data_ptr(),
        *[t.data_ptr() for t in tables], ptrs[2], ptrs[3],
        None if exi is None else exi.data_ptr(),
        None if exv is None else exv.data_ptr(), m, n,
        tables.lj1.shape[0], nt, cap, *[float(b) for b in box],
        *[int(bool(p)) for p in periodic], float(cutoff) ** 2,
        float(g_ewald), float(qqr2e), nctas, wsp, wsp + 4 * nbuf, outp,
        outp + 4 * 3 * n, build.stream_ptr(x.device))
    build.check_status("pair_forces", status)
    launches.count += 1
    ev, ec, ecorr = out[3 * n:]
    f = out[:3 * n].view(n, 3)
    if conp_fuse is not None:
        return f, ev, ec, ecorr
    return f, ev, ec


@functools.lru_cache(maxsize=None)
def sweep_ctas(fuse: bool, m: int, items_cap: int,
               items: bool = False) -> int:
    """The persistent sweep's CTA count on the current card: the occupancy
    of the z entry's sweep (or, with ``items``, the item-list entry's) with
    the shared memory of m special partners per row, at most one CTA per 8
    items; -1 if the card refuses that memory.  Asked of the library once
    per shape: this is its only cache."""
    return build.load_library().conp2_pair_sweep_ctas(int(fuse), m,
                                                       items_cap, int(items))
