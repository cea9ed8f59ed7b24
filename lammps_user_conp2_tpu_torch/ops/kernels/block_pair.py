"""Block-union Verlet pair sweep (K1): the CUDA kernels
``csrc/block_pair.cu`` and their plain PyTorch versions.

Blocks of B cell-sorted atoms (``rows`` (NB, B), pad id N) sweep the
sorted-unique union of their neighbour rows (``un`` (NB, U) int32, pad id
N):
LJ 12-6 + erfc real-space Coulomb per ordered pair within the cutoff,
optionally with the CONP Gaussian correction on (electrode, electrolyte)
pairs.  Special-bond exclusions are applied per pair (LJ scaled by s, the
Coulomb term minus (1 - s) qq/r), in the kernel and in the plain version
alike: the JAX package sweeps at s = 1 and subtracts the listed pairs
afterwards, which cancels catastrophically in float32 at bonded distances.
Returns (f_slots (NB*B, 3) in slot order, sum_elj, sum_ecoul
[, sum_ecorr]) as raw sums over ordered pairs; the caller maps slots back
to atoms and applies the full-list 0.5.

``block_pair`` launches the kernels for CUDA float32 tensors and takes the
plain version for CPU and CUDA float64 tensors (``build.kernel_route``).  The plain
version is the JAX package's XLA twin (``ops/neighbors.py _block_sweep``);
its LJ and Gaussian coefficients come from the (T+1, T+1) tables by type.

The kernel's pieces have plain versions of their own, which the CPU tests
hold against ``block_pair_plain``: ``pack_rows_plain`` (the 32-byte row per
atom the sweep reads), ``block_segments`` (the work items: a block and a
segment of its union), ``pair_queue_plain`` (the order in which the test
phase queues the in-range pairs, and so the lane that evaluates each) and
``block_pair_queue_plain`` (the sweep evaluated over that queue and summed
as the kernel sums it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..erfc import A1, A2, A3, A4, A5, ERFC_MAX, EWALD_F, EWALD_P
from ..pairs import PairTables, min_image, special_factors
from . import build

launches = build.LaunchCounter("block_pair")

B = 8                     # block atoms
CHUNK = 32                # union members tested per warp step (one per lane)
# sweep work items (one warp each) aimed for: blocks are split into union
# segments until about this many items exist, unless the blocks alone give
# half of it (two waves of 32 resident warps on 132 SMs)
SWEEP_ITEMS_TARGET = 16384
ITEMS_PER_CTA = 4         # warps of the sweep's CTAs (csrc BP_WPC)


def block_segments(nb: int, usz: int):
    """(seg, nseg): each block's union is swept as nseg work items of seg
    chunks of 32 members."""
    nchunk = -(-usz // CHUNK)
    nseg = (1 if nb >= SWEEP_ITEMS_TARGET // 2
            else min(nchunk, -(-SWEEP_ITEMS_TARGET // nb)))
    seg = -(-nchunk // nseg)
    return seg, -(-nchunk // seg)


def _flags(conp_flags, n, dev):
    """+1 electrode / -1 electrolyte / 0 per atom, int32: the sign of
    ele_f - ely_f, whose products the correction mask tests."""
    if conp_flags is None:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    return torch.sign(conp_flags[0] - conp_flags[1]).to(torch.int32)


def pack_rows_plain(x, q, type_idx, conp_flags=None):
    """The sweep's packed row per atom: ((x, y, z, q) (N, 4) in x's dtype,
    (type, flag, 0, 0) (N, 4) int32).  ``conp_flags``: (ele_f, ely_f) or
    None (flag 0)."""
    n = x.shape[0]
    xq = torch.cat([x, q[:, None].to(x.dtype)], dim=1)
    z = torch.zeros(n, dtype=torch.int32, device=x.device)
    tf = torch.stack([type_idx.to(torch.int32),
                      _flags(conp_flags, n, x.device), z, z], dim=1)
    return xq, tf


def pack_rows(x, q, type_idx, conp_flags=None):
    """The packed rows: the kernel ``block_pack_kernel`` alone for CUDA
    float32 tensors (as views of its (N, 8) float32 buffer), the plain
    version for CPU and CUDA float64 tensors."""
    if not build.kernel_route("pack_rows", x):
        return pack_rows_plain(x, q, type_idx, conp_flags)
    n = x.shape[0]
    build.check_cuda("pack_rows", torch.float32, x, q)
    build.check_cuda("pack_rows", torch.int64, type_idx)
    ptrs = [None, None]
    if conp_flags is not None:
        build.check_cuda("pack_rows", torch.float32, *conp_flags)
        ptrs = [f.data_ptr() for f in conp_flags]
    pk = torch.empty((n, 8), dtype=torch.float32, device=x.device)
    status = build.load_library().conp2_block_pack_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), *ptrs, n,
        pk.data_ptr(), build.stream_ptr())
    build.check_status("pack_rows", status)
    return pk[:, :4], pk.view(torch.int32)[:, 4:]


def _pair_terms(rsq, mask, qq, lj, si, corr, *, g_ewald, qqr2e):
    """Per-pair (fpair, elj, ecoul, ecorr) of the sweep, 0 outside
    ``mask``: LJ from the coefficients ``lj`` = (l1, l2, l3, l4), the A&S
    erfc Coulomb with the special-bond factor ``si``, and, with ``corr`` =
    (eta, fo, cmask), the Gaussian correction on ``cmask`` (ecorr is None
    without it).  Every argument broadcasts against ``rsq``."""
    zero = torch.zeros((), dtype=rsq.dtype, device=rsq.device)
    rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    l1, l2, l3, l4 = lj
    lj_on = mask & (si > 0.0)
    flj = torch.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv, zero)
    elj = torch.where(lj_on, si * r6inv * (l3 * r6inv - l4), zero)
    r = torch.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = torch.exp(-grij * grij)
    tt = 1.0 / (1.0 + EWALD_P * grij)
    erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
    pref = qqr2e * qq / r
    dcoul = (1.0 - si) * pref
    fcoul = torch.where(mask, pref * (erfc + EWALD_F * grij * expm2) - dcoul,
                        zero)
    ecoul = torch.where(mask, pref * erfc - dcoul, zero)
    fpair = flj + fcoul * r2inv
    if corr is None:
        return fpair, elj, ecoul, None
    etap, fop, cm = corr
    e2 = etap * etap * rsq_safe
    ghalf = torch.exp(-0.5 * e2)
    em2 = ghalf * ghalf
    safe = torch.clamp(e2, min=1e-30)
    rs = torch.rsqrt(safe)
    ar = safe * rs
    t2 = 1.0 / (1.0 + EWALD_P * ar)
    erfcr = (t2 * (A1 + t2 * (A2 + t2 * (A3 + t2 * (A4 + t2 * A5))))
             * em2 * rs)
    inmax = e2 < ERFC_MAX ** 2
    erfcr = torch.where(inmax, erfcr, zero)
    gexp = fop * ghalf
    ekc = gexp - erfcr * etap
    fkc = e2 * gexp - torch.where(inmax, erfcr + EWALD_F * em2, zero) * etap
    cpref = qqr2e * qq
    ecorr = torch.where(cm, cpref * ekc, zero)
    return fpair + torch.where(cm, cpref * fkc, zero) * r2inv, elj, ecoul, ecorr


def _padded(x, q, type_idx, conp_fuse, exclusions):
    """Per-atom columns with one pad row (id N) appended: xq (N+1, 4 or 5;
    the flag difference last when fused), types (N+1,), exclusions."""
    n = x.shape[0]
    dtype = x.dtype
    dev = x.device
    cols = [x, q[:, None].to(dtype)]
    if conp_fuse is not None:
        # one flag channel: +1 electrode / -1 electrolyte / 0 neither
        cols.append((conp_fuse[0] - conp_fuse[1]).to(dtype)[:, None])
    # the pad row (1e6, 1e6, 1e6, 0[, 0]), filled on the device
    sent = torch.zeros((1, len(cols) + 2), dtype=dtype, device=dev)
    sent[:, :3] = 1e6
    xqp = torch.cat([torch.cat(cols, dim=1), sent])
    tp = torch.cat([type_idx.to(torch.int64),
                    torch.zeros(1, dtype=torch.int64, device=dev)])
    exp = None
    if exclusions is not None:
        # pad rows (id n) list nothing
        exp = (torch.cat([exclusions[0], torch.full(
                   (1, exclusions[0].shape[1]), n, dtype=torch.int64,
                   device=dev)]),
               torch.cat([exclusions[1].to(dtype), torch.ones(
                   (1, exclusions[1].shape[1]), dtype=dtype, device=dev)]))
    return xqp, tp, exp


def block_pair_plain(x, q, type_idx, un, rows, tables: PairTables, *, box,
                     periodic, cutoff, g_ewald, qqr2e, conp_fuse=None,
                     exclusions=None, chunk=2048):
    """The sweep in plain PyTorch, ``chunk`` blocks at a time."""
    n = x.shape[0]
    dtype = x.dtype
    fuse = conp_fuse is not None
    xqp, tp, exp = _padded(x, q, type_idx, conp_fuse, exclusions)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    fs = []
    elj_s = ec_s = ecp_s = zero
    for b0 in range(0, un.shape[0], chunk):
        unc, rc = un[b0:b0 + chunk], rows[b0:b0 + chunk]
        xqu, xqi = xqp[unc], xqp[rc]                     # (nb, U, C), (nb, B, C)
        d = min_image(xqi[:, :, None, :3] - xqu[:, None, :, :3], box,
                      periodic)
        # ((dx^2 + dy^2) + dz^2), the kernel's order: both agree on the
        # pair set even where a lattice spacing equals the cutoff
        rsq = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
               + d[..., 2] * d[..., 2])                  # (nb, B, U)
        mask = ((unc[:, None, :] != rc[:, :, None]) & (unc[:, None, :] < n)
                & (rc[:, :, None] < n) & (rsq < cutoff ** 2))
        tij = (tp[rc][:, :, None], tp[unc][:, None, :])
        si = (torch.ones_like(rsq) if exclusions is None
              else special_factors(exp[0][rc], exp[1][rc], unc[:, None, :],
                                   dtype))
        corr = None
        if fuse:
            cm = mask & ((xqi[:, :, None, 4] * xqu[:, None, :, 4]) < 0.0)
            corr = (conp_fuse[2][tij], conp_fuse[3][tij], cm)
        fpair, elj, ecoul, ecorr = _pair_terms(
            rsq, mask, xqi[:, :, None, 3] * xqu[:, None, :, 3],
            tuple(t[tij] for t in tables), si, corr, g_ewald=g_ewald,
            qqr2e=qqr2e)
        fs.append(torch.sum(fpair[..., None] * d, dim=2).reshape(-1, 3))
        elj_s = elj_s + torch.sum(elj)
        ec_s = ec_s + torch.sum(ecoul)
        if fuse:
            ecp_s = ecp_s + torch.sum(ecorr)
    f_slots = torch.cat(fs)
    if fuse:
        return f_slots, elj_s, ec_s, ecp_s
    return f_slots, elj_s, ec_s


def pair_queue_plain(x, un, rows, *, box, periodic, cutoff, seg, nseg):
    """The kernel's pair queue: every in-range (block atom, union member)
    pair in the order the test phase appends it to its work item's queue
    (union chunk, then lane, then block atom), as int64 numpy arrays
    (item, b, k, e): item = block * nseg + chunk // seg, b the block atom,
    k the member's union index, e the entry's place in its item's queue;
    lane e % 32 of batch e // 32 evaluates it.  The in-range test is the
    plain version's (minimum image, ((dx^2 + dy^2) + dz^2) < cutoff^2)."""
    n = x.shape[0]
    nb, usz = un.shape
    xp = torch.cat([x, torch.zeros((1, 3), dtype=x.dtype, device=x.device)])
    d = min_image(xp[rows][:, :, None, :] - xp[un][:, None, :, :], box,
                  periodic)
    rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    inr = ((un[:, None, :] != rows[:, :, None]) & (un[:, None, :] < n)
           & (rows[:, :, None] < n) & (rsq < cutoff ** 2)).cpu().numpy()
    blk, b, k = np.nonzero(inr)
    c = k // CHUNK
    order = np.lexsort((b, k % CHUNK, c, blk))
    blk, b, k, c = blk[order], b[order], k[order], c[order]
    item = blk * nseg + c // seg
    # the place in the item's queue: the count of earlier entries of the
    # same item
    start = np.searchsorted(item, item, side="left")
    return item, b, k, np.arange(item.shape[0]) - start


def block_pair_queue_plain(x, q, type_idx, un, rows, tables: PairTables, *,
                           box, periodic, cutoff, g_ewald, qqr2e,
                           conp_fuse=None, exclusions=None, seg=None,
                           nseg=None):
    """The sweep as the kernel evaluates and sums it: the pairs of
    ``pair_queue_plain``, each added to the force partial of its (item,
    block atom, lane) in queue order; the 32 lane partials of (atom, axis)
    summed from lane (3 atom + axis) on, cyclically; the items of a block in
    item order; the energies per lane, then over lanes and items.  Returns
    what ``block_pair_plain`` returns.  ``seg``/``nseg`` default to
    ``block_segments``."""
    n = x.shape[0]
    nb, usz = un.shape
    if seg is None:
        seg, nseg = block_segments(nb, usz)
    dtype = x.dtype
    dev = x.device
    item, b, k, e = pair_queue_plain(x, un, rows, box=box, periodic=periodic,
                                     cutoff=cutoff, seg=seg, nseg=nseg)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    item, b, k, e = t(item), t(b), t(k), t(e)
    blk = item // nseg
    i, j = rows[blk, b], un[blk, k]
    xqp, tp, exp = _padded(x, q, type_idx, conp_fuse, exclusions)
    d = min_image(xqp[i, :3] - xqp[j, :3], box, periodic)
    rsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    mask = torch.ones_like(rsq, dtype=torch.bool)
    tij = (tp[i], tp[j])
    si = (torch.ones_like(rsq) if exclusions is None
          else special_factors(exp[0][i], exp[1][i], j[:, None], dtype)[:, 0])
    corr = None
    if conp_fuse is not None:
        corr = (conp_fuse[2][tij], conp_fuse[3][tij],
                xqp[i, 4] * xqp[j, 4] < 0.0)
    fpair, elj, ecoul, ecorr = _pair_terms(
        rsq, mask, xqp[i, 3] * xqp[j, 3], tuple(tb[tij] for tb in tables),
        si, corr, g_ewald=g_ewald, qqr2e=qqr2e)
    nitem = nb * nseg
    lane = e % CHUNK
    facc = torch.zeros((nitem * B * CHUNK, 3), dtype=dtype, device=dev)
    facc.index_add_(0, (item * B + b) * CHUNK + lane, fpair[:, None] * d)
    facc = facc.reshape(nitem, B, CHUNK, 3).permute(0, 1, 3, 2)
    rot = (torch.arange(CHUNK, device=dev)[None, None, :]
           + torch.arange(3 * B, device=dev).reshape(B, 3, 1)) % CHUNK
    f_item = torch.gather(facc, 3, rot.expand(nitem, B, 3, CHUNK)).sum(3)
    f_slots = f_item.reshape(nb, nseg, B, 3).sum(1).reshape(nb * B, 3)
    out = [f_slots]
    for v in (elj, ecoul) + ((ecorr,) if conp_fuse is not None else ()):
        acc = torch.zeros(nitem * CHUNK, dtype=dtype, device=dev)
        acc.index_add_(0, item * CHUNK + lane, v)
        out.append(acc.sum())
    return tuple(out)


def block_pair(x, q, type_idx, un, rows, tables: PairTables, *, box,
               periodic, cutoff, g_ewald, qqr2e, conp_fuse=None,
               exclusions=None):
    """The block sweep: K1 for CUDA float32 tensors, the plain version for
    CPU and CUDA float64 tensors.  ``conp_fuse``: optional (ele_f, ely_f, eta_tab, fo_tab),
    per-atom 0/1 float flags (N,) and (T+1, T+1) tables; a fourth value
    ``sum_ecorr`` is then returned and the forces include the correction.
    ``exclusions``: (excl_idx (N, m) int64 padded with N, excl_val (N, m))
    with m <= 16, or None."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff, g_ewald=g_ewald,
              qqr2e=qqr2e)
    if not build.kernel_route("block_pair", x):
        return block_pair_plain(x, q, type_idx, un, rows, tables,
                                conp_fuse=conp_fuse, exclusions=exclusions,
                                **kw)
    n = x.shape[0]
    nb, usz = un.shape
    bsz = rows.shape[1]
    lj = torch.stack(tuple(tables)).contiguous()
    nt1 = lj.shape[1]
    build.check_cuda("block_pair", torch.float32, x, q, lj)
    build.check_cuda("block_pair", torch.int64, type_idx, rows)
    build.check_cuda("block_pair", torch.int32, un)
    if x.shape != (n, 3) or q.shape != (n,) or type_idx.shape != (n,):
        raise ValueError("block_pair: expected x (N,3), q and types (N,)")
    if rows.shape != (nb, bsz) or lj.shape != (4, nt1, nt1):
        raise ValueError("block_pair: rows must be (NB, B), LJ tables "
                         "(T+1, T+1)")
    ptrs = [None, None, None]                     # ele_f, ely_f, gtab
    if conp_fuse is not None:
        ele_f, ely_f, eta_tab, fo_tab = conp_fuse
        gtab = torch.stack([eta_tab, fo_tab]).contiguous()
        build.check_cuda("block_pair", torch.float32, ele_f, ely_f, gtab)
        if (ele_f.shape != (n,) or ely_f.shape != (n,)
                or gtab.shape != (2, nt1, nt1)):
            raise ValueError("block_pair: conp_fuse flags must be (N,) and "
                             "tables (T+1, T+1)")
        ptrs = [ele_f.data_ptr(), ely_f.data_ptr(), gtab.data_ptr()]
    exi = exv = None
    m = 0
    if exclusions is not None:
        exi, exv = exclusions
        m = exi.shape[1]
        build.check_cuda("block_pair", torch.int64, exi)
        build.check_cuda("block_pair", torch.float32, exv)
        if exi.shape != (n, m) or exv.shape != (n, m) or m > 16:
            raise ValueError("block_pair: exclusions must be (N, m), m <= 16")
    seg, nseg = block_segments(nb, usz)
    lib = build.load_library()
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    f = new(nb * bsz, 3)
    pk = new(n, 8)
    part_f = new(nb * nseg, bsz * 3) if nseg > 1 else None
    partials = new(-(-nb * nseg // ITEMS_PER_CTA), 3)
    sums = new(3)
    status = lib.conp2_block_pair_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ptrs[0], ptrs[1],
        un.data_ptr(), rows.data_ptr(), lj.data_ptr(), ptrs[2],
        None if exi is None else exi.data_ptr(),
        None if exv is None else exv.data_ptr(), pk.data_ptr(),
        None if part_f is None else part_f.data_ptr(), m, n, nb, bsz,
        usz, nt1, seg, nseg, *[float(b) for b in box],
        *[int(bool(p)) for p in periodic], float(cutoff) ** 2,
        float(g_ewald), float(qqr2e), f.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), build.stream_ptr())
    build.check_status("block_pair", status)
    launches.count += 1
    if conp_fuse is not None:
        return f, sums[0], sums[1], sums[2]
    return f, sums[0], sums[1]
