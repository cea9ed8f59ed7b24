"""Block-union Verlet pair sweep (K1): the CUDA kernel
``csrc/block_pair.cu`` and its plain PyTorch version.

Blocks of B cell-sorted atoms (``rows`` (NB, B), pad id N) sweep the
sorted-unique union of their neighbour rows (``un`` (NB, U), pad id N):
LJ 12-6 + erfc real-space Coulomb per ordered pair within the cutoff,
optionally with the CONP Gaussian correction on (electrode, electrolyte)
pairs.  Special-bond exclusions are applied per pair (LJ scaled by s, the
Coulomb term minus (1 - s) qq/r), in the kernel and in the plain version
alike: the JAX package sweeps at s = 1 and subtracts the listed pairs
afterwards, which cancels catastrophically in float32 at bonded distances.
Returns (f_slots (NB*B, 3) in slot order, sum_elj, sum_ecoul
[, sum_ecorr]) as raw sums over ordered pairs; the caller maps slots back
to atoms and applies the full-list 0.5.

``block_pair`` launches the kernel for CUDA float32 tensors, takes the
plain version for CPU tensors and raises on CUDA float64.  The plain
version is the JAX package's XLA twin (``ops/neighbors.py _block_sweep``);
its LJ and Gaussian coefficients come from the (T+1, T+1) tables by type.
"""

from __future__ import annotations

import torch

from ..erfc import A1, A2, A3, A4, A5, ERFC_MAX, EWALD_F, EWALD_P
from ..pairs import PairTables, min_image, special_factors
from . import build

launches = build.LaunchCounter("block_pair")


def block_pair_plain(x, q, type_idx, un, rows, tables: PairTables, *, box,
                     periodic, cutoff, g_ewald, qqr2e, conp_fuse=None,
                     exclusions=None, chunk=2048):
    """The sweep in plain PyTorch, ``chunk`` blocks at a time."""
    n = x.shape[0]
    dtype = x.dtype
    dev = x.device
    fuse = conp_fuse is not None
    cols = [x, q[:, None].to(dtype)]
    sent = [1e6, 1e6, 1e6, 0.0]
    if fuse:
        ele_f, ely_f, eta_tab, fo_tab = conp_fuse
        # one flag channel: +1 electrode / -1 electrolyte / 0 neither
        cols.append((ele_f - ely_f).to(dtype)[:, None])
        sent.append(0.0)
    xqp = torch.cat([torch.cat(cols, dim=1),
                     torch.tensor([sent], dtype=dtype, device=dev)])
    tp = torch.cat([type_idx.to(torch.int64),
                    torch.zeros(1, dtype=torch.int64, device=dev)])
    if exclusions is not None:
        # pad rows (id n) list nothing
        exi_p = torch.cat([exclusions[0], torch.full(
            (1, exclusions[0].shape[1]), n, dtype=torch.int64, device=dev)])
        exv_p = torch.cat([exclusions[1].to(dtype), torch.ones(
            (1, exclusions[1].shape[1]), dtype=dtype, device=dev)])
    zero = torch.zeros((), dtype=dtype, device=dev)
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
        rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
        r2inv = 1.0 / rsq_safe
        r6inv = r2inv * r2inv * r2inv
        tij = (tp[rc][:, :, None], tp[unc][:, None, :])
        l1, l2, l3, l4 = (t[tij] for t in tables)
        si = (torch.ones_like(rsq) if exclusions is None
              else special_factors(exi_p[rc], exv_p[rc], unc[:, None, :],
                                   dtype))
        lj_on = mask & (si > 0.0)
        flj = torch.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv, zero)
        elj = torch.where(lj_on, si * r6inv * (l3 * r6inv - l4), zero)
        r = torch.sqrt(rsq_safe)
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        tt = 1.0 / (1.0 + EWALD_P * grij)
        erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
        qq = xqi[:, :, None, 3] * xqu[:, None, :, 3]
        pref = qqr2e * qq / r
        dcoul = (1.0 - si) * pref
        fcoul = torch.where(mask, pref * (erfc + EWALD_F * grij * expm2)
                            - dcoul, zero)
        ecoul = torch.where(mask, pref * erfc - dcoul, zero)
        fpair = flj + fcoul * r2inv
        if fuse:
            etap, fop = eta_tab[tij], fo_tab[tij]
            cm = mask & ((xqi[:, :, None, 4] * xqu[:, None, :, 4]) < 0.0)
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
            fkc = e2 * gexp - torch.where(inmax, erfcr + EWALD_F * em2,
                                          zero) * etap
            cpref = qqr2e * qq
            ecp_s = ecp_s + torch.sum(torch.where(cm, cpref * ekc, zero))
            fpair = fpair + torch.where(cm, cpref * fkc, zero) * r2inv
        fs.append(torch.sum(fpair[..., None] * d, dim=2).reshape(-1, 3))
        elj_s = elj_s + torch.sum(elj)
        ec_s = ec_s + torch.sum(ecoul)
    f_slots = torch.cat(fs)
    if fuse:
        return f_slots, elj_s, ec_s, ecp_s
    return f_slots, elj_s, ec_s


def block_pair(x, q, type_idx, un, rows, tables: PairTables, *, box,
               periodic, cutoff, g_ewald, qqr2e, conp_fuse=None,
               exclusions=None):
    """The block sweep: K1 for CUDA float32 tensors, the plain version for
    CPU tensors.  ``conp_fuse``: optional (ele_f, ely_f, eta_tab, fo_tab),
    per-atom 0/1 float flags (N,) and (T+1, T+1) tables; a fourth value
    ``sum_ecorr`` is then returned and the forces include the correction.
    ``exclusions``: (excl_idx (N, m) int64 padded with N, excl_val (N, m))
    with m <= 16, or None."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff, g_ewald=g_ewald,
              qqr2e=qqr2e)
    if x.device.type == "cpu":
        return block_pair_plain(x, q, type_idx, un, rows, tables,
                                conp_fuse=conp_fuse, exclusions=exclusions,
                                **kw)
    n = x.shape[0]
    nb, usz = un.shape
    bsz = rows.shape[1]
    lj = torch.stack(tuple(tables)).contiguous()
    nt1 = lj.shape[1]
    build.check_cuda("block_pair", torch.float32, x, q, lj)
    build.check_cuda("block_pair", torch.int64, type_idx, un, rows)
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
    lib = build.load_library()
    f = torch.empty((nb * bsz, 3), dtype=x.dtype, device=x.device)
    partials = torch.empty((nb, 3), dtype=x.dtype, device=x.device)
    sums = torch.empty((3,), dtype=x.dtype, device=x.device)
    status = lib.conp2_block_pair_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ptrs[0], ptrs[1],
        un.data_ptr(), rows.data_ptr(), lj.data_ptr(), ptrs[2],
        None if exi is None else exi.data_ptr(),
        None if exv is None else exv.data_ptr(), m, n, nb, bsz,
        usz, nt1, *[float(b) for b in box], *[int(bool(p)) for p in periodic],
        float(cutoff) ** 2, float(g_ewald), float(qqr2e), f.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), build.stream_ptr())
    build.check_status("block_pair", status)
    launches.count += 1
    if conp_fuse is not None:
        return f, sums[0], sums[1], sums[2]
    return f, sums[0], sums[1]
