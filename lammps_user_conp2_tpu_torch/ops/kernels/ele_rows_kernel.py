"""The electrode-row sweeps: the CUDA kernels of ``csrc/ele_rows_kernel.cu``
and their plain PyTorch versions.

K5, the electrode b-vector real-space rows:

    b_i = -sum_{electrolyte j, r^2 < cut_coulsq} q_j (erfc(g r)/r + pot(r^2))
    pot(r^2) = fo * exp(-e2/2) - erfcr(e2) * eta,   e2 = eta^2 r^2

with per-electrode-row tables eta_rows/fo_rows (Ne, T+1) indexed by the
column type (ETA mode: uniform eta, fo = 0; fix_conp.cpp:1281-1365).

K6, the CONP Gaussian correction swept on its own (the engine's unfused
dense branch, ``MDConfig.use_pallas_pair=False``): forces on the electrode
rows and their Newton reactions on the electrolyte, and the correction
energy, over (electrode, electrolyte) pairs within the cutoff, with eta and
fo from the (T+1, T+1) type tables (fix_conp.cpp:1368-1444).

``b_realspace`` and ``conp_correction`` launch their kernels for CUDA
float32 tensors and take the plain versions for CPU and CUDA float64
tensors (``build.kernel_route``).  Neither
kernel has a fixed capacity: every row searches its own z window, so
nothing can overflow.  K5's windows hold electrolyte columns only: its
first kernel compacts the shared z order to the electrolyte
(``elyte_order``).  K6's first kernel compacts it into the electrolyte's
and the electrodes' orders (``corr_orders``): its electrode rows search
the one, its electrolyte rows the other, within the correction's own range
(``correction_range``), beyond which every term is exactly 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..erfc import ERFC_MAX, erfcr_sqrt
from ..pairs import conp_correction_forces, gauss_table_kernels, min_image
from . import build
from .zorder import Z_MARGIN, z_perm

launches = build.LaunchCounter("b_realspace")
corr_launches = build.LaunchCounter("conp_correction")


def b_realspace_plain(x, q_elyte, ele_idx, elyte_mask_f, eta_rows, fo_rows,
                      type_idx, *, box, periodic, cut_coulsq, g_ewald,
                      block=512):
    """Dense electrode rows (the JAX package's conp.py b_vector_full dense
    branch), swept in blocks of ``block`` electrodes.  Returns (Ne,)."""
    out = []
    elyte = elyte_mask_f > 0
    for e0 in range(0, ele_idx.shape[0], block):
        eb = ele_idx[e0:e0 + block]
        dx = min_image(x[eb][:, None, :] - x[None, :, :], box, periodic)
        rsq = torch.sum(dx * dx, dim=-1)
        mask = elyte[None, :] & (rsq < cut_coulsq)
        rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
        et = eta_rows[e0:e0 + block][:, type_idx]
        fo = fo_rows[e0:e0 + block][:, type_idx]
        e2 = et * et * rsq_safe
        pot = fo * torch.exp(-0.5 * e2) - erfcr_sqrt(e2) * et
        dudq = erfcr_sqrt(g_ewald * g_ewald * rsq_safe) * g_ewald + pot
        out.append(-torch.sum(torch.where(mask, dudq, torch.zeros_like(dudq))
                              * q_elyte[None, :], dim=1))
    return torch.cat(out)


def elyte_order_plain(perm, zs, elyte_mask_f):
    """The electrolyte's z order: the entries of the full z order (perm,
    zs) whose atom has elyte_mask_f > 0, in the same order -- the plain
    version of K5's first kernel (``b_order_kernel``)."""
    keep = elyte_mask_f[perm] > 0
    return perm[keep], zs[keep]


def elyte_order(perm, zs, elyte_mask_f):
    """``elyte_order_plain`` for CPU and CUDA float64 keys; for CUDA float32
    keys K5's first kernel alone (``b_realspace`` runs it inside its
    launch), returning int32 atom indices and the float32 keys, cut to
    their count (one host sync: a test entry, not the step's)."""
    if not build.kernel_route("elyte_order", zs):
        return elyte_order_plain(perm, zs, elyte_mask_f)
    build.check_cuda("elyte_order", torch.float32, zs, elyte_mask_f)
    build.check_cuda("elyte_order", torch.int64, perm)
    n = perm.shape[0]
    order = torch.empty(2 * n + 1, dtype=torch.int32, device=perm.device)
    build.check_status("elyte_order", build.load_library().conp2_b_order_i32(
        perm.data_ptr(), zs.data_ptr(), elyte_mask_f.data_ptr(), n,
        order.data_ptr(), build.stream_ptr(perm.device)))
    m = int(order[2 * n])
    return order[:m], order[n:2 * n].view(torch.float32)[:m]


def b_realspace(x, q_elyte, ele_idx, elyte_mask_f, eta_rows, fo_rows,
                type_idx, *, box, periodic, cut_coulsq, g_ewald, zsort=None):
    """Real-space b rows (Ne,) for the electrodes ``ele_idx``.

    x (N,3); q_elyte (N,) charges with the electrodes zeroed; elyte_mask_f
    (N,) 1.0 = electrolyte; eta_rows/fo_rows (Ne, T+1); type_idx (N,) int64.
    ``zsort``: (perm, z_sorted) from ``zorder.z_perm`` at these positions
    (computed here when None); the launch compacts it to the electrolyte
    by ``elyte_mask_f`` on the device (``elyte_order``), so the rows'
    windows hold electrolyte columns only, in any layout of the atoms.
    K5 for CUDA float32 tensors, the plain version for CPU and CUDA
    float64 tensors."""
    kw = dict(box=box, periodic=periodic, cut_coulsq=cut_coulsq,
              g_ewald=g_ewald)
    if not build.kernel_route("b_realspace", x):
        return b_realspace_plain(x, q_elyte, ele_idx, elyte_mask_f, eta_rows,
                                 fo_rows, type_idx, **kw)
    n = x.shape[0]
    ne = ele_idx.shape[0]
    nt1 = eta_rows.shape[1]
    if zsort is None:
        zsort = z_perm(x, box, periodic)
    perm, zs = zsort
    build.check_cuda("b_realspace", torch.float32, x, q_elyte, elyte_mask_f,
                     eta_rows, fo_rows, zs)
    build.check_cuda("b_realspace", torch.int64, ele_idx, type_idx, perm)
    if (x.shape != (n, 3) or q_elyte.shape != (n,)
            or elyte_mask_f.shape != (n,) or type_idx.shape != (n,)
            or perm.shape != (n,) or zs.shape != (n,)):
        raise ValueError("b_realspace: expected x (N,3) and charges, masks, "
                         "types, perm, z keys (N,)")
    if eta_rows.shape != (ne, nt1) or fo_rows.shape != (ne, nt1):
        raise ValueError("b_realspace: eta_rows/fo_rows must be (Ne, T+1)")
    # the workspace of the electrolyte's order: atom indices, keys, count
    order = torch.empty(2 * n + 1, dtype=torch.int32, device=x.device)
    b = torch.empty((ne,), dtype=x.dtype, device=x.device)
    lib = build.load_library()
    status = lib.conp2_b_realspace_f32(
        x.data_ptr(), q_elyte.data_ptr(), ele_idx.data_ptr(),
        elyte_mask_f.data_ptr(), eta_rows.data_ptr(), fo_rows.data_ptr(),
        type_idx.data_ptr(), perm.data_ptr(), zs.data_ptr(), n, ne, nt1,
        *[float(v) for v in box], *[int(bool(p)) for p in periodic],
        float(cut_coulsq), math.sqrt(float(cut_coulsq)) + Z_MARGIN,
        float(g_ewald), order.data_ptr(), b.data_ptr(),
        build.stream_ptr(x.device))
    build.check_status("b_realspace", status)
    launches.count += 1
    return b


# relative margin of the correction's range beyond ERFC_MAX / eta: far
# above float32 rounding of eta and r^2 (~1e-7), so a pair the kernel
# leaves out has eta^2 r^2 >= ERFC_MAX^2 in float32 too
R_CORR_MARGIN = 1e-5


def correction_range(eta_tab, fo_tab, ele_types, ely_types, cutoff) -> float:
    """r_corr, the distance beyond which every correction term between the
    electrode types ``ele_types`` and the electrolyte types ``ely_types``
    is exactly 0, in float64 from the (T+1, T+1) host tables: with every
    such fo 0 (ETA widths) the terms carry the erfc clamp alone, 0 once
    eta^2 r^2 >= ERFC_MAX^2, so r_corr = min(cutoff, ERFC_MAX / eta_min)
    (1 + R_CORR_MARGIN); otherwise (EHGO's overlap term has no clamp) the
    cutoff."""
    cutoff = float(cutoff)
    ix = np.ix_(np.asarray(ele_types, np.int64),
                np.asarray(ely_types, np.int64))
    eta = np.asarray(eta_tab, np.float64)[ix]
    fo = np.asarray(fo_tab, np.float64)[ix]
    if eta.size == 0 or np.any(fo != 0.0) or not np.all(eta > 0.0):
        return cutoff
    return min(cutoff, ERFC_MAX / float(eta.min()) * (1.0 + R_CORR_MARGIN))


def conp_correction_plain(x, q, type_idx, ele_idx, ele_f, ely_f, eta_tab,
                          fo_tab, *, box, periodic, cutoff, qqr2e):
    """The electrode-row sweep of ``ops/pairs.conp_correction_forces`` with
    the table kernels (the JAX package's XLA branch), over every pair
    within the full ``cutoff``.  ``ele_f`` is not read: the rows are
    ``ele_idx``."""
    potential, force = gauss_table_kernels(eta_tab, fo_tab)
    return conp_correction_forces(x, q, ele_idx, ely_f > 0, force, potential,
                                  type_idx, box=box, periodic=periodic,
                                  cutoff=cutoff, qqr2e=qqr2e)


def corr_orders(perm, zs, ely_f, ele_f):
    """K6's first kernel alone on CUDA float32 keys: ((electrolyte atom
    indices, keys), (electrode atom indices, keys)), each cut to its count
    (one host sync: a test entry, not the step's); ``elyte_order_plain``
    with each flag for CPU and CUDA float64 keys."""
    if not build.kernel_route("corr_orders", zs):
        return (elyte_order_plain(perm, zs, ely_f),
                elyte_order_plain(perm, zs, ele_f))
    build.check_cuda("corr_orders", torch.float32, zs, ely_f, ele_f)
    build.check_cuda("corr_orders", torch.int64, perm)
    n = perm.shape[0]
    order = torch.empty(4 * n + 2, dtype=torch.int32, device=perm.device)
    build.check_status("corr_orders", build.load_library().conp2_corr_order_i32(
        perm.data_ptr(), zs.data_ptr(), ely_f.data_ptr(), ele_f.data_ptr(), n,
        order.data_ptr(), build.stream_ptr(perm.device)))
    ml, me = (int(c) for c in order[4 * n:].cpu())
    keys = order[:4 * n].view(torch.float32)
    return ((order[:ml], keys[n:n + ml]),
            (order[2 * n:2 * n + me], keys[3 * n:3 * n + me]))


# K6's scratch (the two z orders and the per-block energies) per (device,
# N, Ne), allocated at the first call and reused
_CORR_SCRATCH = {}


def conp_correction(x, q, type_idx, ele_idx, ele_f, ely_f, eta_tab, fo_tab, *,
                    box, periodic, cutoff, qqr2e, zsort=None, r_corr=None,
                    gtab=None):
    """CONP Gaussian correction over (electrode, electrolyte) pairs within
    ``cutoff``: (f (N, 3), ecorr).  K6 for CUDA float32 tensors, the plain
    version (which sweeps the full cutoff) for CPU and CUDA float64
    tensors.

    x (N,3); q (N,); type_idx (N,) int64; ele_idx (Ne,) int64 the electrode
    rows; ele_f / ely_f (N,) 0/1 float flags of the electrodes (the rows of
    ``ele_idx``) and the electrolyte; eta_tab / fo_tab (T+1, T+1).
    ``zsort``: (perm, z_sorted) from ``zorder.z_perm`` at these positions
    (computed here when None).  ``r_corr``: the range beyond which every
    term is 0 (``correction_range``; None: the cutoff), which K6 searches
    instead of the cutoff.  ``gtab``: eta_tab and fo_tab stacked
    (2, T+1, T+1), as the engine keeps them (None: stacked here)."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff, qqr2e=qqr2e)
    if not build.kernel_route("conp_correction", x):
        return conp_correction_plain(x, q, type_idx, ele_idx, ele_f, ely_f,
                                     eta_tab, fo_tab, **kw)
    n = x.shape[0]
    ne = ele_idx.shape[0]
    if gtab is None:
        gtab = torch.stack([eta_tab, fo_tab]).contiguous()
    nt1 = gtab.shape[1]
    rc = float(cutoff) if r_corr is None else min(float(r_corr),
                                                  float(cutoff))
    if zsort is None:
        zsort = z_perm(x, box, periodic)
    perm, zs = zsort
    build.check_cuda("conp_correction", torch.float32, x, q, ele_f, ely_f,
                     gtab, zs)
    build.check_cuda("conp_correction", torch.int64, type_idx, ele_idx, perm)
    if (x.shape != (n, 3) or q.shape != (n,) or type_idx.shape != (n,)
            or ele_f.shape != (n,) or ely_f.shape != (n,)
            or perm.shape != (n,) or zs.shape != (n,)):
        raise ValueError("conp_correction: expected x (N,3) and charges, "
                         "types, flags, perm, z keys (N,)")
    if gtab.shape != (2, nt1, nt1) or ne == 0:
        raise ValueError("conp_correction: tables must be (T+1, T+1) and "
                         "the electrode rows non-empty")
    lib = build.load_library()
    key = (str(x.device), n, ne)
    if key not in _CORR_SCRATCH:
        nblk = -(-ne // lib.conp2_corr_rows())
        _CORR_SCRATCH[key] = torch.empty(4 * n + 2 + nblk, dtype=torch.int32,
                                         device=x.device)
    scratch = _CORR_SCRATCH[key]
    f = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
    ecorr = torch.empty((1,), dtype=x.dtype, device=x.device)
    status = lib.conp2_conp_correction_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ele_idx.data_ptr(),
        ele_f.data_ptr(), ely_f.data_ptr(), gtab.data_ptr(), perm.data_ptr(),
        zs.data_ptr(), n, ne, nt1, *[float(v) for v in box],
        *[int(bool(p)) for p in periodic], rc * rc, rc + Z_MARGIN,
        float(qqr2e), scratch.data_ptr(), f.data_ptr(),
        scratch[4 * n + 2:].data_ptr(), ecorr.data_ptr(), build.stream_ptr())
    build.check_status("conp_correction", status)
    corr_launches.count += 1
    return f, ecorr[0]
