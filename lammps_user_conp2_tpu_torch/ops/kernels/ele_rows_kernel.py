"""Electrode b-vector real-space rows: the CUDA kernel
``csrc/ele_rows_kernel.cu`` and its plain PyTorch version.

    b_i = -sum_{electrolyte j, r^2 < cut_coulsq} q_j (erfc(g r)/r + pot(r^2))
    pot(r^2) = fo * exp(-e2/2) - erfcr(e2) * eta,   e2 = eta^2 r^2

with per-electrode-row tables eta_rows/fo_rows (Ne, T+1) indexed by the
column type (ETA mode: uniform eta, fo = 0; fix_conp.cpp:1281-1365).

``b_realspace`` launches the kernel for CUDA float32 tensors and takes
``b_realspace_plain`` for CPU tensors.  The kernel has no fixed capacity:
every electrode row searches its own z window, so nothing can overflow.
"""

from __future__ import annotations

import math

import torch

from ..erfc import erfcr_sqrt
from ..pairs import min_image
from . import build
from .zorder import Z_MARGIN, z_perm

launches = build.LaunchCounter("b_realspace")


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


def b_realspace(x, q_elyte, ele_idx, elyte_mask_f, eta_rows, fo_rows,
                type_idx, *, box, periodic, cut_coulsq, g_ewald, zsort=None):
    """Real-space b rows (Ne,) for the electrodes ``ele_idx``.

    x (N,3); q_elyte (N,) charges with the electrodes zeroed; elyte_mask_f
    (N,) 1.0 = electrolyte; eta_rows/fo_rows (Ne, T+1); type_idx (N,) int64.
    ``zsort``: (perm, z_sorted) from ``zorder.z_perm`` at these positions
    (computed here when None)."""
    kw = dict(box=box, periodic=periodic, cut_coulsq=cut_coulsq,
              g_ewald=g_ewald)
    if x.device.type == "cpu":
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
    b = torch.empty((ne,), dtype=x.dtype, device=x.device)
    lib = build.load_library()
    status = lib.conp2_b_realspace_f32(
        x.data_ptr(), q_elyte.data_ptr(), ele_idx.data_ptr(),
        elyte_mask_f.data_ptr(), eta_rows.data_ptr(), fo_rows.data_ptr(),
        type_idx.data_ptr(), perm.data_ptr(), zs.data_ptr(), n, ne, nt1,
        *[float(v) for v in box], *[int(bool(p)) for p in periodic],
        float(cut_coulsq), math.sqrt(float(cut_coulsq)) + Z_MARGIN,
        float(g_ewald), b.data_ptr(), build.stream_ptr())
    build.check_status("b_realspace", status)
    launches.count += 1
    return b
