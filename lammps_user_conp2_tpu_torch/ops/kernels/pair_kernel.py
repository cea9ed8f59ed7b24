"""Pair sweep (LJ + real-space Coulomb, optional fused CONP correction):
the CUDA kernel ``csrc/pair_kernel.cu`` and its plain PyTorch version.

``pair_forces`` launches the kernel for CUDA float32 tensors and takes
``pair_forces_plain`` for CPU tensors.  Same inputs and return values as
the JAX package's ``pair_forces_pallas``, except that atom types index the
(T+1, T+1) tables directly (no one-hot operands).

The kernel has no fixed capacity (it walks every column tile and culls by
z), so nothing can overflow and nothing is regrown.  Special-bond
exclusions are corrected outside the kernel, as in the JAX package: the
kernel computes the uniform s=1 sweep and ``exclusion_correction`` adds
the exact difference for the listed pairs.
"""

from __future__ import annotations

import torch

from ..pairs import (PairTables, conp_correction_forces, dense_pair_forces,
                     exclusion_correction, gauss_table_kernels)
from . import build
from .zorder import Z_MARGIN, z_perm

launches = build.LaunchCounter("pair_forces")


def pair_forces_plain(x, q, type_idx, tables: PairTables, exclusions, *, box,
                      periodic, cutoff, g_ewald, qqr2e, conp_fuse=None):
    """Dense row-blocked sweep: ``dense_pair_forces`` plus, with
    ``conp_fuse = (ele_flag, elyte_flag, eta_tab, fo_tab)``, the electrode-row
    ``conp_correction_forces``.  Returns (f, evdwl, ecoul[, ecorr])."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff)
    f, ev, ec = dense_pair_forces(x, q, type_idx, tables, exclusions,
                                  g_ewald=g_ewald, qqr2e=qqr2e, **kw)
    if conp_fuse is None:
        return f, ev, ec
    ele_f, ely_f, eta_tab, fo_tab = conp_fuse
    potential, force = gauss_table_kernels(eta_tab, fo_tab)
    ele_idx = torch.nonzero(ele_f > 0).squeeze(1)
    fc, ecorr = conp_correction_forces(x, q, ele_idx, ely_f > 0, force,
                                       potential, type_idx, qqr2e=qqr2e, **kw)
    return f + fc, ev, ec, ecorr


def pair_forces(x, q, type_idx, tables: PairTables, exclusions, *, box,
                periodic, cutoff, g_ewald, qqr2e, zsort=None, conp_fuse=None):
    """LJ + erfc Coulomb forces and energies over all pairs in range.

    ``zsort``: (perm, z_sorted) from ``zorder.z_perm`` at these positions
    (computed here when None).  ``conp_fuse``: optional (ele_flag,
    elyte_flag, eta_tab, fo_tab) -- per-atom 0/1 float flags (N,) and the
    (T+1, T+1) Gaussian width / overlap tables; the forces then include the
    CONP Gaussian correction and a fourth value ``ecorr`` is returned.
    Returns (f (N,3), evdwl, ecoul[, ecorr])."""
    kw = dict(box=box, periodic=periodic, cutoff=cutoff, g_ewald=g_ewald,
              qqr2e=qqr2e)
    if x.device.type == "cpu":
        return pair_forces_plain(x, q, type_idx, tables, exclusions,
                                 conp_fuse=conp_fuse, **kw)
    n = x.shape[0]
    lj = torch.stack(tuple(tables)).contiguous()
    nt1 = lj.shape[1]
    if zsort is None:
        zsort = z_perm(x, box, periodic)
    perm, zs = zsort
    build.check_cuda("pair_forces", torch.float32, x, q, lj, zs)
    build.check_cuda("pair_forces", torch.int64, type_idx, perm)
    if (x.shape != (n, 3) or q.shape != (n,) or type_idx.shape != (n,)
            or perm.shape != (n,) or zs.shape != (n,)):
        raise ValueError("pair_forces: expected x (N,3) and q, types, perm, "
                         "z keys (N,)")
    if lj.shape != (4, nt1, nt1):
        raise ValueError("pair_forces: LJ tables must be (T+1, T+1)")
    ptrs = [None, None, None]                     # ele_f, ely_f, gtab
    if conp_fuse is not None:
        ele_f, ely_f, eta_tab, fo_tab = conp_fuse
        gtab = torch.stack([eta_tab, fo_tab]).contiguous()
        build.check_cuda("pair_forces", torch.float32, ele_f, ely_f, gtab)
        if (ele_f.shape != (n,) or ely_f.shape != (n,)
                or gtab.shape != (2, nt1, nt1)):
            raise ValueError("pair_forces: conp_fuse flags must be (N,) and "
                             "tables (T+1, T+1)")
        ptrs = [ele_f.data_ptr(), ely_f.data_ptr(), gtab.data_ptr()]
    lib = build.load_library()
    nblocks = -(-n // lib.conp2_pair_tile_rows())
    f = torch.empty((n, 3), dtype=x.dtype, device=x.device)
    partials = torch.empty((nblocks, 3), dtype=x.dtype, device=x.device)
    energies = torch.empty((3,), dtype=x.dtype, device=x.device)
    status = lib.conp2_pair_forces_f32(
        x.data_ptr(), q.data_ptr(), type_idx.data_ptr(), ptrs[0], ptrs[1],
        perm.data_ptr(), zs.data_ptr(), lj.data_ptr(), ptrs[2], n, nt1,
        *[float(b) for b in box], *[int(bool(p)) for p in periodic],
        float(cutoff) ** 2, float(cutoff) + Z_MARGIN, float(g_ewald),
        float(qqr2e), f.data_ptr(), partials.data_ptr(), energies.data_ptr(),
        build.stream_ptr())
    build.check_status("pair_forces", status)
    launches.count += 1
    ev, ec = energies[0], energies[1]
    if exclusions is not None:
        df, dev, dec = exclusion_correction(x, q, type_idx, tables, exclusions,
                                            box=box, periodic=periodic,
                                            cutoff=cutoff, qqr2e=qqr2e)
        f, ev, ec = f + df, ev + dev, ec + dec
    if conp_fuse is not None:
        return f, ev, ec, energies[2]
    return f, ev, ec
