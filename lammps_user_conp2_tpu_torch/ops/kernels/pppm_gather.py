"""PPPM ad force gather from the z-binned potential (K3): the CUDA kernel
``csrc/pppm_gather.cu`` and its plain PyTorch version.

Per slot of the tile binning, (gx, gy, gz) = sum over the 5x5x5 stencil
of (w'x wy wz, wx w'y wz, wx wy w'z) u, read from the xy-wrap-padded
z-binned potential ``up`` (nx+2bw, ny+2bw, ntz, ez) at the tile's origin
(LAMMPS fieldforce_ad).  Returns (T*cap, 3) in slot order; the caller
gathers the atoms' slots and applies the delinv scale.

``gather3`` launches the kernel for CUDA float32 tensors and takes the
plain version for CPU and CUDA float64 tensors (``build.kernel_route``).  The plain version is
the JAX package's non-Pallas branch of ``gather3_ad_zbin`` on the im2col
patches of ``_zbin_patches``; the kernel reads ``up`` directly.
"""

from __future__ import annotations

import torch

from . import build

launches = build.LaunchCounter("gather3")


def gather3_patches_plain(patches, rows, cf, geom):
    """(T*cap, 3) from the (T, ez, ex*ey) patch blocks, one x-tile row of
    tiles at a time."""
    from ..pppm import _axis_onehot, _horner_dw, _horner_w, _patch_dims
    _, ex, ey, ez = _patch_dims(geom)
    per_row = geom.nty * geom.ntz
    out = []
    for r0 in range(0, geom.t_tiles, per_row):
        r = rows[r0:r0 + per_row]
        pa = patches[r0:r0 + per_row]                    # (tc, ez, exy)
        tc, cap = r.shape[0], r.shape[2]
        l = [r[:, k].to(torch.int64) for k in range(3)]
        wx = _axis_onehot(l[0], _horner_w(r[:, 3], cf), e=ex)
        wy = _axis_onehot(l[1], _horner_w(r[:, 4], cf), e=ey)
        wz = _axis_onehot(l[2], _horner_w(r[:, 5], cf), e=ez)
        dwx = _axis_onehot(l[0], _horner_dw(r[:, 3], cf), e=ex)
        dwy = _axis_onehot(l[1], _horner_dw(r[:, 4], cf), e=ey)
        dwz = _axis_onehot(l[2], _horner_dw(r[:, 5], cf), e=ez)
        tw = torch.bmm(wz, pa).reshape(tc, cap, ex, ey)
        tdw = torch.bmm(dwz, pa).reshape(tc, cap, ex, ey)
        s1 = torch.einsum("tcxy,tcy->tcx", tw, wy)
        s2 = torch.einsum("tcxy,tcy->tcx", tw, dwy)
        s3 = torch.einsum("tcxy,tcy->tcx", tdw, wy)
        out.append(torch.stack([torch.sum(dwx * s1, dim=2),
                                torch.sum(wx * s2, dim=2),
                                torch.sum(wx * s3, dim=2)], dim=2))
    return torch.cat(out).reshape(-1, 3)


def gather3_plain(up, rows, cf, geom):
    from ..pppm import _zbin_patches
    return gather3_patches_plain(_zbin_patches(up, geom), rows, cf, geom)


def gather3(up, rows, cf, geom):
    """Per-slot ad field (T*cap, 3): K3 for CUDA float32 tensors, the plain
    version for CPU and CUDA float64 tensors.  ``up``: (nx+2bw, ny+2bw, ntz, ez); ``rows``:
    the slot rows (T, 8, cap); ``cf``: (p, p) B-spline coefficients."""
    if not build.kernel_route("gather3", up):
        return gather3_plain(up, rows, cf, geom)
    bw = geom.hw + geom.dm
    ez = geom.tlz + 2 * bw
    build.check_cuda("gather3", torch.float32, up, rows, cf)
    if rows.shape != (geom.t_tiles, 8, geom.cap):
        raise ValueError("gather3: slot rows must be (T, 8, cap)")
    if up.shape != (geom.ntx * geom.tlx + 2 * bw, geom.nty * geom.tly + 2 * bw,
                    geom.ntz, ez):
        raise ValueError("gather3: up must be (nx+2bw, ny+2bw, ntz, ez)")
    if geom.p != 5 or cf.shape != (5, 5):
        raise ValueError("gather3: the kernel takes order 5 stencils")
    out = torch.empty((geom.t_tiles * geom.cap, 3), dtype=up.dtype,
                      device=up.device)
    lib = build.load_library()
    status = lib.conp2_gather3_f32(
        up.data_ptr(), rows.data_ptr(), cf.data_ptr(), geom.t_tiles,
        geom.cap, geom.tlx, geom.tly, geom.nty, geom.ntz, ez, up.shape[1],
        out.data_ptr(), build.stream_ptr())
    build.check_status("gather3", status)
    launches.count += 1
    return out
