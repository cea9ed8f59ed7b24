"""PPPM charge spreads from the tile slot rows: into the z-binned mesh (K2a)
and into per-tile patches (K2b), the CUDA kernels of ``csrc/pppm_spread.cu``
and their plain PyTorch versions.

Input: the slot rows (T, 8, cap) of ``ops/pppm.py TileSlots`` ([lx, ly,
lz, dxx, dxy, dxz, q, 0] per slot; tile t = (tx * nty + ty) * ntz + tz).
Output: the mesh (nx, ny, ntz, ez), merged in x and y (periodic) and
binned in z: bin tz holds the ez patch rows of its tiles, which the
shifted z-DFT of ``_spread_rhok_tiled`` contracts.

``spread_tiles`` (K2b) returns the per-tile patches (T, ex*ey, ez)
themselves, which ``ops/pppm.py spread_tiled`` overlap-adds into the real
mesh.

``spread_mesh`` and ``spread_tiles`` launch their kernels for CUDA float32
tensors, take the plain versions for CPU tensors and raise on CUDA
float64.  The plain versions are the JAX package's non-Pallas branch:
per-tile patches (wx (x) wy)^T (q wz) (``_tile_patches`` with its
``_local_weight_mats``), then, for K2a, the x/y overlap-add.
"""

from __future__ import annotations

import torch

from . import build

launches = build.LaunchCounter("spread_mesh")
tiles_launches = build.LaunchCounter("spread_tiles")


def tile_patches_plain(rows, cf, geom):
    """(T, ex*ey, ez) charge patches of every tile, one x-tile row of tiles
    at a time (bounds the (tiles, cap, ex*ey) weight transient)."""
    from ..pppm import _axis_onehot, _horner_w, _patch_dims
    _, ex, ey, ez = _patch_dims(geom)
    per_row = geom.nty * geom.ntz
    out = []
    for r0 in range(0, geom.t_tiles, per_row):
        r = rows[r0:r0 + per_row]                        # (tc, 8, cap)
        wx = _axis_onehot(r[:, 0].to(torch.int64), _horner_w(r[:, 3], cf),
                          e=ex)
        wy = _axis_onehot(r[:, 1].to(torch.int64), _horner_w(r[:, 4], cf),
                          e=ey)
        wz = _axis_onehot(r[:, 2].to(torch.int64), _horner_w(r[:, 5], cf),
                          e=ez)
        wxy = (wx[..., :, None] * wy[..., None, :]).reshape(
            r.shape[0], -1, ex * ey)
        out.append(torch.bmm(wxy.transpose(1, 2), r[:, 6, :, None] * wz))
    return torch.cat(out)


def spread_mesh_plain(rows, cf, geom):
    """Patches, then the y and x overlap-adds: (nx, ny, ntz, ez)."""
    from ..pppm import _merge_axis, _patch_dims
    bw, ex, ey, ez = _patch_dims(geom)
    pt = tile_patches_plain(rows, cf, geom).reshape(
        geom.ntx, geom.nty, geom.ntz, ex, ey, ez)
    pt = _merge_axis(pt, 1, 4, geom.tly, bw, periodic=True)
    pt = _merge_axis(pt, 0, 3, geom.tlx, bw, periodic=True)
    return pt.permute(0, 3, 1, 4, 2, 5).reshape(
        geom.ntx * geom.tlx, geom.nty * geom.tly, geom.ntz, ez)


def spread_mesh(rows, cf, geom):
    """The z-binned charge mesh (nx, ny, ntz, ez) from the slot rows: K2a
    for CUDA float32 tensors, the plain version for CPU tensors.  ``cf``:
    the (p, p) B-spline coefficients (``ops/pppm.py rho_coeffs``)."""
    if rows.device.type == "cpu":
        return spread_mesh_plain(rows, cf, geom)
    bw = geom.hw + geom.dm
    ez = geom.tlz + 2 * bw
    build.check_cuda("spread_mesh", torch.float32, rows, cf)
    if rows.shape != (geom.t_tiles, 8, geom.cap):
        raise ValueError("spread_mesh: slot rows must be (T, 8, cap)")
    if geom.p != 5 or cf.shape != (5, 5):
        raise ValueError("spread_mesh: the kernel takes order 5 stencils")
    out = torch.empty((geom.ntx * geom.tlx, geom.nty * geom.tly, geom.ntz,
                       ez), dtype=rows.dtype, device=rows.device)
    lib = build.load_library()
    status = lib.conp2_spread_mesh_f32(
        rows.data_ptr(), cf.data_ptr(), geom.tlx, geom.tly, ez, bw,
        geom.ntx, geom.nty, geom.ntz, geom.cap, out.data_ptr(),
        build.stream_ptr())
    build.check_status("spread_mesh", status)
    launches.count += 1
    return out


def spread_tiles(rows, cf, geom):
    """Per-tile charge patches (T, ex*ey, ez) from the slot rows: K2b for
    CUDA float32 tensors, ``tile_patches_plain`` for CPU tensors.  ``cf``:
    the (p, p) B-spline coefficients (``ops/pppm.py rho_coeffs``)."""
    if rows.device.type == "cpu":
        return tile_patches_plain(rows, cf, geom)
    bw = geom.hw + geom.dm
    ex, ey, ez = geom.tlx + 2 * bw, geom.tly + 2 * bw, geom.tlz + 2 * bw
    build.check_cuda("spread_tiles", torch.float32, rows, cf)
    if rows.shape != (geom.t_tiles, 8, geom.cap):
        raise ValueError("spread_tiles: slot rows must be (T, 8, cap)")
    if geom.p != 5 or cf.shape != (5, 5):
        raise ValueError("spread_tiles: the kernel takes order 5 stencils")
    out = torch.empty((geom.t_tiles, ex * ey, ez), dtype=rows.dtype,
                      device=rows.device)
    lib = build.load_library()
    status = lib.conp2_spread_tiles_f32(
        rows.data_ptr(), cf.data_ptr(), geom.t_tiles, ex, ey, ez, geom.cap,
        out.data_ptr(), build.stream_ptr())
    build.check_status("spread_tiles", status)
    tiles_launches.count += 1
    return out
