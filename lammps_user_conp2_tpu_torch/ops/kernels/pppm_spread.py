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
tensors and take the plain versions for CPU and CUDA float64 tensors
(``build.kernel_route``).  The plain versions are the JAX package's non-Pallas branch:
per-tile patches (wx (x) wy)^T (q wz) (``_tile_patches`` with its
``_local_weight_mats``), then, for K2a, the x/y overlap-add.

K2a's binning has plain versions of its own, which the CPU tests hold
against ``spread_mesh_plain``: ``spread_bins_plain`` (each output tile's
staging passes, the kept atoms of each sorted by stencil origin cell) and
``spread_from_bins_plain`` (the mesh from those bins, each accumulator row
walking the one run of origin cells that reaches it).
"""

from __future__ import annotations

import numpy as np
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


# K2a's launch: threads per CTA (one staging round), the shared-memory
# budget per CTA (3 CTAs per SM) less its static arrays, and the bytes per
# kept atom of a staging pass (csrc/pppm_spread.cu SP_*)
MESH_TB = 256
MESH_BUDGET = 76800 - 1024
MESH_ITEM_BYTES = 22 * 4


def spread_pass_cap(geom) -> int:
    """Kept atoms per staging pass of K2a: what fits beside the (ez, tlx
    tly padded to 5 mod 32) accumulator and the origin cells, in whole
    warps, at least one round (``conp2_spread_mesh_pass_cap``)."""
    ez = geom.tlz + 2 * (geom.hw + geom.dm)
    ncol = geom.tlx * geom.tly
    fixed = 4 * (ez * (ncol + (5 - ncol) % 32)
                 + (geom.tlx + 4) * (geom.tly + 4))
    return max((MESH_BUDGET - fixed) // MESH_ITEM_BYTES // 32 * 32, MESH_TB)


def _mesh_sources(rows, geom, t):
    """The nine sources of output tile t, in K2a's order: (slot rows (8,
    cap), count = one past the last charged slot, origin shift x, y)."""
    bw = geom.hw + geom.dm
    tz = t % geom.ntz
    ty = (t // geom.ntz) % geom.nty
    tx = t // (geom.ntz * geom.nty)
    out = []
    for nb in range(9):
        dx, dy = nb // 3 - 1, nb % 3 - 1
        nt = ((((tx + dx) % geom.ntx) * geom.nty + (ty + dy) % geom.nty)
              * geom.ntz + tz)
        r = rows[nt]
        charged = np.flatnonzero(r[6] != 0.0)
        cnt = int(charged[-1]) + 1 if charged.size else 0
        out.append((r, cnt, dx * geom.tlx - bw, dy * geom.tly - bw))
    return out


def spread_bins_plain(rows, geom, *, round_size=MESH_TB, pass_cap=None):
    """K2a's origin bins, per output tile: a list of staging passes, each
    (ends, items): ``items`` the pass's kept atoms (source * cap + slot) in
    the stable order of their origin cell ((ox + 4) * (tly + 4) + oy + 4),
    ``ends`` (ncell,) the end of each cell's run.  The kernel stages
    ``round_size`` (source, slot) pairs at a time, source by source, each
    source up to one past its last charged slot, and adds the pass it holds
    before a round whose kept atoms would take it over ``pass_cap``
    (default ``spread_pass_cap``)."""
    rows = rows.detach().cpu().numpy()
    kc = spread_pass_cap(geom) if pass_cap is None else pass_cap
    nwy = geom.tly + 4
    ncell = (geom.tlx + 4) * nwy
    out = []
    for t in range(geom.t_tiles):
        items, keys, keep = [], [], []
        for nb, (r, cnt, sx, sy) in enumerate(_mesh_sources(rows, geom, t)):
            ox = r[0, :cnt].astype(np.int64) + sx
            oy = r[1, :cnt].astype(np.int64) + sy
            keep.append((r[6, :cnt] != 0.0) & (ox < geom.tlx) & (ox > -5)
                        & (oy < geom.tly) & (oy > -5))
            keys.append((ox + 4) * nwy + oy + 4)
            items.append(nb * geom.cap + np.arange(cnt))
        items, keys, keep = (np.concatenate(a) for a in (items, keys, keep))
        passes, cur = [], np.zeros(0, np.int64)

        def close(sel):
            k = keys[sel]
            order = np.argsort(k, kind="stable")
            ends = np.cumsum(np.bincount(k, minlength=ncell))
            passes.append((ends, items[sel][order]))

        for g0 in range(0, items.shape[0], round_size):
            rnd = np.flatnonzero(keep[g0:g0 + round_size]) + g0
            if cur.shape[0] + rnd.shape[0] > kc:
                close(cur)
                cur = np.zeros(0, np.int64)
            cur = np.concatenate([cur, rnd])
        if cur.shape[0]:
            close(cur)
        out.append(passes)
    return out


def spread_from_bins_plain(rows, cf, geom, bins):
    """The z-binned mesh (nx, ny, ntz, ez) from ``spread_bins_plain``'s
    bins, in float64, walked as K2a walks them: row i (x) of each output
    tile adds, pass by pass, the one run of sorted atoms whose origin cells
    have x index i .. i + 4, each with weight i - ox on x and its 5 x 5
    (y, z) footprint in the row."""
    rows = rows.detach().cpu().numpy().astype(np.float64)
    cf = np.asarray(cf.detach().cpu(), np.float64)
    bw = geom.hw + geom.dm
    ez = geom.tlz + 2 * bw
    tlx, tly, cap = geom.tlx, geom.tly, geom.cap
    nwy = tly + 4
    out = np.zeros((geom.ntx * tlx, geom.nty * tly, geom.ntz, ez))

    def horner(d):
        w = np.zeros(d.shape + (5,))
        for l in range(4, -1, -1):
            w = w * d[:, None] + cf[:, l]
        return w

    for t, passes in enumerate(bins):
        src = _mesh_sources(rows, geom, t)
        acc = np.zeros((tlx, tly, ez))
        for ends, items in passes:
            nb, sl = np.divmod(items, cap)
            r = np.stack([src[s][0][:, k] for s, k in zip(nb, sl)]).reshape(
                -1, 8)
            ox = r[:, 0].astype(np.int64) + np.array(
                [src[s][2] for s in nb], np.int64).reshape(-1)
            oy = r[:, 1].astype(np.int64) + np.array(
                [src[s][3] for s in nb], np.int64).reshape(-1)
            oz = r[:, 2].astype(np.int64)
            wx, wy, wz = horner(r[:, 3]), horner(r[:, 4]), horner(r[:, 5])
            wz = wz * r[:, 6, None]
            starts = np.concatenate([[0], ends[:-1]])
            for i in range(tlx):
                p = np.arange(starts[i * nwy], ends[(i + 5) * nwy - 1])
                for b in range(5):
                    j = oy[p] + b
                    ok = (j >= 0) & (j < tly)
                    pj = p[ok]
                    wxy = wx[pj, i - ox[pj]] * wy[pj, b]
                    for z in range(5):
                        np.add.at(acc, (i, j[ok], oz[pj] + z),
                                  wxy * wz[pj, z])
        tz = t % geom.ntz
        ty = (t // geom.ntz) % geom.nty
        tx = t // (geom.ntz * geom.nty)
        out[tx * tlx:(tx + 1) * tlx, ty * tly:(ty + 1) * tly, tz] = acc
    return out


def spread_mesh(rows, cf, geom):
    """The z-binned charge mesh (nx, ny, ntz, ez) from the slot rows: K2a
    for CUDA float32 tensors, the plain version for CPU and CUDA float64
    tensors.  ``cf``: the (p, p) B-spline coefficients (``ops/pppm.py
    rho_coeffs``)."""
    if not build.kernel_route("spread_mesh", rows):
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
    CUDA float32 tensors, ``tile_patches_plain`` for CPU and CUDA float64
    tensors.  ``cf``: the (p, p) B-spline coefficients (``ops/pppm.py
    rho_coeffs``)."""
    if not build.kernel_route("spread_tiles", rows):
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
