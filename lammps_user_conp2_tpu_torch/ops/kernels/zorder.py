"""Per-step atom orderings shared by the pair and electrode-row kernels.

Both CUDA sweeps (``pair_kernel``, ``ele_rows_kernel``) cull column tiles
or windows by z, which needs the atoms sorted by (wrapped) z.  All run at
the same positions within a step, so the (N,) sort is computed once, by
the charge solve, and handed to the force path with the factored-Ewald
tables.

The tile pair path culls tile pairs by 3-D bounding boxes, which wants
tiles that are compact in space: ``kd_perm`` (balanced k-d bricks of one
tile each, the engine's order), ``hilbert_perm`` and ``morton_perm``
(space-filling curves), the JAX package's ``ops/pallas/zorder.py``
orderings, selected by name through ``ORDERINGS``.

Any permutation is correct: the culling bounds are read from the same
sorted keys the kernels use, so a poor order only loosens them.  Ties may
sort differently from ``jnp.argsort``; nothing depends on their order.

The bound tests carry a +1e-3 Angstrom margin (Z_MARGIN): the sort keys and
the kernels' minimum-image distances are computed by different float
expressions, and a pair within a few ulps of the cutoff must never be
dropped by a bound that rounded the other way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Z_MARGIN = 1e-3


def wrap_z(z, lz, zperiodic):
    if zperiodic:
        return z - lz * torch.floor(z * (1.0 / lz))
    return z


def z_perm(x, box, periodic):
    """(perm, z_sorted): the atom order by wrapped z, and the sorted keys."""
    zs = wrap_z(x[:, 2], float(box[2]), bool(periodic[2]))
    zsorted, perm = torch.sort(zs)
    return perm, zsorted


def wrap_coords(x, box, periodic):
    """Each periodic axis wrapped into [0, L); the others as they are: the
    frame of the per-tile bounding boxes."""
    return torch.stack([wrap_z(x[:, ax], float(box[ax]), bool(periodic[ax]))
                        for ax in range(3)], dim=1)


def _part1by2(v):
    """The low 10 bits of the int64 ``v`` spread to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantized(x, box, periodic, bits):
    """The wrapped coordinates quantized to ``bits``-bit cells of one size
    on every axis (the longest span / 2^bits), int64 per axis."""
    nq = 1 << bits
    w = wrap_coords(x, box, periodic)
    lo = torch.amin(w, dim=0)
    cell = torch.clamp(torch.amax(torch.amax(w, dim=0) - lo) / nq,
                       min=1e-30)
    return [torch.clamp((w[:, ax] - lo[ax]) / cell, 0, nq - 1).to(torch.int64)
            for ax in range(3)]


def _sorted_by(key, x, box, periodic):
    perm = torch.sort(key, stable=True).indices
    zs = wrap_z(x[:, 2], float(box[2]), bool(periodic[2]))
    return perm, zs[perm]


def morton_perm(x, box, periodic, bits=10):
    """(perm, wrapped z of the permuted atoms): the atoms along a 3-D
    Morton curve of their quantized wrapped coordinates."""
    cx, cy, cz = _quantized(x, box, periodic, bits)
    key = _part1by2(cx) | (_part1by2(cy) << 1) | (_part1by2(cz) << 2)
    return _sorted_by(key, x, box, periodic)


def hilbert_perm(x, box, periodic, bits=10):
    """(perm, wrapped z): the atoms along a 3-D Hilbert curve (Skilling's
    AxesToTranspose, J. Skilling, AIP Conf. Proc. 707, 2004): every run of
    the order is one connected region."""
    X = _quantized(x, box, periodic, bits)
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            cond = (X[i] & q) != 0
            t = (X[0] ^ X[i]) & p
            x0 = torch.where(cond, X[0] ^ p, X[0] ^ t)
            if i > 0:
                X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0
        q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[2])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    X = [xi ^ t for xi in X]
    key = (_part1by2(X[0]) << 2) | (_part1by2(X[1]) << 1) | _part1by2(X[2])
    return _sorted_by(key, x, box, periodic)


@functools.lru_cache(maxsize=16)
def _kd_levels(n: int, tr: int, dims: tuple):
    """The static k-d tree of ``kd_perm``: per level the (segment id, cut
    axis) of every sorted position, numpy int64.  Segments are runs of
    whole tiles; a segment of more than one tile is cut in two at half its
    tiles (the first half one larger) along its longest remaining extent,
    until every segment is one tile."""
    ni = max(-(-n // tr), 1)
    segments = [(0, ni, tuple(dims))]
    levels = []
    while max(b - a for a, b, _ in segments) > 1:
        axis_at = np.zeros(n, np.int64)
        sid_at = np.zeros(n, np.int64)
        new = []
        for s, (a, b, ext) in enumerate(segments):
            lo, hi = a * tr, min(b * tr, n)
            sid_at[lo:hi] = s
            if b - a > 1:
                ax = int(np.argmax(ext))
                axis_at[lo:hi] = ax
                m = a + (b - a + 1) // 2
                le, re = list(ext), list(ext)
                le[ax] = ext[ax] * (m - a) / (b - a)
                re[ax] = ext[ax] * (b - m) / (b - a)
                new += [(a, m, tuple(le)), (m, b, tuple(re))]
            else:
                new.append((a, b, ext))
        levels.append((sid_at, axis_at))
        segments = new
    return levels


@functools.lru_cache(maxsize=16)
def _kd_levels_on(n: int, tr: int, dims: tuple, device: str):
    """``_kd_levels`` as device tensors, copied once per shape and device
    (the ordering runs inside the step's CUDA graph)."""
    return [(torch.as_tensor(sid, device=device),
             torch.as_tensor(ax, device=device)[:, None])
            for sid, ax in _kd_levels(n, tr, dims)]


def kd_perm(x, box, periodic, tr=32):
    """(perm, wrapped z): the atoms in balanced k-d bricks, every run of
    ``tr`` sorted atoms (one tile) a near-cubic brick.  The tree is static
    (``_kd_levels``, on the host); each level sorts by (segment,
    coordinate on the segment's axis) with two stable sorts, the
    coordinate first, so ties keep their order as the JAX package's
    two-key ``lax.sort`` keeps it."""
    n = x.shape[0]
    dims = tuple(float(b) for b in box)
    perm = torch.arange(n, device=x.device)
    xs = wrap_coords(x, box, periodic)
    for sid, ax in _kd_levels_on(n, tr, dims, str(x.device)):
        key = torch.gather(xs, 1, ax)[:, 0]
        p1 = torch.sort(key, stable=True).indices
        p2 = p1[torch.sort(sid[p1], stable=True).indices]
        perm = perm[p2]
        xs = xs[p2]
    zs = wrap_z(x[:, 2], float(box[2]), bool(periodic[2]))
    return perm, zs[perm]


# the orderings by name; the engine's tile path uses "kd" at its tile size
ORDERINGS = {"z": z_perm, "morton": morton_perm, "hilbert": hilbert_perm,
             "kd": kd_perm}
