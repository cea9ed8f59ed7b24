"""fix zmirror: z-mirror symmetry between two matched groups.

Every ``every`` steps the atoms of group2 are placed at group1's
coordinates mirrored through the z midplane (z' = 2 zlo + Lz - z,
fix_zmirror.cpp:132/163/215), the atoms paired by tag offset (setup checks
equal tag-contiguous ranges, fix_zmirror.cpp:63-95).

The pairing is a permutation built once on the host and kept as device
buffers, so the fix is one gather, an affine map and an index copy inside
the step (and its CUDA graphs).  The index copy writes each destination
row once (the rows are distinct), so the step stays bit-reproducible.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .system import System


class ZMirror(nn.Module):
    """The tag pairing as device buffers: ``src_idx`` (M,) the rows of
    group1, ``dst_idx`` (M,) their mirrored copies in group2, int64."""

    def __init__(self, src_idx, dst_idx, *, zoffset: float, every: int,
                 device):
        super().__init__()
        i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                        device=device)
        self.register_buffer("src_idx", i64(src_idx))
        self.register_buffer("dst_idx", i64(dst_idx))
        self.zoffset = float(zoffset)         # 2 zlo + Lz
        self.every = int(every)

    def apply(self, x, step=None):
        """x with group2 set to group1 mirrored in z: at every step when
        ``every`` is 1 or ``step`` is None, else where the () step tensor
        is a multiple of ``every`` (the post-integrate call of the step
        being computed)."""
        src = x[self.src_idx]
        mirrored = torch.stack([src[:, 0], src[:, 1],
                                self.zoffset - src[:, 2]], dim=1)
        xnew = x.index_copy(0, self.dst_idx, mirrored)
        if step is None or self.every == 1:
            return xnew
        return torch.where(step % self.every == 0, xnew, x)


def build_zmirror(system: System, group1: str, group2: str, every: int = 1,
                  *, device=None) -> ZMirror:
    """The pairing of ``group1`` (source) and ``group2`` (mirrored copies)
    by tag offset; raises unless both are the same size and
    tag-contiguous."""
    m1 = system.groups[group1]
    m2 = system.groups[group2]
    t1 = system.tag[m1]
    t2 = system.tag[m2]
    if len(t1) != len(t2):
        raise ValueError("zmirror groups must be the same size")
    if (t1.max() - t1.min() + 1 != len(t1)
            or t2.max() - t2.min() + 1 != len(t2)):
        raise ValueError("zmirror groups must be tag-contiguous "
                         "(fix_zmirror.cpp:63-95)")
    idx1 = np.nonzero(m1)[0]
    idx2 = np.nonzero(m2)[0]
    # both in tag order, so dst[k] mirrors src[k] (the tag offset pairing)
    idx1 = idx1[np.argsort(system.tag[idx1])]
    idx2 = idx2[np.argsort(system.tag[idx2])]
    zoffset = 2 * float(system.box_lo[2]) + system.box[2]
    return ZMirror(idx1, idx2, zoffset=zoffset, every=every, device=device)
