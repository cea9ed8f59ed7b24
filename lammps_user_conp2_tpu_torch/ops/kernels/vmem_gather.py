"""Window gather probe (K9): the CUDA kernel ``csrc/vmem_gather.cu`` and its
plain PyTorch version.

For each block t, lane l and row w,

    out[t, w, l] = sum_{r=0}^{R-1} win[t, (idx[t, w, l] + r) mod W, l]

with ``win`` (nb, W, 128) float32, ``idx`` (nb, W, 128) int32 and ``out``
(nb, W, 128) float32: every lane gathers along its own column, and the R
terms are added in the order r = 0 ... R-1 into a zero accumulator.

``window_gather`` launches the kernel for CUDA float32/int32 tensors
(staging each block's window in shared memory), takes the plain version
for CPU tensors and raises for any other CUDA dtype.
"""

from __future__ import annotations

import torch

from . import build

launches = build.LaunchCounter("window_gather")
LANES = 128
# shared memory a CTA may stage: W * cols * 4 bytes of the window
SMEM_BUDGET = 200 * 1024


def window_gather_plain(win, idx, R):
    """(nb, W, 128) sums of R gathers along dim 1, added in order r = 0 ...
    R-1 into a zero accumulator (the JAX probe's ``gather_kernel``)."""
    wn = win.shape[1]
    ix = idx.to(torch.int64)
    acc = torch.zeros_like(win)
    for r in range(R):
        acc = acc + torch.gather(win, 1, torch.remainder(ix + r, wn))
    return acc


def window_cols(W: int) -> int:
    """Lanes a CTA owns: the largest of 16, 8, 4 whose W x cols float32
    slice fits ``SMEM_BUDGET`` (W <= 12,800)."""
    for cols in (16, 8, 4):
        if W * cols * 4 <= SMEM_BUDGET:
            return cols
    raise ValueError(f"window_gather: W={W} does not fit shared memory")


def window_gather(win, idx, R):
    """K9 for CUDA float32/int32 tensors, the plain version for CPU tensors.
    ``win``: (nb, W, 128) float32; ``idx``: (nb, W, 128) int32 in [0, W)."""
    if win.device.type == "cpu":
        return window_gather_plain(win, idx, R)
    build.check_cuda("window_gather", torch.float32, win)
    build.check_cuda("window_gather", torch.int32, idx)
    if win.dim() != 3 or win.shape[2] != LANES or idx.shape != win.shape:
        raise ValueError("window_gather: win and idx must be (nb, W, 128)")
    if R < 1:
        raise ValueError("window_gather: R must be >= 1")
    nb, W, _ = win.shape
    cols = window_cols(W)
    out = torch.empty_like(win)
    lib = build.load_library()
    status = lib.conp2_window_gather_f32(
        win.data_ptr(), idx.data_ptr(), nb, W, int(R), cols, out.data_ptr(),
        build.stream_ptr())
    build.check_status("window_gather", status)
    launches.count += 1
    return out
