"""Window gather probe (K9): the CUDA kernel ``csrc/vmem_gather.cu`` and its
plain PyTorch version.

For each block t, lane l and row w,

    out[t, w, l] = sum_{r=0}^{R-1} win[t, (idx[t, w, l] + r) mod W, l]

with ``win`` (nb, W, 128) float32, ``idx`` (nb, W, 128) int32 and ``out``
(nb, W, 128) float32: every lane gathers along its own column, and the R
terms are added in the order r = 0 ... R-1 into a zero accumulator.

``window_gather`` launches the kernel for CUDA float32/int32 tensors, takes
the plain version for CPU tensors and raises for any other CUDA dtype.
The kernel's work items are (t, group of ``cols`` lanes); ``window_plan``
chooses ``cols``, the TMA box the W x cols slice is copied in, the ring of
box slots each persistent CTA keeps and the CTAs, from the card's shared
memory and SM count.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import build

launches = build.LaunchCounter("window_gather")
LANES = 128
THREADS = 1024          # threads per CTA (csrc/vmem_gather.cu WG_TB)
BOX_ROWS = 256          # rows of a TMA box at most (a box dimension's limit)
BAR_BYTES = 128         # the mbarriers, ahead of the ring of box slots
SMEM_LIMIT = 232448     # dynamic shared memory of a CTA on the H100
# the ring's bytes beyond one window stop here: the rest of the SM's 256 KB
# stays L1, which the idx loads in flight need
RING_BUDGET = 196608
ENCODE_FAILED = 10000   # the kernel's status base for a refused tensor map


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """How K9 cuts (nb, W): work items of ``cols`` lanes of one block t,
    each item's W x cols window slice copied as ``nbox`` TMA boxes of
    ``box_rows`` rows (the rows past W zero-filled) into a ring of
    ``slots`` box slots of ``box_bytes`` (between one window and two: the
    slots one window leaves free take the next item's first boxes while
    the threads gather), ``smem`` bytes of dynamic shared memory, ``grid``
    persistent CTAs over ``items``."""
    cols: int
    box_rows: int
    nbox: int
    box_bytes: int
    slots: int
    smem: int
    items: int
    grid: int


def window_plan(nb: int, W: int, sm_count: int) -> WindowPlan:
    """The widest ``cols`` of 16, 8, 4 whose window fits the shared memory
    once; a ring of one window's slots and more, up to two windows, as far
    as ``RING_BUDGET`` allows; one CTA per SM (at most one per item).
    Boxes hold 256 rows, or all of a shorter window rounded up to a
    128-byte slot.  Raises if W does not fit."""
    for cols in (16, 8, 4):
        if W <= BOX_ROWS:
            box_rows = -(-W // (32 // cols)) * (32 // cols)
        else:
            box_rows = BOX_ROWS
        nbox = -(-W // box_rows)
        box_bytes = box_rows * cols * 4
        slots = min(2 * nbox, max(nbox, RING_BUDGET // box_bytes),
                    (SMEM_LIMIT - BAR_BYTES) // box_bytes)
        if slots >= nbox:
            items = nb * (LANES // cols)
            return WindowPlan(cols, box_rows, nbox, box_bytes, slots,
                              BAR_BYTES + slots * box_bytes, items,
                              min(items, sm_count))
    raise ValueError(f"window_gather: W={W} does not fit shared memory")


def cta_items(plan: WindowPlan, cta: int) -> range:
    """The items CTA ``cta`` walks, in order: cta, cta + grid, ..."""
    return range(cta, plan.items, plan.grid)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def window_gather_plain(win, idx, R):
    """(nb, W, 128) sums of R gathers along dim 1, added in order r = 0 ...
    R-1 into a zero accumulator (the JAX probe's ``gather_kernel``)."""
    wn = win.shape[1]
    ix = idx.to(torch.int64)
    acc = torch.zeros_like(win)
    for r in range(R):
        acc = acc + torch.gather(win, 1, torch.remainder(ix + r, wn))
    return acc


def window_gather(win, idx, R):
    """K9 for CUDA float32/int32 tensors, the plain version for CPU tensors.
    ``win``: (nb, W, 128) float32, 16-byte aligned; ``idx``: (nb, W, 128)
    int32 in [0, W)."""
    if win.device.type == "cpu":
        return window_gather_plain(win, idx, R)
    build.check_cuda("window_gather", torch.float32, win)
    build.check_cuda("window_gather", torch.int32, idx)
    if win.dim() != 3 or win.shape[2] != LANES or idx.shape != win.shape:
        raise ValueError("window_gather: win and idx must be (nb, W, 128)")
    if R < 1:
        raise ValueError("window_gather: R must be >= 1")
    if win.data_ptr() % 16:
        raise ValueError("window_gather: win must be 16-byte aligned")
    nb, W, _ = win.shape
    plan = window_plan(nb, W, _sm_count(win.device.index or 0))
    out = torch.empty_like(win)
    lib = build.load_library()
    status = lib.conp2_window_gather_f32(
        win.data_ptr(), idx.data_ptr(), nb, W, int(R), plan.cols,
        plan.box_rows, plan.slots, plan.grid, out.data_ptr(),
        build.stream_ptr())
    if status >= ENCODE_FAILED:
        raise RuntimeError(f"window_gather: cuTensorMapEncodeTiled refused "
                           f"the tensor map (CUresult "
                           f"{status - ENCODE_FAILED})")
    build.check_status("window_gather", status)
    launches.count += 1
    return out
