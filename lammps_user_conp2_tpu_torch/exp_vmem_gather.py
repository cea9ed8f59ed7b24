"""Rate of random-row gathers from a window of atoms held on chip (K9).

    python -m lammps_user_conp2_tpu_torch.exp_vmem_gather     # R=8 default

The probe function, for each block t, lane l and row w:

    out[t, w, l] = sum_{r=0}^{R-1} win[t, (idx[t, w, l] + r) mod W, l]

``win`` (nb, W, 128) float32 standard normal, ``idx`` (nb, W, 128) int32
uniform in [0, W), both from ``np.random.default_rng(0)``.  Atoms are
z-sorted, so a block of consecutive atoms has all its neighbours inside a
+-W/2 window of sorted indices; with the 4-float atom payload tiled 32x
across the 128 lanes, one (W, 128) gather fetches W*32 arbitrary window
rows.  On the card ``ops/kernels/vmem_gather.window_gather`` (K9) stages
each block's window in shared memory and gathers from it; the
global-memory gather it is measured against is ``exp_gather_chunk``.

Timed step, chained ``iters`` times by ``timing.chain_ms`` (min of 3
trials): ``out = window_gather(win + s[0, 0, 0], idx, R)``, then
``s + 1e-30 * out.sum()``; the step time includes the window add and the
sum.  Reported per shape: ms per step, ns/row = ms 1e6 / rows with rows =
nb R W 32 (4-float rows), and ns/element = ns/row / 4.  Shapes (nb, W):
(32, 2048), (32, 4096), (8, 8192).  R is read from env ``R`` (default 8).
Runs on the card; ``device="cpu"`` runs the plain version.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ops.kernels import vmem_gather
from .timing import chain_ms
from .utils.device import resolve_device

DEFAULT_R = int(os.environ.get("R", "8"))
PROBE_SHAPES = ((32, 2048), (32, 4096), (8, 8192))


def probe_inputs(nb, W, device):
    """(win, idx) of the probe at (nb, W): float32 and int32 on ``device``."""
    rng = np.random.default_rng(0)
    win = torch.as_tensor(rng.standard_normal((nb, W, 128)),
                          dtype=torch.float32, device=device)
    idx = torch.as_tensor(rng.integers(0, W, size=(nb, W, 128)),
                          dtype=torch.int32, device=device)
    return win, idx


def run_probe(nb, W, R=None, device=None, iters=20):
    """Time the chained probe step at (nb, W) (R None: env ``R``, default
    8); prints one line and returns dict(nb, W, R, ms, ns_row,
    ns_element)."""
    dev = resolve_device(device)
    R = DEFAULT_R if R is None else int(R)
    win, idx = probe_inputs(nb, W, dev)

    def step(s):
        out = vmem_gather.window_gather(win + s[0, 0, 0], idx, R)
        return s + 1e-30 * torch.sum(out)

    ms = chain_ms(step, torch.zeros((1, 1, 1), dtype=torch.float32,
                                    device=dev), iters=iters)
    rows = nb * R * W * 32            # 4-float payload rows per op
    ns_row = ms * 1e6 / rows
    print(f"W={W} nb={nb} R={R}: {ms:7.3f} ms  {ns_row:6.4f} ns/row  "
          f"({ns_row / 4:6.4f} ns/element)", flush=True)
    return dict(nb=nb, W=W, R=R, ms=ms, ns_row=ns_row, ns_element=ns_row / 4)


def main():
    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for nb, W in PROBE_SHAPES:
        run_probe(nb, W, device=dev)


if __name__ == "__main__":
    main()
