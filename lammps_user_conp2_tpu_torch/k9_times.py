"""K9's times at the window gather probe's shapes, for this checkout or
another one.

    python3 lammps_user_conp2_tpu_torch/k9_times.py [--root DIR] [--out FILE]

Imports ``lammps_user_conp2_tpu_torch`` from the checkout at DIR (default:
the one this file is in), so that two trees' K9 can be timed in turn on one
card: ``--root`` an unpacked parent commit, then this tree, then the parent
again.  It reaches the kernel only through ``ops.kernels.vmem_gather``
(``window_gather``, ``window_gather_plain``) and ``exp_vmem_gather``
(``PROBE_SHAPES``, ``probe_inputs``, ``run_probe``), as every tree since
the kernel was ported has them.  Per shape (nb, W) and R in (8, 1): the
kernel against its plain version (max|kernel - plain|, 0 when bit for
bit), ms per call between two CUDA events (median of 20 single calls),
device ms per call from torch.profiler (the median kernel record over 20
calls) and the bound by bytes (win, idx and out once at 3.35 TB/s); at
R = 1 the same two times of ``torch.gather(win, 1, idx)``, which computes
the function; then the probe's chained step (``run_probe``, R = 8: ms and
ns/row).  Prints the card's name and power limit and one JSON line
{"k9_times": ...}; ``--out`` also writes it to FILE.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
REPS = 20


def event_ms(fn, reps=REPS, warmup=3) -> float:
    """Median of single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profiled_ms(fn, part, reps=REPS) -> float:
    """Median device time of the CUDA kernels whose name holds ``part``
    (torch.profiler over ``reps`` calls), times their records per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace can come back without records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        t = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type.name == "CUDA" and part in e.name]
        if t:
            return float(np.median(t)) * max(1, round(len(t) / reps))
    raise RuntimeError(f"k9_times: no device record of {part!r}")


def measure(k9, exp, device, rs=(8, 1)) -> list:
    """Per probe shape: the error against the plain version and the times
    above, for R in ``rs``; the library call's at R = 1."""
    rows = []
    for nb, W in exp.PROBE_SHAPES:
        win, idx = exp.probe_inputs(nb, W, device)
        row = dict(nb=nb, W=W, bound_ms=3 * win.numel() * 4
                   / HBM_BYTES_PER_S * 1e3)
        for R in rs:
            got = k9.window_gather(win, idx, R)
            torch.cuda.synchronize()
            row[f"err_r{R}"] = float(
                (got - k9.window_gather_plain(win, idx, R)).abs().max())
            kern = lambda: k9.window_gather(win, idx, R)
            row[f"ms_r{R}"] = event_ms(kern)
            row[f"device_ms_r{R}"] = profiled_ms(kern, "window_gather")
        if 1 in rs:
            lib = lambda: torch.gather(win, 1, idx)
            row["library_ms"] = event_ms(lib)
            row["library_device_ms"] = profiled_ms(lib, "gather")
        rows.append(row)
        del win, idx
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_times: no CUDA device visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != os.path.dirname(
                                os.path.abspath(__file__))]
    from lammps_user_conp2_tpu_torch import exp_vmem_gather as exp
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9
    if not os.path.abspath(k9.__file__).startswith(root + os.sep):
        raise RuntimeError(f"k9_times: imported {k9.__file__}, not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    rows = measure(k9, exp, dev)
    probe = [exp.run_probe(nb, W, R=8, device=dev)
             for nb, W in exp.PROBE_SHAPES]
    for r in rows:
        print(f"({r['nb']}, {r['W']}): R=8 {r['ms_r8']:.4f} ms / device "
              f"{r['device_ms_r8']:.4f}; R=1 {r['ms_r1']:.4f} / "
              f"{r['device_ms_r1']:.4f}; torch.gather {r['library_ms']:.4f} "
              f"/ {r['library_device_ms']:.4f}; bound {r['bound_ms']:.6f} "
              f"(bytes); err {r['err_r8']:.1e} {r['err_r1']:.1e}  [{card}]")
    line = json.dumps({"k9_times": dict(root=root, card=card, shapes=rows,
                                        probe=probe)})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
