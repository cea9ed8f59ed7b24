"""Chained-loop timing for the port's probes.

Only a loop whose state feeds back measures the cost of a step: each
iteration's input depends on the last one's output, so no iteration can
be skipped or overlapped with the next.  PyTorch runs eagerly and launches
every iteration, so no input is perturbed between trials (the sub-ulp nudge
of the JAX tools guarded against a remote runtime memoising identical
calls, which PyTorch does not do).
"""

from __future__ import annotations

import time

import torch


def chain_ms(fn, x0, iters=50, trials=3):
    """Min over ``trials`` of the per-iteration ms of ``iters`` chained
    calls ``state = fn(state)`` from ``x0`` (a tensor), synchronised before
    and after each trial (host clock).  One untimed run of the loop comes
    first."""
    def run(s):
        for _ in range(iters):
            s = fn(s)
        if s.is_cuda:
            torch.cuda.synchronize(s.device)
        return s

    s = run(x0)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        s = run(s)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best
