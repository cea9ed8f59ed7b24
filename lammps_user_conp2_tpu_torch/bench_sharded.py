"""The sharded step's fixed cost on one card (the port of the JAX package's
``tools/bench_sharded.py``).

    python -m lammps_user_conp2_tpu_torch.bench_sharded [--cell 100k|mid]
        [--steps 20] [--pairs 2]

The d = 1 sharded program (``parallel/sharded.py`` over a one-rank NCCL
group: the same row slices, padding, per-rank tile cap and collectives as
at d > 1, each collective a one-rank NCCL call) beside the engine's eager
step (``Engine.step`` in a loop), both float32 from the same state: the
mid-size cell (7,296 atoms, factored Ewald, dense pairs) and the 100k cell
(99,362 atoms, PPPM, block list).  ``--pairs`` alternating (engine,
sharded) runs of ``--steps`` steps each, timed on the host clock between
two CUDA synchronisations; then the host syncs per step of each (the reads
``torch.cuda.set_sync_debug_mode`` reports) and a torch.profiler window
of 5 steps of each (device-busy ms, kernels and NCCL ms per step, the top
device kernels and host ops).  Prints, per cell,
``single_ms=... sharded_d1_ms=... overhead_pct=...`` (medians) with the
card's name and power limit.  Fails when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time
import warnings

import numpy as np
import torch

MID_CELL = dict(n_elyte=6144, nele_side=24, lz=60.0, lxy=50.0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cell_engine(cell: str, dev):
    """(engine, start positions) of ``cell`` on ``dev``: float64 set-up,
    float32 engine."""
    from . import workloads
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .step_breakdown_large import large_cell
    if cell == "100k":
        system, md, cfg = large_cell()
    elif cell == "mid":
        system, md, cfg = workloads.synthetic(**MID_CELL)
    else:
        raise ValueError(f"unknown cell {cell!r}")
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    return eng, workloads.near_wall_positions(system)


def host_syncs(step, st, steps: int) -> float:
    """Host syncs per step of ``steps`` calls of ``step`` from ``st``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                st = step(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught) / steps


def profile(step, st, steps: int = 5) -> dict:
    """A torch.profiler window of ``steps`` calls of ``step`` after one
    more: device-busy ms per step (the union of kernel intervals), kernels
    per step, NCCL kernels' ms per step, the top device kernels and the
    top host ops by self time (ms per step, calls per step)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from .step_breakdown import device_busy
    st = step(st)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            st = step(st)
        torch.cuda.synchronize()
    busy, by = device_busy(prof, steps)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(
        busy_ms=busy, kernels_per_step=sum(c for _, c in by.values()),
        nccl_ms=sum(ms for k, (ms, _) in by.items() if "nccl" in k.lower()),
        top_device=[(k[:72], ms, c) for k, (ms, c) in top],
        top_host=[(e.key[:72], e.self_cpu_time_total / steps / 1e3,
                   e.count / steps) for e in host[:8]])


def measure(eng, sheng, st0, steps: int = 20, pairs: int = 2) -> dict:
    """Alternating (engine, sharded) eager runs of ``steps`` steps from
    ``st0``: ms/step of each run, their medians, the overhead and the host
    syncs per step."""
    runs = {"single": eng.step, "sharded": sheng.step}
    st = st0
    for fn in runs.values():                     # warm-up: builds, plans
        st = fn(fn(st0))
    torch.cuda.synchronize()
    ms = {k: [] for k in runs}
    for _ in range(pairs):
        for name, fn in runs.items():
            st = st0
            t0 = time.perf_counter()
            for _ in range(steps):
                st = fn(st)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / steps * 1e3)
            if not torch.isfinite(st.energy):
                raise AssertionError(f"bench_sharded: {name} energy is not "
                                     "finite")
    single = float(np.median(ms["single"]))
    sharded = float(np.median(ms["sharded"]))
    return dict(single_ms=single, sharded_d1_ms=sharded,
                overhead_pct=(sharded / single - 1.0) * 100.0,
                single_runs_ms=ms["single"], sharded_runs_ms=ms["sharded"],
                steps=steps, pairs=pairs,
                host_syncs_per_step=dict(
                    single=host_syncs(eng.step, st0, steps),
                    sharded=host_syncs(sheng.step, st0, steps)),
                profile=dict(single=profile(eng.step, st0),
                             sharded=profile(sheng.step, st0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("100k", "mid"), action="append")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_sharded: no CUDA device visible")
    from .parallel import comm as C
    from .parallel.sharded import build_sharded_engine
    dev = torch.device("cuda:0")
    card = card_line()
    comm = C.init_group(dev, 0, 1, os.path.join(tempfile.mkdtemp(),
                                                "store"))
    try:
        for cell in args.cell or ["mid", "100k"]:
            eng, x0 = cell_engine(cell, dev)
            sheng = build_sharded_engine(eng, comm, x0=x0)
            r = measure(eng, sheng, eng.init_state(x0=x0), args.steps,
                        args.pairs)
            print(f"cell={cell} single_ms={r['single_ms']:.4f} "
                  f"sharded_d1_ms={r['sharded_d1_ms']:.4f} "
                  f"overhead_pct={r['overhead_pct']:.1f} host_syncs_per_step="
                  f"{r['host_syncs_per_step']}  [{card}]")
            for name, p in r["profile"].items():
                print(f"  {name}: busy {p['busy_ms']:.3f} ms/step, "
                      f"{p['kernels_per_step']:.0f} kernels/step, NCCL "
                      f"{p['nccl_ms']:.3f} ms/step; top device "
                      f"{p['top_device']}; top host {p['top_host']}")
    finally:
        C.close_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
