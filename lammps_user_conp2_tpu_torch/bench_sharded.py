"""The sharded step's fixed cost on one card (the port of the JAX package's
``tools/bench_sharded.py``).

    python -m lammps_user_conp2_tpu_torch.bench_sharded [--cell 100k|mid]
        [--steps 20] [--pairs 2]

The d = 1 sharded program (``parallel/sharded.py`` over a one-rank NCCL
group: the same row slices, padding, per-rank tile cap and collectives as
at d > 1, each collective a one-rank NCCL call) beside the engine, both
float32 from the same state, each eager (``step`` in a loop) and graphed
(``run``: CUDA graphs, the NCCL collectives captured in the sharded ones):
the mid-size cell (7,296 atoms, factored Ewald, dense pairs) and the 100k
cell (99,362 atoms, PPPM, block list).  ``--pairs`` alternating rounds of
the four runs of ``--steps`` steps each, timed on the host clock between
two CUDA synchronisations; whether the graphed sharded state equals the
eager sharded one and the engine's bit for bit; then the host syncs per
step of each (the reads ``torch.cuda.set_sync_debug_mode`` reports) and a
torch.profiler window of each run, timed itself with CUDA events
(device-busy ms and the busy share of that window, kernels and NCCL ms
per step, the top device kernels and host ops).  Prints, per cell,
``single_ms=... sharded_d1_ms=... single_graphed_ms=...
sharded_graphed_ms=...`` (medians) with the card's name and power limit.
Fails when no CUDA device is visible.
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


def _loop(step, st, steps: int):
    for _ in range(steps):
        st = step(st)
    return st


def runs(eng, sheng, steps: int) -> dict:
    """The four ways to take ``steps`` steps from a state, by name: the
    engine's eager step and its graphed ``run``, the sharded engine's eager
    step and its graphed ``run``."""
    return {
        "single": lambda st: _loop(eng.step, st, steps),
        "sharded": lambda st: _loop(sheng.step, st, steps),
        "single_graphed": lambda st: eng.run(st, steps, thermo_every=0)[0],
        "sharded_graphed": lambda st: sheng.run(st, steps,
                                                thermo_every=0)[0]}


def host_syncs(fn, st, steps: int) -> float:
    """Host syncs per step of ``fn(st)`` (``steps`` steps)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught) / steps


def profile(fn, st, steps: int) -> dict:
    """A torch.profiler window of ``fn(st)`` (``steps`` steps), timed
    itself with CUDA events: device-busy ms per step (the union of kernel
    intervals), the window's ms per step and the busy share over it,
    kernels per step, NCCL kernels' ms per step and device-to-device
    copies' (a one-rank NCCL all_gather captured in a graph is a copy),
    the top device kernels and the top host ops by self time (ms per step,
    calls per step)."""
    from .step_breakdown import device_busy, profiled
    prof, window = profiled(lambda: fn(st), steps)
    busy, by = device_busy(prof, steps)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(
        busy_ms=busy, window_ms=window, busy_share=busy / window,
        kernels_per_step=sum(c for _, c in by.values()),
        nccl_ms=sum(ms for k, (ms, _) in by.items() if "nccl" in k.lower()),
        dtod_ms=sum(ms for k, (ms, _) in by.items() if "DtoD" in k),
        top_device=[(k[:72], ms, c) for k, (ms, c) in top],
        top_host=[(e.key[:72], e.self_cpu_time_total / steps / 1e3,
                   e.count / steps) for e in host[:8]])


def same_bits(a, b) -> bool:
    return all(torch.equal(u, w) for u, w in ((a.x, b.x), (a.v, b.v),
                                              (a.q, b.q),
                                              (a.energy, b.energy)))


def measure(eng, sheng, st0, steps: int = 20, pairs: int = 2) -> dict:
    """``pairs`` alternating rounds of the four ``runs`` of ``steps`` steps
    from ``st0`` (after one run of each: the builds, plans and graph
    captures): ms/step of each run and their medians, the eager sharded
    step's overhead, the host syncs and a profile of each, and whether the
    graphed sharded run's state equals the eager sharded loop's and the
    engine's eager step's bit for bit (x, v, q, pe)."""
    fns = runs(eng, sheng, steps)
    for fn in fns.values():
        fn(st0)
    torch.cuda.synchronize()
    ms = {k: [] for k in fns}
    out = {}
    for _ in range(pairs):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            st = fn(st0)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / steps * 1e3)
            if not torch.isfinite(st.energy):
                raise AssertionError(f"bench_sharded: {name} energy is not "
                                     "finite")
            out[name] = st
    med = {k: float(np.median(v)) for k, v in ms.items()}
    return dict(single_ms=med["single"], sharded_d1_ms=med["sharded"],
                single_graphed_ms=med["single_graphed"],
                sharded_graphed_ms=med["sharded_graphed"],
                overhead_pct=(med["sharded"] / med["single"] - 1.0) * 100.0,
                runs_ms=ms, steps=steps, pairs=pairs,
                graphed_equals_eager=same_bits(out["sharded_graphed"],
                                               out["sharded"]),
                graphed_equals_single=same_bits(out["sharded_graphed"],
                                                out["single"]),
                host_syncs_per_step={k: host_syncs(fn, st0, steps)
                                     for k, fn in fns.items()},
                profile={k: profile(fn, st0, steps)
                         for k, fn in fns.items()})


def report(cell, r, card, tag="") -> None:
    """Print ``measure``'s result for a cell."""
    print(f"{tag}cell={cell} single_ms={r['single_ms']:.4f} "
          f"sharded_d1_ms={r['sharded_d1_ms']:.4f} "
          f"single_graphed_ms={r['single_graphed_ms']:.4f} "
          f"sharded_graphed_ms={r['sharded_graphed_ms']:.4f} "
          f"overhead_pct={r['overhead_pct']:.1f} ({r['steps']} steps x "
          f"{r['pairs']} alternating rounds: {r['runs_ms']}); graphed "
          f"sharded = eager sharded bit for bit: "
          f"{r['graphed_equals_eager']}, = Engine.step: "
          f"{r['graphed_equals_single']}; host syncs per step "
          f"{r['host_syncs_per_step']}  [{card}]")
    for name, p in r["profile"].items():
        print(f"{tag}cell={cell} {name}: device busy {p['busy_ms']:.4f} "
              f"ms/step of the profiled window's {p['window_ms']:.4f} "
              f"(busy share {p['busy_share']:.3f}), "
              f"{p['kernels_per_step']:.0f} kernels/step, NCCL "
              f"{p['nccl_ms']:.4f} ms/step, device-to-device copies "
              f"{p['dtod_ms']:.4f} ms/step; top device kernels (ms/step, "
              f"per step) {p['top_device']}; top host ops (self ms/step, "
              f"per step) {p['top_host']}")


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
            report(cell, r, card)
    finally:
        C.close_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
