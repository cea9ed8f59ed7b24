"""Per-layer time of one MD step of the port on a CUDA device.

    python -m lammps_user_conp2_tpu_torch.step_breakdown [--steps 200]

Builds the slice cell (``workloads.synthetic(6144, 24, lz=60, lxy=50)``,
float64 setup, float32 run) and times, with CUDA events and the median over
repeats: the whole step; the b-vector assembly (phase tables, electrolyte
structure factor, k-space readout, the real-space rows kernel, slab term);
the INV solve (A^-1 b and the charge update); the pair sweep kernel with the
fused CONP correction; the factored-Ewald forces.  Then a torch.profiler
trace of a short window gives the device-busy share of the step and the
device time by kernel name; the table and the Chrome trace go to
``chiprun_out/``.  Fails when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

CELL = dict(n_elyte=6144, nele_side=24, lz=60.0, lxy=50.0)


def _median_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_breakdown: no CUDA device visible")
    from . import workloads
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .ops import ewald_factored as ewf
    from .ops.kernels.pair_kernel import pair_forces

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    system, md, cfg = workloads.synthetic(**CELL)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    st = eng.init_state(x0=workloads.near_wall_positions(system))
    st, _ = eng.run(st, 20, thermo_every=0)
    x, q = st.x, st.q
    u = system.units()
    b, kcache = conp.b_vector_full(x, q)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    tabs, sre, sie, zsort = kcache

    layers = {
        "step": lambda: eng.step(st),
        "b_vector (tables+S+readout+K5+slab)": lambda: conp.b_vector_full(x, q),
        "inv_solve (A^-1 b + update)": lambda: conp.ainv @ b,
        "pair_sweep K4 (fused CONP)": lambda: pair_forces(
            x, q, eng.type_idx, eng.tables, None, box=system.box,
            periodic=system.periodic, cutoff=md.cutoff,
            g_ewald=conp.ksp.g_ewald, qqr2e=u.qqr2e, zsort=zsort,
            conp_fuse=fuse),
        "ewald_forces (cached tables)": lambda: ewf.energy_forces_cached(
            eng.fksp, q, tabs, sre, sie, conp.ne),
        "compute_forces (all)": lambda: eng.compute_forces(x, q, kcache),
        "solve_full (all)": lambda: conp.solve_full(x, q),
    }
    res = {name: _median_ms(fn) for name, fn in layers.items()}
    for name, ms in res.items():
        print(f"{name:40s} {ms:9.4f} ms  [{card}]")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2, _ = eng.run(st, args.steps, thermo_every=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"{'chained run ms/step (host clock)':40s} {wall:9.4f} ms  [{card}]")

    from torch.profiler import ProfilerActivity, profile
    nprof = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(s2, nprof, thermo_every=0)
        torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "step_trace.json"))
    # device kernels only: busy time is the union of their intervals
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    ivs = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur = 0.0, None
    for s, e in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    rows = sorted(((t, k, c) for k, (t, c) in by_name.items()), reverse=True)
    with open(os.path.join(args.out, "step_profile.txt"), "w") as fh:
        fh.write(card + "\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=40))
    print(f"profiled {nprof} steps: {len(kern) / nprof:.0f} device kernels "
          f"per step, busy {busy / nprof / 1e3:.4f} ms/step (union of kernel "
          f"intervals; the host clock runs slower under the profiler)")
    for us, key, cnt in rows[:15]:
        print(f"  {us / nprof / 1e3:9.4f} ms/step  {cnt / nprof:6.1f}x  "
              f"{key[:70]}")
    res["device_busy_ms_per_step"] = busy / nprof / 1e3
    res["device_busy_share_of_chained_step"] = busy / nprof / 1e3 / wall
    print(json.dumps(dict(card=card, layers_ms=res, run_ms_per_step=wall)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
