#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``lammps_user_conp2_tpu_torch``: setup_conp ->
build_engine -> init_state -> Engine.run) on the 7,296-atom synthetic
capacitor ``workloads.synthetic(6144, 24, lz=60, lxy=50)`` and exits
non-zero if any phase fails:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``csrc/`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, float32, at
     the cell's shapes: max|kernel - plain| / max|plain| <= 2e-5 per output,
     all finite; median times of both (CUDA events, after warm-up);
  4. the main path on the card: float64 setup, float32 run, 20 warm-up
     and 200 timed steps from positions near the walls; every kernel of the
     path must have launched; finite energy, neutral electrodes;
  5. 5 steps on the card (float32) against 5 steps on the CPU (float64,
     plain path) from the same positions.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  Needs no network and imports no jax.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

CELL = dict(n_elyte=6144, nele_side=24, lz=60.0, lxy=50.0)
KERNEL_TOL = 2e-5
OUT_DIR = "chiprun_out"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps=20, warmup=3) -> float:
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


def compare(name, got, ref):
    """max|got - ref| / max|ref| over each output pair; raises if any output
    is not finite or over KERNEL_TOL.  Returns (worst rel, worst abs)."""
    assert len(got) == len(ref), f"{name}: {len(got)} outputs != {len(ref)}"
    worst_rel = worst_abs = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: output {k} is not finite")
        d = float((g - r).abs().max())
        rel = d / max(float(r.abs().max()), 1e-30)
        print(f"    {name} output {k}: max abs err {d:.3e}, rel {rel:.3e}")
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: output {k} rel err {rel:.3e} > "
                                 f"{KERNEL_TOL}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, d)
    return worst_rel, worst_abs


def main() -> int:
    # ---- phase 1: versions and the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm

    card = gpu_line()
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"phase 1: card {card}")
    dev = torch.device("cuda:0")

    # ---- phase 2: build the kernels
    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc_ptxas.log"), "w") as fh:
        fh.write(build.BuildInfo.log)
    regs = [ln.strip() for ln in build.BuildInfo.log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"phase 2: kernels built in {secs:.2f} s "
          f"(nvcc {build.BuildInfo.seconds}) -> {build.BuildInfo.path.name}")
    for ln in regs:
        print(f"    ptxas: {ln}")

    # ---- set-up of the cell: float64 on the CPU, float32 run on the card
    system, md, cfg = workloads.synthetic(**CELL)
    x_near = workloads.near_wall_positions(system)
    t0 = time.perf_counter()
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    print(f"set-up: {system.natoms} atoms, Ne={conp.ne}, "
          f"g_ewald={conp.ksp.g_ewald:.6f}, K={conp.ksp.kcount}, "
          f"nxy={conp.fksp.nxy}, nz={conp.fksp.nz}, "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 3: each kernel against its plain version, float32
    rng = np.random.default_rng(1)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    x = torch.as_tensor(x_near, dtype=torch.float32, device=dev)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    zsort = z_perm(x, system.box, system.periodic)
    pkw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    results = {}
    for name, cf in (("pair_forces", None), ("pair_forces_conp", fuse)):
        kern = lambda: k4.pair_forces(x, q, eng.type_idx, eng.tables, None,
                                      zsort=zsort, conp_fuse=cf, **pkw)
        plain = lambda: k4.pair_forces_plain(x, q, eng.type_idx, eng.tables,
                                             None, conp_fuse=cf, **pkw)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare(name, got, plain())
        if cf is not None and not float(got[3].abs()) > 0.0:
            raise AssertionError("pair_forces_conp: ecorr is zero")
        results[name] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                             plain_ms=median_ms(plain))
    # at x_near the Gaussian correction (clamped at eta r = 5.8, r < 2.93 A)
    # is ~1e-14: hold the fused chain to its plain version where it is large
    x_close = torch.as_tensor(workloads.near_wall_positions(system, margin=3.0),
                              dtype=torch.float32, device=dev)
    got = k4.pair_forces(x_close, q, eng.type_idx, eng.tables, None,
                         conp_fuse=fuse, **pkw)
    torch.cuda.synchronize()
    compare("pair_forces_conp at margin 3 A", got,
            k4.pair_forces_plain(x_close, q, eng.type_idx, eng.tables, None,
                                 conp_fuse=fuse, **pkw))
    if not abs(float(got[3])) > 1e-3:
        raise AssertionError("pair_forces_conp: ecorr at margin 3 A is ~0")
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    bargs = (x, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
             conp.fo_rows, conp.type_t)
    kern = lambda: k5.b_realspace(*bargs, zsort=zsort, **bkw)
    plain = lambda: k5.b_realspace_plain(*bargs, **bkw)
    got = kern()
    torch.cuda.synchronize()
    rel, dabs = compare("b_realspace", (got,), (plain(),))
    if not float(got.abs().max()) > 0.0:
        raise AssertionError("b_realspace: all rows are zero")
    results["b_realspace"] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                  plain_ms=median_ms(plain))
    for name, r in results.items():
        print(f"phase 3: {name:17s} rel err {r['rel']:.3e} (tol {KERNEL_TOL}), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms  [{card}]")

    # ---- phase 4: the main path on the card
    k4.launches.reset()
    k5.launches.reset()
    torch.cuda.synchronize()
    st = eng.init_state(x0=x_near)
    st, _ = eng.run(st, 20, thermo_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, th = eng.run(st, 200, thermo_every=20)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / 200 * 1e3
    launches = {"pair_forces_conp": k4.launches.count,
                "b_realspace": k5.launches.count}
    print(f"phase 4: launches {launches}")
    for name, cnt in launches.items():
        if cnt < 221:
            raise AssertionError(f"phase 4: {name} launched {cnt} < 221 times")
    if not math.isfinite(float(st.energy)):
        raise AssertionError("phase 4: energy is not finite")
    qsum = float(st.q[:conp.ne].double().sum())
    if not abs(qsum) <= 1e-4:
        raise AssertionError(f"phase 4: electrode charge sum {qsum:.3e}")
    print(f"phase 4: T={float(th['temp'][-1]):.2f} K, pe={float(st.energy):.6g}, "
          f"qleft={float(th['qleft'][-1]):.6g}, sum q_ele={qsum:.3e}")
    print(f"phase 4: {ms_step:.4f} ms/step ({1e3 / ms_step:.1f} steps/s), "
          f"{system.natoms} atoms, float32  [{card}]")

    # ---- phase 5: card (float32) against CPU (float64, plain path)
    conp64 = setup_conp(system, md, cfg)
    eng64 = build_engine(system, md, conp64)
    s32 = eng.init_state(x0=x_near)
    s64 = eng64.init_state(x0=x_near)
    ne = conp.ne
    t0 = time.perf_counter()
    for i in range(5):
        s32 = eng.step(s32)
        s64 = eng64.step(s64)
        qe32 = s32.q[:ne].double().cpu()
        qe64 = s64.q[:ne]
        dq = float((qe32 - qe64).abs().max())
        qbound = 1e-4 * float(qe64.abs().max()) + 1e-6
        dpe = abs(float(s32.energy) - float(s64.energy)) / abs(float(s64.energy))
        df = float((s32.f.double().cpu() - s64.f).abs().max()) / float(
            s64.f.abs().max())
        print(f"phase 5: step {i + 1}: max|dq_ele| {dq:.3e} (bound "
              f"{qbound:.3e}), pe rel {dpe:.3e}, f rel {df:.3e}")
        if not (dq <= qbound and dpe <= 1e-4 and df <= 1e-3):
            raise AssertionError(f"phase 5: step {i + 1} outside the bounds")
    print(f"phase 5: 5 steps matched the float64 CPU run "
          f"({time.perf_counter() - t0:.1f} s)")

    replaces = {
        "pair_forces_conp": "lammps_user_conp2_tpu/ops/pallas/pair_kernel.py:316",
        "b_realspace": "lammps_user_conp2_tpu/ops/pallas/ele_rows_kernel.py:326"}
    source = {
        "pair_forces_conp": "lammps_user_conp2_tpu_torch/csrc/pair_kernel.cu",
        "b_realspace": "lammps_user_conp2_tpu_torch/csrc/ele_rows_kernel.cu"}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=results[name]["abs"],
                    max_rel_err=results[name]["rel"],
                    ms=results[name]["ms"], plain_ms=results[name]["plain_ms"])
               for name in ("pair_forces_conp", "b_realspace")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
