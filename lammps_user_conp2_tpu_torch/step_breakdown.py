"""Per-layer time of one MD step of the port on a CUDA device.

    python -m lammps_user_conp2_tpu_torch.step_breakdown [--steps 200]
        [--cell mid|il|bonded|unfused]

Builds a cell on the factored-Ewald path (float64 setup, float32 run):
``mid``, the 7,296-atom ``workloads.synthetic(6144, 24, lz=60, lxy=50)``
from ``near_wall_positions``; ``il``, ``workloads.il_onelayer(0)`` on the
3,776-atom file of ``workloads.write_il_data``; or ``bonded``, the same
deck on the 8,772-atom file ``write_il_data(n_pairs=1329, sheets=1,
nx=27, ny=16)``, where the block Verlet list takes the pair forces (K1
with the cations' special-bond exclusions); or ``unfused``, the ``il``
cell with ``MDConfig(use_pallas_pair=False)`` (the plain dense pair sweep
and the correction on its own, K6); data files are written to
``--out``.  Times, with CUDA events and the median over repeats: the whole
step; the b-vector assembly (phase tables, electrolyte structure factor,
k-space readout, the real-space rows, slab term); the INV solve (A^-1 b
and the charge update); the pair sweep with the fused CONP correction
(K4, or K1 on ``bonded``, or the plain dense sweep on ``unfused``); the
factored-Ewald forces; on the il decks the
SHAKE (K7) and RATTLE (K8) wrappers.  Then a torch.profiler trace of a
short window gives the device-busy share of the step, the device time by
kernel name and each hand kernel's device time per step; the table and
the Chrome trace go to ``chiprun_out/``.  Fails when no CUDA device is
visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

CELL = dict(n_elyte=6144, nele_side=24, lz=60.0, lxy=50.0)
BONDED = dict(n_pairs=1329, sheets=1, nx=27, ny=16)
# the CUDA kernels of each hand kernel, by name: K1, K2a, K7 and K8 both
# as redesigned and in their first design, so that a profile of either
# version sums the same function (K6 kept its kernel names)
KERNEL_PARTS = {
    "K1": ("block_pair_kernel", "block_pack", "block_sweep",
           "block_force_reduce", "block_pair_reduce"),
    "K2a": ("spread_mesh_kernel",),
    "K2b": ("spread_tiles_kernel",),
    "K3": ("gather3_kernel",),
    "K4": ("pair_schedule", "pair_sweep", "pair_reduce"),
    "K5": ("b_order_kernel", "b_rows_kernel"),
    "K6": ("corr_order_kernel", "corr_ele_kernel", "corr_ely_kernel",
           "corr_reduce"),
    "K7": ("shake_rows_kernel", "shake_kernel"),
    "K8": ("rattle_rows_kernel", "rattle_kernel"),
    "K9": ("window_gather_kernel",),
}


def kernel_of(name):
    """The hand kernel (K1 ... K9) a device kernel of that name belongs to,
    by the longest part it contains (K1's block_pair_reduce holds K4's
    pair_reduce), or None."""
    best = (0, None)
    for key, parts in KERNEL_PARTS.items():
        for p in parts:
            if p in name and len(p) > best[0]:
                best = (len(p), key)
    return best[1]


def kernel_ms(by_name):
    """{K: device ms per step} from ``device_busy``'s by-name table, for the
    hand kernels that ran."""
    out = {}
    for name, (t, _) in by_name.items():
        key = kernel_of(name)
        if key is not None:
            out[key] = out.get(key, 0.0) + t
    return {k: v for k, v in out.items() if v > 0.0}


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


def device_busy(prof, nsteps):
    """(busy ms per step, {kernel name: (ms per step, launches per step)})
    from a profile: busy time is the union of the device kernel
    intervals."""
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
    return busy / nsteps / 1e3, {k: (t / nsteps / 1e3, c / nsteps)
                                 for k, (t, c) in by_name.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--cell", choices=("mid", "il", "bonded", "unfused"),
                    default="mid")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_breakdown: no CUDA device visible")
    from . import workloads
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .ops import ewald_factored as ewf
    from .ops.neighbors import block_pair_forces
    from .ops.pairs import dense_pair_forces
    from .ops.kernels.pair_kernel import pair_forces
    from .ops.kernels.shake_kernel import rattle_velocities, shake_positions

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    if args.cell in ("il", "bonded", "unfused"):
        os.makedirs(args.out, exist_ok=True)
        kw, fname = ((BONDED, "il_8772.data") if args.cell == "bonded"
                     else ({}, "il_3776.data"))
        system, md, cfg = workloads.il_onelayer(0, data_path=(
            workloads.write_il_data(os.path.join(args.out, fname), **kw)))
        if args.cell == "unfused":
            md = dataclasses.replace(md, use_pallas_pair=False)
        x0 = None
    else:
        system, md, cfg = workloads.synthetic(**CELL)
        x0 = workloads.near_wall_positions(system)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    st = eng.init_state(x0=x0)
    st, _ = eng.run(st, 20, thermo_every=0)
    x, q, nbr = st.x, st.q, st.nbr
    u = system.units()
    lists = (nbr, eng.ncfg) if eng.ncfg is not None else ()
    b, kcache = conp.b_vector_full(x, q, *lists)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    tabs, sre, sie, zsort = kcache
    if md.use_pallas_pair is False:
        pair = ("dense pair sweep (plain, unfused)", lambda: dense_pair_forces(
            x, q, eng.type_idx, eng.tables, eng.exclusions, box=system.box,
            periodic=system.periodic, cutoff=md.cutoff,
            g_ewald=conp.ksp.g_ewald, qqr2e=u.qqr2e))
    elif eng.ncfg is None:
        pair = ("pair_sweep K4 (fused CONP)", lambda: pair_forces(
            x, q, eng.type_idx, eng.tables, None, box=system.box,
            periodic=system.periodic, cutoff=md.cutoff,
            g_ewald=conp.ksp.g_ewald, qqr2e=u.qqr2e, zsort=zsort,
            conp_fuse=fuse))
    else:
        pair = ("block sweep K1 (fused CONP)", lambda: block_pair_forces(
            eng.ncfg, nbr, x, q, eng.type_idx, eng.tables, eng.exclusions,
            g_ewald=conp.ksp.g_ewald, qqr2e=u.qqr2e, conp_fuse=fuse))
        excl = eng.exclusions
        print(f"{system.natoms} atoms, block list: {nbr.bun.shape[0]} "
              f"blocks, U={nbr.bun.shape[1]}, exclusions "
              f"{None if excl is None else tuple(excl[0].shape)}  [{card}]")

    layers = {
        "step": lambda: eng.step(st),
        "b_vector (tables+S+readout+rows+slab)": lambda: conp.b_vector_full(
            x, q, *lists),
        "inv_solve (A^-1 b + update)": lambda: conp.apply_ainv(b),
        pair[0]: pair[1],
        "ewald_forces (cached tables)": lambda: ewf.energy_forces_cached(
            eng.fksp, q, tabs, sre, sie, conp.ele_rows),
        "compute_forces (all)": lambda: eng.compute_forces(x, q, kcache,
                                                           *lists[:1]),
        "solve_full (all)": lambda: conp.solve_full(x, q, *lists),
    }
    if eng.cons is not None:
        kw = dict(box=system.box, periodic=system.periodic)
        xd = x + md.dt * st.v
        layers["shake K7"] = lambda: shake_positions(eng.cons, xd, x, md.dt,
                                                     **kw)
        layers["rattle K8"] = lambda: rattle_velocities(eng.cons, x, st.v,
                                                        **kw)
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
    busy, by_name = device_busy(prof, nprof)
    with open(os.path.join(args.out, "step_profile.txt"), "w") as fh:
        fh.write(card + "\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=40))
    nk = sum(c for _, c in by_name.values())
    print(f"profiled {nprof} steps: {nk:.0f} device kernels per step, busy "
          f"{busy:.4f} ms/step (union of kernel intervals; the host clock "
          f"runs slower under the profiler)")
    for key, (ms, cnt) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.4f} ms/step  {cnt:6.1f}x  {key[:70]}")
    for key, ms in kernel_ms(by_name).items():
        res[f"{key}_device_ms_per_step"] = ms
        print(f"  {key} device time {ms:.4f} ms/step  [{card}]")
    res["device_busy_ms_per_step"] = busy
    res["device_busy_share_of_chained_step"] = busy / wall
    print(json.dumps(dict(card=card, cell=args.cell, natoms=system.natoms,
                          layers_ms=res, run_ms_per_step=wall)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
