"""Per-layer time of one step of the 100k-atom production cell on a CUDA
device.

    python -m lammps_user_conp2_tpu_torch.step_breakdown_large [--steps 50]
        [--pair auto|cell|tile]

The cell is the JAX package's ``tools/bench_large.py`` default:
``workloads.synthetic(98304, 23, lz=240, lxy=120)`` (99,362 atoms, two
23x23 electrode walls), PPPM, INV, ``pair_path`` from ``--pair`` (JAX
``tools/step_breakdown_large.py:53``; "auto", the default, is the block
Verlet list on the card; "cell" the cell list; "tile" K4 over the live
tile pairs of k-d bricks), float64 setup, float32 run from
``near_wall_positions``.  Times, with CUDA events (median over repeats)
and the profiler's device time (union of kernel intervals over 5 calls):
the whole step; the Verlet list rebuild (list path); the mesh tile
assignment (sort) and the slot refresh (per step: the slots' own sort on
the cell path); spread + z-DFT (K2a, ``_spread_rhok_tiled``); Poisson +
z-IDFT (``pppm_energy_u_zbin``); the force gather (K3,
``gather3_ad_zbin``); the pair sweep (K1 with the correction fused, the
cell sweep, or K4 with the correction fused; on the tile path also the
k-d order and the live tile pairs alone); the correction on its own (K6,
cell path); the b vector; the INV solve.  Then a
``torch.profiler`` trace of a short window, timed itself with CUDA
events, gives the device-busy share (over that window), the device time by kernel name and each hand kernel's device time per
step (K1, K2a, ...); the table and the Chrome trace go to
``chiprun_out/``.  Fails when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from .step_breakdown import _median_ms, device_busy, kernel_ms, profiled

CELL = dict(n_elyte=98304, nele_side=23, lz=240.0, lxy=120.0)


def large_cell(pair_path="auto"):
    """(system, md, cfg) of the 100k cell: the synthetic capacitor with
    PPPM and INV (``tools/bench_large.py`` defaults) on ``pair_path``."""
    from . import workloads
    from .utils.config import KSpaceStyle, Solver
    system, md, cfg = workloads.synthetic(**CELL)
    cfg = dataclasses.replace(cfg, solver=Solver.INV, kspace=KSpaceStyle.PPPM)
    md = dataclasses.replace(md, pair_path=pair_path,
                             kspace_style=KSpaceStyle.PPPM)
    return system, md, cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--pair", default="auto", choices=("auto", "cell", "tile"),
                    help="the pair path (MDConfig.pair_path)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_breakdown_large: no CUDA device visible")
    from . import workloads
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .ops import neighbors, pppm
    from .ops.kernels import pair_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    system, md, cfg = large_cell(args.pair)
    t0 = time.perf_counter()
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    setup_s = time.perf_counter() - t0
    st = eng.init_state(x0=workloads.near_wall_positions(system))
    st, _ = eng.run(st, 10, thermo_every=0)
    torch.cuda.synchronize()
    x, q, nbr, tasg = st.x, st.q, st.nbr, st.tasg
    grid = eng.pppm_grid
    u = system.units()
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    slots = eng._slots(x, q_elyte, tasg)
    rhok = pppm._spread_rhok_tiled(grid, x, q_elyte, slots)
    _, uz = pppm.pppm_energy_u_zbin(grid, rhok, system.natoms)
    b, _ = conp.b_vector_full(x, q, nbr, eng.ncfg, tasg)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    geom = pppm._tile_geometry(grid, system.natoms)
    if eng.ncfg is not None:
        path = f"K={eng.ncfg.k_max}, U={eng.ncfg.u_max}"
    elif eng.cell_grid is not None:
        path = f"cell list {eng.cell_grid}"
    else:
        path = f"tile path, order {eng.pair_order}, pair_cap {eng.pair_cap}"
    print(f"{system.natoms} atoms, Ne={conp.ne}, mesh {grid.shape}, {geom}, "
          f"{path}, setup {setup_s:.2f} s [{card}]")

    layers = {"step": lambda: eng.step(st)}
    if eng.ncfg is not None:
        layers["list rebuild (block list)"] = (
            lambda: neighbors.build_neighbor_list(eng.ncfg, x, eng.tables,
                                                  eng.type_idx))
    layers.update({
        "tile assign (sort)": lambda: pppm.tile_assign(grid, x),
        ("tile slot refresh" if tasg is not None else
         "tile slots (per-step sort)"): lambda: eng._slots(x, q_elyte, tasg),
        "spread + z-DFT (K2a)": lambda: pppm._spread_rhok_tiled(
            grid, x, q_elyte, slots),
        "poisson + z-IDFT": lambda: pppm.pppm_energy_u_zbin(
            grid, rhok, system.natoms),
        "gather (K3)": lambda: pppm.gather3_ad_zbin(grid, uz, x, slots)})
    if eng.ncfg is not None:
        layers["block sweep (K1, fused CONP)"] = (
            lambda: neighbors.block_pair_forces(
                eng.ncfg, nbr, x, q, eng.type_idx, eng.tables, eng.exclusions,
                g_ewald=conp.ksp.g_ewald, qqr2e=u.qqr2e, conp_fuse=fuse))
    elif eng.cell_grid is not None:
        layers["cell sweep (plain)"] = lambda: eng._pair(x, q, None, nbr)
        layers["correction (K6)"] = lambda: eng._correction(x, q, None, nbr)
    else:
        order = lambda: pair_kernel.order_atoms(x, system.box,
                                                system.periodic, "kd")
        perm = order()[0]
        layers["k-d order"] = order
        layers["live tile pairs (mask, items)"] = (
            lambda: pair_kernel.tile_items(
                x, perm, box=system.box, periodic=system.periodic,
                cutoff=md.cutoff, pair_cap=eng.pair_cap, conp_fuse=fuse))
        layers["tile sweep (order, items, K4 fused)"] = (
            lambda: eng._pair(x, q, None, nbr))
    layers.update({
        "b vector (zplanes + list rows + slab)": lambda: conp.b_vector_full(
            x, q, nbr, eng.ncfg, tasg),
        "INV solve (A^-1 b)": lambda: conp.apply_ainv(b),
        "solve_full (all)": lambda: conp.solve_full(x, q, nbr, eng.ncfg,
                                                    tasg),
        "compute_forces (all, cache from the solve)": lambda: eng.compute_forces(
            x, q, conp.elyte_kcache(x, q, tasg), nbr, tasg)})
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res, dev_ms = {}, {}
    for name, fn in layers.items():
        res[name] = _median_ms(fn, reps=10 if "rebuild" in name else 30)
        with profile(activities=acts) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dev_ms[name] = device_busy(prof, 5)[0]
        print(f"{name:44s} {res[name]:9.4f} ms events, {dev_ms[name]:9.4f} "
              f"ms device  [{card}]", flush=True)

    torch.cuda.synchronize()
    r0 = eng.rebuilds
    t0 = time.perf_counter()
    s2, _ = eng.run(st, args.steps, thermo_every=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"{'chained run ms/step (host clock)':44s} {wall:9.4f} ms, "
          f"{eng.rebuilds - r0} list or mesh-tile rebuilds in {args.steps} "
          f"steps  [{card}]")

    nprof = 20
    prof, window = profiled(lambda: eng.run(s2, nprof, thermo_every=0),
                            nprof)
    os.makedirs(args.out, exist_ok=True)
    sfx = "" if args.pair == "auto" else "_" + args.pair
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"step_trace_large{sfx}.json"))
    busy, by_name = device_busy(prof, nprof)
    with open(os.path.join(args.out, f"step_profile_large{sfx}.txt"),
              "w") as fh:
        fh.write(card + "\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=50))
    nk = sum(c for _, c in by_name.values())
    print(f"profiled {nprof} steps: {nk:.0f} device kernels per step, busy "
          f"{busy:.4f} ms/step (union of kernel intervals) of the profiled "
          f"window's {window:.4f} ms/step (CUDA events): busy share "
          f"{busy / window:.3f}; unprofiled {wall:.4f} ms/step")
    for key, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:9.4f} ms/step  {cnt:6.1f}x  {key[:70]}")
    for key, ms in kernel_ms(by_name).items():
        res[f"{key}_device_ms_per_step"] = ms
        print(f"  {key} device time {ms:.4f} ms/step  [{card}]")
    res["device_busy_ms_per_step"] = busy
    res["profiled_window_ms_per_step"] = window
    res["device_busy_share"] = busy / window
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    summary = json.dumps(dict(card=card, pair_path=args.pair, layers_ms=res,
                              layers_device_ms=dev_ms, run_ms_per_step=wall,
                              device_ms_by_kernel={k[:60]: v[0]
                                                   for k, v in top}))
    with open(os.path.join(args.out, f"step_breakdown_large{sfx}.json"),
              "w") as fh:
        fh.write(summary + "\n")
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
