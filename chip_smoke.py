#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's seven paths (six main paths through
``lammps_user_conp2_tpu_torch``: setup_conp -> build_engine -> init_state ->
Engine.run; and the window gather probe ``exp_vmem_gather.run_probe``)
and exits non-zero if any phase fails.

Mid-size path, the 7,296-atom synthetic capacitor
``workloads.synthetic(6144, 24, lz=60, lxy=50)`` (factored Ewald, dense
pair sweep K4, electrode rows K5):

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``csrc/`` (nvcc, sm_90a, one process per
     source);
  3. K4 and K5 against their plain PyTorch versions on the card, float32,
     at the cell's shapes: max|kernel - plain| / max|plain| <= 2e-5 per
     output, all finite, and two launches bit-identical; median times of
     both (CUDA events); the pairs K4's tile-pair schedule tests beside
     the pairs in range;
  4. the main path on the card: float64 setup, float32 run, 10 warm-up and
     100 timed steps from positions near the walls; K4 and K5 must have
     launched every step; finite energy, neutral electrodes;
  5. 3 steps on the card (float32) against 3 steps on the CPU (float64,
     plain path) from the same positions.

Production path, the 99,362-atom cell of ``tools/bench_large.py``
(``step_breakdown_large.large_cell``: PPPM, INV, block Verlet list, tiled
z-binned mesh):

  6. float64 setup, float32 engine on the card;
  7. K1 (block sweep, fused and unfused), K2a (spread) and K3 (gather)
     against their plain versions at the cell's shapes, as in phase 3; K1's
     fused correction also at ions 3 A from the walls, where |ecorr| > 1e-3;
     K1 and K2a bit-identical across two launches, K1's packed rows equal
     to their plain version, K1's work items and K2a's kept atoms per tile
     and staging passes printed; K1's and K2a's host and device times;
  8. the main path: 10 warm-up and 100 timed steps from positions near the
     walls; K1, K2a and K3 must have launched every step and the Verlet
     list must have been rebuilt in the timed window; finite energy,
     neutral electrodes;
  9. 2 steps on the card (float32) against 2 steps on the CPU (float64,
     plain path, per-atom Verlet list) with phase 5's bounds.

Ionic-liquid deck path, ``workloads.il_onelayer(0)`` on the 3,776-atom
file of ``workloads.write_il_data`` (BMI-PF6 between graphene walls; the
mid-size path with SHAKE/RATTLE, K7 and K8):

 10. write the data file into the output directory, float64 setup,
     float32 engine on the card: no Verlet list, cluster tables on the
     card;
 11. K7 (SHAKE) and K8 (RATTLE) against their plain versions, float32, at
     the cell's shapes, from a drift step of the deck's velocities plus
     noise with one cation across the periodic x face: max|kernel - plain|
     = 0 on x, dv and v, two launches bit-identical; the constraint
     residual after K7 no worse than after the plain version; median
     times, device time per call, the CUDA kernels in one call (one each),
     the chain floor (the first cluster alone, m = 1: device time per
     launch of 100 launches replayed in a CUDA graph; ``floor_ms``) and
     the phase-clock split measured while the kernels were designed
     (K78_PHASE_SPLIT).  K4 (with the
     cations' special-bond exclusions, fused correction) and K5 against
     their plain versions at this cell's shapes (2e-5), two launches
     bit-identical, timed with their bounds (``ms_il``, ``bound_ms_il`` in
     the kernels line), K4's tested and in-range pairs;
 12. the main path: 11 warm-up and 100 timed steps; K4, K5, K7 and K8 must
     have launched every step (111 times; K4 and K5 once more in
     init_state); finite energy, neutral electrodes; the angles' 1-3
     distances within ShakeConfig.tol (1e-4) and the bonds within twice
     the residual of the float64 reference at the same step (IL_F64_BONDS);
 13. 11 steps on the card (float32) against 11 steps on the CPU (float64,
     plain path): phase 5's bounds over the first 3, and at step 11, where
     the cations have bent, each slot's residual within twice the CPU's.

Bonded block cell, ``workloads.il_onelayer(0)`` on the 8,772-atom file of
``write_il_data(n_pairs=1329, sheets=1, nx=27, ny=16)`` (the decks'
density over a 66.4 x 68.2 A face, Ne = 3,456; more than 8,192 atoms in a
box four cutoffs wide, so ``pair_path="auto"`` takes the block Verlet list
on the card): K1 with the cations' special-bond exclusions applied per
pair, with SHAKE/RATTLE; the factored Ewald stays under KXY_CHUNK (409 xy
vectors):

 14. write the data file, set-up: the block list (B = 8) and exclusions;
 15. K1 with exclusions, fused and unfused, against its plain version
     (2e-5), two launches bit-identical, timed with its host and device
     times: K1's line in the kernels list comes from here (its 100k
     figures beside them, with the suffix ``_100k``);
 16. the main path: 11 warm-up and 100 timed steps; K1, K7 and K8 launched
     every step; finite energy, neutral electrodes;
 17. 3 steps on the card (float32) against 3 steps on the CPU (float64,
     per-atom Verlet list) with phase 5's bounds.

Unfused ionic-liquid cell, the phase-10 deck with
``MDConfig(use_pallas_pair=False)``: the plain dense pair sweep and the
CONP correction swept on its own (K6), as a user who asks for the unfused
path gets it:

 18. set-up; K6, which searches the correction's own range r_corr (2.93
     A of the 16 A cutoff), against its plain version over the full cutoff
     at this cell's shapes (2e-5 on the forces and ecorr), two launches
     bit-identical: at x0, where the ions sit beyond the clamped Gaussian
     and every term is 0 (and K6's two z orders against their plain
     version), with the ions' z mapped to 1 A off the inner sheets, and
     with the anions nearest each wall 1.2 A off it, where ecorr is not;
     timed at both (CUDA events and device time);
 19. the main path: 11 warm-up and 100 timed steps; K5, K6, K7 and K8
     launched every step, K4 never;
 20. 3 steps on the card against 3 on the CPU (float64) with phase 5's
     bounds, from up to 8 anions next to each wall (5 A apart in x and y)
     moved 2 A off its inner sheet (``workloads.near_sheet_positions``),
     so that the engine's own
     K6 call sees nonzero terms: the correction energy the engine computed
     at step 0 is nonzero and within 1e-3 of the CPU's.

Full-mesh production cell, ``synthetic(98304, 40, lz=240, lxy=120)`` with
PPPM, INV and ``ConpConfig(mobile_electrodes=True)`` (101,504 atoms, 40 x
40 sites per wall, Ne = 3,200): mobile (as rough or porous) electrodes are
not read through z planes, so the electrodes are re-spread onto the full
mesh every step through ``spread()``, which Ne (nx ny + nz) above 32 M
sends down the tiled path (K2b and the overlap-add), and the b vector is
read through the full inverse FFT and the tiled gather:

 21. set-up (the mesh, Ne (nx ny + nz), the electrode tile geometry); K2b
     against its plain version at the electrode spread's shapes (2e-5),
     timed;
 22. the main path: 10 warm-up and 100 timed steps from positions near the
     walls; K1, K2a, K2b and K3 launched every step, >= 1 list rebuild;
 23. 2 steps on the card against 2 on the CPU (float64) with phase 9's
     bounds.

Every main path runs ``Engine.run``, which replays the step as CUDA
graphs; after each main-path phase a graph phase (4b, 8b, 12b, 16b, 19b,
22b) holds the replayed step to the eager one (``Engine.step`` in a loop)
from one state, 100 steps a run: five alternating (eager, graphed) pairs
of ms/step on the host clock; eager vs eager, graphed vs eager and graphed
vs graphed on x, v, q and pe, bit for bit at every cell (no step path adds
floats with atomics); the host
syncs of a graphed run (none per step on the dense paths, one on the list
paths); and a torch.profiler window of 100 replayed steps from the same
state (so with the timed runs' list rebuilds): the device-busy share of
the graphed step and each hand kernel's device time per launch
(``device_ms_replay`` in the kernels line, per cell; the profile tables go
to chiprun_out/graph_profile_<cell>.txt, the records to
chiprun_out/graph_phases.json and to the {"graphs": [...]} line).

Window gather probe, ``exp_vmem_gather`` (K9: R window gathers per lane,
summed, from a window staged in shared memory) at its shapes (nb, W) =
(32, 2048), (32, 4096), (8, 8192), and the global-memory gather
``exp_gather_chunk`` it is measured against:

 24. K9 against its plain version at the three shapes, R = 8, 1 and 3,
     bit for bit (both add the same float32 terms in order); two launches
     bit-identical, one CUDA kernel per call; at each shape and R = 8 and
     1 its ms per call between CUDA events and its device ms per call
     (torch.profiler) beside the shape's bound (``k9_times.measure``; the
     ``shapes`` list of its kernels line), and at R = 1, where the
     function is one ``torch.gather``, K9 against that call bit for bit
     and faster than it on the device;
 25. the probe's chained steps at the three shapes (ms, ns/row,
     ns/element); K9 must have launched; then the global-memory gather's
     ns/row (random and local indices, one-shot and in 4/8/16 chunks by
     indexing, and one-shot with each row gathered as one 16-byte
     element); both one-shot sums agree (1e-5).

The bonds' residual is not ShakeConfig.tol's: at the decks' 180-degree
angle the three constraint directions of a straight cation are parallel,
so SHAKE corrects along the axis only; the bend that the forces make stays,
and with the 1-3 distance held the bent cation's bonds come out long, by
about bend^2 / 2 in r^2.  It follows the bend, which the angle potential and
the temperature bound (``shake_residual.py``;
tests/test_torch_shake_residual.py holds both packages to it over 800
steps).

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are the median of
single calls, each between two CUDA events, as in every earlier run of
this script.  K1, K2a, K4 and K5 also carry ``host_ms`` (the wrapper's
host time per call, on the host clock) and ``device_ms`` (their CUDA
kernels' device time per call, torch.profiler: K1's packing, sweep and
reductions, K2a's one, K4's three, K5's two, the compaction of the z
order to the electrolyte included); K7 and K8 ``device_ms`` (one kernel
each), ``kernels_per_call`` and ``floor_ms``.  The il cell's figures carry
the suffix ``_il``.  Every kernel's line carries its bound: the larger
of the bytes it must move (its input tensors read once, its outputs
written once) over 3.35 TB/s and the operations this run's data needs
(per-kernel counts below) over 67 TFLOP/s, float32 outside the tensor
cores (H100 SXM, NVIDIA's data sheet).  No single PyTorch call computes
any of these functions, so ``library_ms`` is null, with one exception: K9 at R = 1 is
``torch.gather(win, 1, idx)``, whose time is K9's ``library_ms``, beside
K9's own at R = 1 (``ms_r1``).  The line before the last is {"kernels": [...]},
the last line {"ok": true, "device": {...}}.  Needs no network and imports
no jax.
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
T_START = time.perf_counter()
KERNEL_TOL = 2e-5
SHAKE_TOL = 5e-5          # tools/kernel_oracle.py:278-279
# where a K7 and a K8 update spent their cycles at the il cell, from a
# clock64 phase probe of the kernels while they were redesigned (not kept)
K78_PHASE_SPLIT = (
    "K7/K8 phase clocks (clock64 cycles of the median thread at the il cell, "
    "NVIDIA H100 80GB HBM3, 700 W): the first K7 loads in 2,130, runs its "
    "36 updates in 15,641 (435 each) and writes in 1,723; the redesign "
    "loads in 1,994, updates in 4,301 (119 each: 431 with runtime columns "
    "and the exact minimum image, 310 with compile-time columns, 234 "
    "hoisted) and writes in 925 (1,338 dividing dv by dt); K8 loads in "
    "1,622 and updates in 3,160 (88 each, 187 with runtime columns)")
# the bonds' residual max|r^2 - d^2|/d^2 at step 111 of il_onelayer(0) on
# the default write_il_data file, CPU float64: ``python -m
# lammps_user_conp2_tpu_torch.shake_residual --cell full --device cpu
# --dtype float64 --steps 111``
IL_F64_BONDS = 2.996e-3
OUT_DIR = "chiprun_out"
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# operations per unit of work, for the bounds: a pair inside the cutoff
# (LJ and the A&S erfc Coulomb, force and energy, the fused Gaussian
# correction; K4's counted once, as the function needs it: the reaction is
# its negative; K1's per entry of its neighbour list); an
# electrode-electrolyte pair inside the Coulomb cutoff of a b row; an
# atom's order-5 spread (weights by Horner, 125 products) and gather
# (weights and derivatives, three 125-term sums); one SHAKE and one RATTLE
# slot update; an (electrode, electrolyte) pair of the separate correction
# sweep, counted once (K6 evaluates each pair twice, once per side, but the
# function needs it once: the reaction is its negative)
PAIR_FLOPS = 60
B_ROW_FLOPS = 40
SPREAD_FLOPS = 400
GATHER_FLOPS = 1000
SHAKE_SLOT_FLOPS = 45
RATTLE_SLOT_FLOPS = 25
CORR_PAIR_FLOPS = 45


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


def host_ms(fn, reps=50) -> float:
    """Host time per call of a kernel wrapper: ``reps`` calls enqueued back
    to back on the host clock, before the synchronise.  Where it exceeds
    the device time, a CUDA-event time of one call is the host's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def device_ms(fn, parts, reps=20, tag=None) -> float:
    """Device time per call of the CUDA kernels whose names contain one of
    ``parts`` (torch.profiler over ``reps`` calls): per part, the median
    record times the records per call, rounded (the profiler can drop
    records, which a plain sum over ``reps`` would read as a faster
    kernel); with ``tag``, each part's share and record count is
    printed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rec = {p: [] for p in parts}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            for p in parts:
                if p in e.name:
                    rec[p].append(e.time_range.elapsed_us() / 1e3)
    per = {p: float(np.median(t)) * max(1, round(len(t) / reps)) if t
           else 0.0 for p, t in rec.items()}
    if tag:
        print(f"    {tag}: device ms per call " + ", ".join(
            f"{p} {per[p]:.4f} ({len(rec[p])} records)" for p in parts))
    return sum(per.values())


# kernels line name -> (hand kernel id, launch counter name)
KERNEL_IDS = {
    "pair_forces_conp": ("K4", "pair_forces"),
    "b_realspace": ("K5", "b_realspace"),
    "block_pair_conp": ("K1", "block_pair"),
    "spread_mesh": ("K2a", "spread_mesh"),
    "spread_tiles": ("K2b", "spread_tiles"),
    "gather3": ("K3", "gather3"),
    "conp_correction": ("K6", "conp_correction"),
    "shake_positions": ("K7", "shake_positions"),
    "rattle_velocities": ("K8", "rattle_velocities"),
    "window_gather": ("K9", "window_gather"),
}
# the CUDA kernels of each redesigned wrapper, for ``device_ms``
K4_PARTS = ("pair_schedule", "pair_sweep", "pair_reduce")
K5_PARTS = ("b_order_kernel", "b_rows_kernel")
K1_PARTS = ("block_pack", "block_sweep", "block_force_reduce",
            "block_pair_reduce")
K2A_PARTS = ("spread_mesh_kernel",)
K6_PARTS = ("corr_order_kernel", "corr_ele_kernel", "corr_ely_kernel",
            "corr_reduce")
# K7 and K8 as redesigned (one launch per call) and in their first design
K7_PARTS = ("shake_rows_kernel", "shake_kernel")
K8_PARTS = ("rattle_rows_kernel", "rattle_kernel")


def compare(name, got, ref, tol=KERNEL_TOL):
    """max|got - ref| / max|ref| over each output pair; raises if any output
    is not finite or over ``tol``.  Returns (worst rel, worst abs)."""
    assert len(got) == len(ref), f"{name}: {len(got)} outputs != {len(ref)}"
    worst_rel = worst_abs = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: output {k} is not finite")
        d = float((g - r).abs().max())
        rel = d / max(float(r.abs().max()), 1e-30)
        print(f"    {name} output {k}: max abs err {d:.3e}, rel {rel:.3e}")
        if not rel <= tol:
            raise AssertionError(f"{name}: output {k} rel err {rel:.3e} > "
                                 f"{tol}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, d)
    return worst_rel, worst_abs


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples and lists flattened)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def bound(inputs, outputs, flops) -> dict:
    """bound_ms / bound_by for a kernel that reads ``inputs`` and writes
    ``outputs`` once and does ``flops`` float32 operations."""
    t_bytes = nbytes(inputs, outputs) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def pairs_within(xa, xb, box, periodic, rc2, same=False) -> int:
    """Ordered pairs (a, b) with |mi(xa - xb)|^2 < rc2 (a != b if same)."""
    n = 0
    for i0 in range(0, xa.shape[0], 1024):
        d = xa[i0:i0 + 1024, None, :] - xb[None, :, :]
        for ax in range(3):
            if periodic[ax]:
                d[..., ax] -= box[ax] * torch.round(d[..., ax] / box[ax])
        n += int(((d * d).sum(-1) < rc2).sum())
    return n - (xa.shape[0] if same else 0)


def same_bits(name, got, again):
    """Raises unless two launches on the same input gave the same bits."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two launches differ")
    print(f"    {name}: two launches bit-identical")


def k4_pairs(tag, k4, x, zsort, system, cutoff, card, m=0) -> int:
    """Unordered pairs within the cutoff; printed beside the pairs K4's
    tile-pair schedule tests (counted in Python from the schedule) and the
    CTAs of the fused sweep with m special partners per atom."""
    sched = k4.tile_schedule_plain(zsort[1], x.shape[0], box=system.box,
                                   periodic=system.periodic, cutoff=cutoff)
    tested = k4.schedule_pairs(sched, x.shape[0])
    inrange = pairs_within(x, x, system.box, system.periodic, cutoff ** 2,
                           same=True) // 2
    nt = sched.hi.shape[0]
    ctas = k4.sweep_ctas(True, m, nt * (nt + 1) // 2)
    print(f"{tag}: K4 schedule {int(sched.off[-1])} of {nt * (nt + 1) // 2} "
          f"tile pairs, {tested} unordered pairs tested, {inrange} in range "
          f"({100.0 * inrange / max(tested, 1):.1f}%), fused sweep on {ctas} "
          f"CTAs of 8 warps  [{card}]")
    return inrange


def agree(tag, s32, s64, ne):
    """Phase 5/9 bounds between a card float32 and a CPU float64 state."""
    qe32 = s32.q[:ne].double().cpu()
    qe64 = s64.q[:ne]
    dq = float((qe32 - qe64).abs().max())
    qbound = 1e-4 * float(qe64.abs().max()) + 1e-6
    dpe = abs(float(s32.energy) - float(s64.energy)) / abs(float(s64.energy))
    df = float((s32.f.double().cpu() - s64.f).abs().max()) / float(
        s64.f.abs().max())
    print(f"{tag}: max|dq_ele| {dq:.3e} (bound {qbound:.3e}), pe rel "
          f"{dpe:.3e}, f rel {df:.3e}")
    if not (dq <= qbound and dpe <= 1e-4 and df <= 1e-3):
        raise AssertionError(f"{tag}: outside the bounds")


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
    pairs = k4_pairs("phase 3", k4, x, zsort, system, md.cutoff, card)
    for name, cf in (("pair_forces", None), ("pair_forces_conp", fuse)):
        kern = lambda: k4.pair_forces(x, q, eng.type_idx, eng.tables, None,
                                      zsort=zsort, conp_fuse=cf, **pkw)
        plain = lambda: k4.pair_forces_plain(x, q, eng.type_idx, eng.tables,
                                             None, conp_fuse=cf, **pkw)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare(name, got, plain())
        same_bits(name, got, kern())
        if cf is not None and not float(got[3].abs()) > 0.0:
            raise AssertionError("pair_forces_conp: ecorr is zero")
        print(f"    {name}: evdwl {float(got[1]):.6f} / {float(plain()[1]):.6f}"
              f", ecoul {float(got[2]):.6f} (kernel / plain)")
        results[name] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                             plain_ms=median_ms(plain),
                             host_ms=host_ms(kern),
                             device_ms=device_ms(kern, K4_PARTS, tag=name))
        results[name].update(bound(
            (x, q, eng.type_idx, eng.tables, zsort, cf), got,
            PAIR_FLOPS * pairs))
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
    same_bits("b_realspace", (got,), (kern(),))
    if not float(got.abs().max()) > 0.0:
        raise AssertionError("b_realspace: all rows are zero")
    results["b_realspace"] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                  plain_ms=median_ms(plain),
                                  host_ms=host_ms(kern),
                                  device_ms=device_ms(kern, K5_PARTS))
    results["b_realspace"].update(bound(
        (bargs, zsort), got, B_ROW_FLOPS * pairs_within(
            x[:conp.ne], x[conp.ne:], system.box, system.periodic,
            conp.cut_coulsq)))
    report("phase 3", results, tuple(results), card)

    # ---- phase 4: the main path on the card
    counters = {"pair_forces_conp": k4.launches, "b_realspace": k5.launches}
    _, _, _, launches = main_run("phase 4", eng, dict(x0=x_near), 10, 100,
                                 counters, conp.ne, card)
    graph_phase("phase 4b", "mid", eng, dict(x0=x_near), card)

    # ---- phase 5: card (float32) against CPU (float64, plain path)
    card_vs_cpu("phase 5", eng, system, md, cfg, 3, x0=x_near)

    launches.update(production_path(card, dev, results))
    launches.update(il_path(card, dev, results))
    launches.update(bonded_path(card, dev, results))
    launches.update(unfused_path(card, dev, results))
    launches.update(fullmesh_path(card, dev, results))
    launches.update(gather_probe_path(card, dev, results))
    pallas = "lammps_user_conp2_tpu/ops/pallas/"
    replaces = {
        "pair_forces_conp": pallas + "pair_kernel.py:316",
        "b_realspace": pallas + "ele_rows_kernel.py:326",
        "block_pair_conp": pallas + "block_pair.py:158",
        "spread_mesh": pallas + "pppm_spread.py:125",
        "spread_tiles": pallas + "pppm_spread.py:170",
        "gather3": pallas + "pppm_gather.py:100",
        "conp_correction": pallas + "ele_rows_kernel.py:280",
        "shake_positions": pallas + "shake_kernel.py:163",
        "rattle_velocities": pallas + "shake_kernel.py:207",
        "window_gather": "tools/exp_vmem_gather.py:46"}
    csrc = "lammps_user_conp2_tpu_torch/csrc/"
    source = {
        "pair_forces_conp": csrc + "pair_kernel.cu",
        "b_realspace": csrc + "ele_rows_kernel.cu",
        "block_pair_conp": csrc + "block_pair.cu",
        "spread_mesh": csrc + "pppm_spread.cu",
        "spread_tiles": csrc + "pppm_spread.cu",
        "gather3": csrc + "pppm_gather.cu",
        "conp_correction": csrc + "ele_rows_kernel.cu",
        "shake_positions": csrc + "shake_kernel.cu",
        "rattle_velocities": csrc + "shake_kernel.cu",
        "window_gather": csrc + "vmem_gather.cu"}
    r100k = results["block_pair_conp_100k"]
    results["block_pair_conp"].update(
        ms_100k=r100k["ms"], host_ms_100k=r100k["host_ms"],
        device_ms_100k=r100k["device_ms"], bound_ms_100k=r100k["bound_ms"])
    # each kernel's device time per launch under graph replay, per cell
    # where the main path launches it (the graph phases' profiles)
    for name, (kid, counter) in KERNEL_IDS.items():
        per_cell = {}
        for g in GRAPHS:
            n = g["launches"].get(counter, 0)
            if n and kid in g["kernel_device_ms_per_step"]:
                per_cell[g["cell"]] = (g["kernel_device_ms_per_step"][kid]
                                       * GRAPH_PROFILE_STEPS / n)
        results[name]["device_ms_replay"] = per_cell
    # rule 2's order: launches per step x (device ms per launch - bound),
    # the bound at the cell's shapes where the kernels line has it
    gaps = []
    for name, (kid, counter) in KERNEL_IDS.items():
        r = results[name]
        for g in GRAPHS:
            if g["cell"] not in r["device_ms_replay"]:
                continue
            b = r.get({"il": "bound_ms_il", "unfused_il": "bound_ms_il",
                       "100k": "bound_ms_100k",
                       "full_mesh": "bound_ms_100k"}.get(g["cell"], ""),
                      r["bound_ms"])
            per_step = g["launches"][counter] / GRAPH_PROFILE_STEPS
            ms = r["device_ms_replay"][g["cell"]]
            gaps.append((per_step * (ms - b), kid, g["cell"], ms, b,
                         per_step))
    print("rule 2 order, launches/step x (device ms per launch under replay "
          "- bound ms): " + "; ".join(
              f"{kid} {cell} {gap:.4f} ({n:.0f} x ({ms:.4f} - {b:.6f}))"
              for gap, kid, cell, ms, b, n in sorted(gaps, reverse=True))
          + f"  [{card}]")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_r1",
            "host_ms", "device_ms", "ms_il", "device_ms_il", "bound_ms_il",
            "ms_100k", "host_ms_100k", "device_ms_100k", "bound_ms_100k",
            "device_ms_replay", "ms_1p2", "device_ms_1p2", "r_corr",
            "floor_ms", "kernels_per_call", "shapes")
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=results[name]["abs"],
                    max_rel_err=results[name]["rel"],
                    **{k: results[name][k] for k in keys
                       if k in results[name]})
               for name in replaces]
    summary = json.dumps({"graphs": GRAPHS})
    with open(os.path.join(OUT_DIR, "graph_phases.json"), "w") as fh:
        fh.write(summary + "\n")
    print(summary)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def production_path(card, dev, results):
    """Phases 6-9 on the 100k cell; fills ``results`` for K1, K2a and K3
    and returns their launch counts from the main-path run."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import pppm
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell

    # ---- phase 6: set-up
    system, md, cfg = large_cell()
    x_near = workloads.near_wall_positions(system)
    t0 = time.perf_counter()
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    grid = eng.pppm_grid
    geom = pppm._tile_geometry(grid, system.natoms)
    print(f"phase 6: {system.natoms} atoms, Ne={conp.ne}, "
          f"g_ewald={conp.ksp.g_ewald:.6f}, mesh {grid.shape}, {geom}, "
          f"K={eng.ncfg.k_max}, U={eng.ncfg.u_max}, block={eng.ncfg.block}, "
          f"mesh_persist={eng.mesh_persist}, {time.perf_counter() - t0:.2f} s")
    if not (eng.ncfg.block == 8 and eng.mesh_persist and geom.z_span):
        raise AssertionError("phase 6: not the block list on a persistent "
                             "z-span mesh")

    # ---- phase 7: K1, K2a, K3 against their plain versions
    rng = np.random.default_rng(1)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    bkw = dict(box=eng.ncfg.grid.box, periodic=eng.ncfg.grid.periodic,
               cutoff=md.cutoff, g_ewald=conp.ksp.g_ewald,
               qqr2e=system.units().qqr2e)
    for margin, tag in ((5.0, ""), (3.0, " at margin 3 A")):
        x = torch.as_tensor(workloads.near_wall_positions(system,
                                                          margin=margin),
                            dtype=torch.float32, device=dev)
        nbr, tasg = eng.derived_state(x)
        if bool(nbr.overflow) or bool(tasg.overflow):
            raise AssertionError("phase 7: list or tile capacity overflow")
        args = (x, q, eng.type_idx, nbr.bun, nbr.brows, eng.tables)
        for name, cf in (("block_pair", None), ("block_pair_conp", fuse)):
            kern = lambda: k1.block_pair(*args, conp_fuse=cf, **bkw)
            plain = lambda: k1.block_pair_plain(*args, conp_fuse=cf, **bkw)
            got = kern()
            torch.cuda.synchronize()
            rel, dabs = compare(name + tag, got, plain())
            same_bits(name + tag, got, kern())
            if cf is not None and margin == 3.0:
                ecorr = 0.5 * float(got[3])
                print(f"    block_pair_conp at margin 3 A: ecorr {ecorr:.4f}")
                if not abs(ecorr) > 1e-3:
                    raise AssertionError("phase 7: ecorr at margin 3 A is ~0")
            if not tag:
                # K1's kernels line is measured with exclusions on the
                # bonded block cell (phase 15); these are this cell's
                name = name + "_100k"
                results[name] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                     plain_ms=median_ms(plain, reps=5),
                                     host_ms=host_ms(kern),
                                     device_ms=device_ms(kern, K1_PARTS,
                                                         tag=name))
                seg, nseg = k1.block_segments(*nbr.bun.shape)
                print(f"    {name}: {nbr.bun.shape[0]} blocks x {nseg} "
                      f"union segments of {seg} chunks = "
                      f"{nbr.bun.shape[0] * nseg} warp items")
                nb = nbr.idx
                xj = x[nb.clamp(max=x.shape[0] - 1)]
                d = xj - x[:, None, :]
                for ax in range(3):
                    if system.periodic[ax]:
                        L = system.box[ax]
                        d[..., ax] -= L * torch.round(d[..., ax] / L)
                npairs = int((((d * d).sum(-1) < md.cutoff ** 2)
                              & (nb < x.shape[0])).sum())
                results[name].update(bound((args, cf), got,
                                           PAIR_FLOPS * npairs))
        if tag:
            break
        pk = k1.pack_rows(x, q, eng.type_idx, fuse[:2])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(
                pk, k1.pack_rows_plain(x, q, eng.type_idx, fuse[:2]))):
            raise AssertionError("phase 7: packed rows differ from plain")
        print("    block_pair packed rows equal their plain version")
        q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
        slots = pppm.refresh_tile_slots(grid, tasg, x, q_elyte)
        cfd = pppm._coeffs(grid, torch.float32, dev)
        kern = lambda: k2.spread_mesh(slots.rows, cfd, geom)
        plain = lambda: k2.spread_mesh_plain(slots.rows, cfd, geom)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare("spread_mesh", (got,), (plain(),))
        same_bits("spread_mesh", (got,), (kern(),))
        bins = k2.spread_bins_plain(slots.rows, geom)
        kept = [sum(len(p[1]) for p in b) for b in bins]
        kcap = build.load_library().conp2_spread_mesh_pass_cap(
            geom.tlx, geom.tly, geom.tlz + 2 * (geom.hw + geom.dm))
        if kcap != k2.spread_pass_cap(geom):
            raise AssertionError("phase 7: spread_pass_cap differs from the "
                                 "kernel's")
        print(f"    spread_mesh: kept atoms per tile max {max(kept)}, mean "
              f"{np.mean(kept):.1f}, {sum(k == 0 for k in kept)} of "
              f"{len(kept)} tiles keep none; {kcap} per pass, "
              f"{max(len(b) for b in bins)} passes at most")
        results["spread_mesh"] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                      plain_ms=median_ms(plain, reps=5),
                                      host_ms=host_ms(kern),
                                      device_ms=device_ms(kern, K2A_PARTS))
        # K2a reads every slot's charge and the other rows of the charged
        # slots before each tile's count only
        charged = slots.rows[:, 6] != 0
        staged = slots.rows[:, :6].transpose(1, 2)[charged]      # (n, 6)
        results["spread_mesh"].update(bound(
            (slots.rows[:, 6], staged, cfd), got,
            SPREAD_FLOPS * staged.shape[0]))
        rhok = pppm._spread_rhok_tiled(grid, x, q_elyte, slots)
        _, uz = pppm.pppm_energy_u_zbin(grid, rhok, system.natoms)
        up = pppm._wrap_pad_xy(uz, geom.hw + geom.dm).contiguous()
        kern = lambda: k3.gather3(up, slots.rows, cfd, geom)
        plain = lambda: k3.gather3_plain(up, slots.rows, cfd, geom)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare("gather3", (got,), (plain(),))
        results["gather3"] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                  plain_ms=median_ms(plain, reps=5))
        results["gather3"].update(bound(
            (up, slots.rows, cfd), got, GATHER_FLOPS * system.natoms))
    report("phase 7", results, ("block_pair_100k", "block_pair_conp_100k",
                                "spread_mesh", "gather3"), card)

    # ---- phase 8: the main path on the card
    counters = {"block_pair_100k": k1.launches, "spread_mesh": k2.launches,
                "gather3": k3.launches}
    r0 = eng.rebuilds
    _, _, _, launches = main_run("phase 8", eng, dict(x0=x_near), 10, 100,
                                 counters, conp.ne, card)
    rebuilds = eng.rebuilds - r0
    print(f"phase 8: {rebuilds} list rebuilds in 110 steps")
    if rebuilds < 1:
        raise AssertionError("phase 8: no list rebuild")
    graph_phase("phase 8b", "100k", eng, dict(x0=x_near), card)

    # ---- phase 9: card (float32) against CPU (float64, plain path)
    card_vs_cpu("phase 9", eng, system, md, cfg, 2, x0=x_near)
    return {k: launches[k] for k in ("spread_mesh", "gather3")}


def il_path(card, dev, results):
    """Phases 10-13 on the 3,776-atom ionic-liquid cell; fills ``results``
    for K7 and K8 and returns their launch counts from the main-path run
    (where K4 and K5 must launch every step too)."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.models.shake import (build_constraints,
                                                          constraint_residuals)
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm

    # ---- phase 10: set-up
    t0 = time.perf_counter()
    path = workloads.write_il_data(os.path.join(OUT_DIR, "il_3776.data"))
    t_write = time.perf_counter() - t0
    system, md, cfg = workloads.il_onelayer(0, data_path=path)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    cons = eng.cons
    m, kk = cons.atoms.shape
    cc = cons.ci.shape[1]
    print(f"phase 10: {system.natoms} atoms, Ne={conp.ne}, M={m}, K={kk}, "
          f"C={cc}, g_ewald={conp.ksp.g_ewald:.6f}, K-vectors="
          f"{conp.ksp.kcount}, nxy={conp.fksp.nxy}, box {system.box}, data "
          f"file {t_write:.2f} s, set-up {time.perf_counter() - t0:.2f} s")
    if not (eng.ncfg is None and eng.pppm_grid is None and cons is not None
            and cons.atoms.device.type == dev.type):
        raise AssertionError("phase 10: not the mid-size path with SHAKE "
                             "tables on the card")

    # ---- phase 11: K7 and K8 against their plain versions
    rng = np.random.default_rng(11)
    x_old = np.array(system.x0)
    cats = np.flatnonzero(system.groups["bmi"]).reshape(-1, 3)
    dx = x_old[cats[:, 2], 0] - x_old[cats[:, 0], 0]
    dx -= system.box[0] * np.round(dx / system.box[0])
    cat = cats[np.argmax(np.abs(dx))]       # the cation most along x
    x_old[cat, 0] = (x_old[cat, 0] - x_old[cat[1], 0] + 0.2) % system.box[0]
    v_np = system.v0 + rng.normal(0.0, 0.005, x_old.shape)
    v_np[system.ele_mask] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xo, xn = t(x_old), t(x_old + md.dt * v_np)
    v = t(v_np + rng.normal(0.0, 0.005, x_old.shape))
    kw = dict(box=system.box, periodic=system.periodic)
    kern = lambda: k78.shake_positions(cons, xn, xo, md.dt, **kw)
    plain = lambda: k78.shake_positions_plain(cons, xn, xo, md.dt, **kw)
    x, dv = kern()
    torch.cuda.synchronize()
    px, pdv = plain()
    rel, dabs = compare("shake_positions x", (x,), (px,), SHAKE_TOL)
    dv_err = float((dv - pdv).abs().max())
    dv_rel = dv_err / float(pdv.abs().max())
    if not (torch.equal(x, px) and torch.equal(dv, pdv)):
        raise AssertionError("phase 11: K7 differs from its plain version "
                             f"(x {dabs:.3e}, dv {dv_err:.3e})")
    same_bits("shake_positions", (x, dv), kern())
    cons64 = build_constraints(system, md.shake, dtype=torch.float64,
                               device=dev)
    _, dv64 = k78.shake_positions_plain(cons64, xn.double(), xo.double(),
                                        md.dt, **kw)
    gap = float((pdv.double() - dv64).abs().max()) / float(dv64.abs().max())
    print(f"    shake_positions dv: max abs err {dv_err:.3e}, rel "
          f"{dv_rel:.3e}; the plain version's own f32-vs-f64 gap {gap:.3e}")
    if not dv_rel <= max(SHAKE_TOL, gap):
        raise AssertionError(f"phase 11: dv rel err {dv_rel:.3e}")
    res_k = constraint_residuals(cons, x, **kw)
    res_p = constraint_residuals(cons, px, **kw)
    print(f"    residual per slot after K7 {['%.3e' % r for r in res_k]}, "
          f"after the plain version {['%.3e' % r for r in res_p]}")
    if not max(res_k) <= max(res_p) + 1e-6:
        raise AssertionError("phase 11: K7 leaves a larger residual")
    work = m * k78.ITERS * cc
    # what the function needs: x_new whole, the clustered rows of x_old,
    # the cluster tables (not this design's records or free-row table)
    rows = cons.atoms[cons.amask].long()
    tables = (cons.atoms, cons.ci, cons.cj, cons.invm, cons.cmask)
    results["shake_positions"] = dict(
        rel=max(rel, dv_rel), abs=max(dabs, dv_err), ms=median_ms(kern),
        plain_ms=median_ms(plain, reps=5),
        device_ms=device_ms(kern, K7_PARTS, tag="shake_positions"),
        kernels_per_call=kernels_per_call("shake_positions", kern))
    results["shake_positions"].update(bound(
        (xn, xo[rows], tables, cons.dist2), (x, dv),
        SHAKE_SLOT_FLOPS * work))
    kern = lambda: k78.rattle_velocities(cons, x, v, **kw)
    plain = lambda: k78.rattle_velocities_plain(cons, x, v, **kw)
    got = kern()
    torch.cuda.synchronize()
    pv = plain()
    rel, dabs = compare("rattle_velocities v", (got,), (pv,), SHAKE_TOL)
    if not torch.equal(got, pv):
        raise AssertionError("phase 11: K8 differs from its plain version "
                             f"({dabs:.3e})")
    same_bits("rattle_velocities", (got,), (kern(),))
    results["rattle_velocities"] = dict(
        rel=rel, abs=dabs, ms=median_ms(kern),
        plain_ms=median_ms(plain, reps=5),
        device_ms=device_ms(kern, K8_PARTS, tag="rattle_velocities"),
        kernels_per_call=kernels_per_call("rattle_velocities", kern))
    results["rattle_velocities"].update(bound(
        (v, x[rows], tables), got, RATTLE_SLOT_FLOPS * work))
    for name, ms in chain_floor(cons, xn, xo, v, md.dt, kw).items():
        results[name]["floor_ms"] = ms
        r = results[name]
        print(f"phase 11: {name:20s} device {r['device_ms']:.4f} ms per "
              f"call in {r['kernels_per_call']} CUDA kernel; chain floor "
              f"(m = 1, 100 launches replayed in a graph) {ms:.4f} ms per "
              f"launch; roofline bound {r['bound_ms']:.6f} ms  [{card}]")
    print("phase 11: " + K78_PHASE_SPLIT)
    # K4 (exclusions applied per pair) and K5 at this cell's shapes
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = t(q_np)
    x0 = t(system.x0)
    pkw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    zsort = z_perm(x0, system.box, system.periodic)
    pairs = k4_pairs("phase 11", k4, x0, zsort, system, md.cutoff, card,
                     m=eng.excl_idx.shape[1])
    kern = lambda: k4.pair_forces(x0, q, eng.type_idx, eng.tables,
                                  eng.exclusions, zsort=zsort,
                                  conp_fuse=fuse, **pkw)
    got = kern()
    torch.cuda.synchronize()
    compare("pair_forces_conp with exclusions", got, k4.pair_forces_plain(
        x0, q, eng.type_idx, eng.tables, eng.exclusions, conp_fuse=fuse,
        **pkw))
    same_bits("pair_forces_conp with exclusions", got, kern())
    il = {"pair_forces_conp": dict(
        ms=median_ms(kern), device_ms=device_ms(
            kern, K4_PARTS, tag="pair_forces_conp at the il cell"), **bound(
        (x0, q, eng.type_idx, eng.tables, eng.exclusions, zsort, fuse), got,
        PAIR_FLOPS * pairs))}
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    bargs = (x0, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
             conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    kern = lambda: k5.b_realspace(*bargs, zsort=zsort, **bkw)
    got = kern()
    torch.cuda.synchronize()
    compare("b_realspace", (got,), (k5.b_realspace_plain(*bargs, **bkw),))
    same_bits("b_realspace", (got,), (kern(),))
    il["b_realspace"] = dict(ms=median_ms(kern),
                             device_ms=device_ms(kern, K5_PARTS), **bound(
        (bargs, zsort), got, B_ROW_FLOPS * pairs_within(
            x0[:conp.ne], x0[conp.ne:], system.box, system.periodic,
            conp.cut_coulsq)))
    for name, r in il.items():
        results[name].update(ms_il=r["ms"], device_ms_il=r["device_ms"],
                             bound_ms_il=r["bound_ms"])
        print(f"phase 11: {name:20s} at the il cell {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})  [{card}]")
    report("phase 11", results, ("shake_positions", "rattle_velocities"),
           card, SHAKE_TOL)

    # ---- phase 12: the main path on the card
    counters = {"pair_forces_conp": k4.launches, "b_realspace": k5.launches,
                "shake_positions": k78.shake_launches,
                "rattle_velocities": k78.rattle_launches}
    st, _, _, launches = main_run("phase 12", eng, {}, 11, 100, counters,
                                  conp.ne, card)
    graph_phase("phase 12b", "il", eng, {}, card)
    res = constraint_residuals(cons, st.x, **kw)
    print(f"phase 12: constraint residual per slot (bond 1, bond 2, 1-3) "
          f"{['%.3e' % r for r in res]}")
    if not (res[-1] <= md.shake.tol and max(res) <= 2.0 * IL_F64_BONDS):
        raise AssertionError("phase 12: constraints outside their bounds "
                             f"(1-3 <= {md.shake.tol}, bonds <= "
                             f"{2.0 * IL_F64_BONDS:.3e})")

    # ---- phase 13: card (float32) against CPU (float64, plain path)
    t0 = time.perf_counter()
    conp64 = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                        device="cpu")
    eng64 = build_engine(system, md, conp64, dtype=torch.float64,
                         device="cpu")
    s32 = eng.init_state()
    s64 = eng64.init_state()
    for i in range(11):
        s32 = eng.step(s32)
        s64 = eng64.step(s64)
        if i < 3:
            agree(f"phase 13: step {i + 1}", s32, s64, conp.ne)
    r32 = constraint_residuals(cons, s32.x, **kw)
    r64 = constraint_residuals(eng64.cons, s64.x, **kw)
    dx = float((s32.x.double().cpu() - s64.x).abs().max())
    print(f"phase 13: after 11 steps max|dx| {dx:.3e} A, residual per slot "
          f"card {['%.3e' % r for r in r32]}, CPU float64 "
          f"{['%.3e' % r for r in r64]}")
    if not all(a <= 2.0 * b + 1e-5 for a, b in zip(r32, r64)):
        raise AssertionError("phase 13: the card's residual is larger")
    print(f"phase 13: 11 steps matched the float64 CPU run "
          f"({time.perf_counter() - t0:.1f} s)")
    return {k: launches[k] for k in ("shake_positions", "rattle_velocities")}


def kernels_per_call(name, fn, reps=1) -> int:
    """CUDA kernels per call in a torch.profiler trace of ``reps`` calls;
    raises unless there is exactly one per call.  A trace with no kernel
    records (the profiler can lose them) is taken again, up to five
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if names:
            break
    print(f"    {name}: {len(names)} CUDA kernel(s) in {reps} call(s): "
          + ", ".join(sorted({n[:60] for n in names})))
    if len(names) != reps:
        raise AssertionError(f"{name}: {len(names)} kernels in {reps} "
                             "calls")
    return len(names) // reps


def one_cluster(cons, *arrays):
    """The first cluster alone: its table over its own rows (no free rows)
    and those rows of each array."""
    from lammps_user_conp2_tpu_torch.models.shake import ShakeConstraints
    valid = cons.amask[0].cpu().numpy()
    rows = cons.atoms[0].long()[cons.amask[0]]
    local = np.where(valid, np.cumsum(valid) - 1, 0)[None]
    one = ShakeConstraints(
        local, valid[None], cons.ci[:1].cpu().numpy(),
        cons.cj[:1].cpu().numpy(), cons.dist2[:1].double().cpu().numpy(),
        cons.cmask[:1].cpu().numpy(), cons.invm[:1].double().cpu().numpy(),
        np.zeros((0, 2), np.int64), natoms=int(valid.sum()),
        dtype=cons.invm.dtype, device=cons.invm.device)
    if one.free_rows.numel():
        raise AssertionError("one_cluster: free rows left")
    return (one,) + tuple(a[rows].contiguous() for a in arrays)


def chain_floor(cons, xn, xo, v, dt, kw) -> dict:
    """K7's and K8's device ms per launch on the first cluster alone (m = 1,
    its own rows, no free rows): 100 launches captured in one CUDA graph,
    replayed, the median launch of the profiled replay (the profiler may
    drop some of a replay's kernel records: at least half must come back).
    Below a launch the roofline bound says nothing; this floor is the
    chain's own."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    one, xn1, xo1, v1 = one_cluster(cons, xn, xo, v)
    out = {}
    for name, fn in (
            ("shake_positions",
             lambda: k78.shake_positions(one, xn1, xo1, dt, **kw)),
            ("rattle_velocities",
             lambda: k78.rattle_velocities(one, xn1, v1, **kw))):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(100):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        ts = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA"]
        if not 50 <= len(ts) <= 100:
            raise AssertionError(f"{name}: {len(ts)} kernel records of a "
                                 "graph of 100 launches")
        out[name] = float(np.median(ts)) / 1e3
    return out


def main_run(tag, eng, st, warm, timed, counters, ne, card, never=()):
    """``warm`` then ``timed`` steps of ``eng.run`` from ``eng.init_state(
    **st)``, with the launch counters set to 0 just before: each kernel in
    ``counters`` must have launched every step (>= 111 times: 111 steps, or
    110 and the one in init_state), each named in ``never`` not at all;
    finite energy, neutral electrodes.  Returns (state, thermo, ms/step,
    launches of the first kind)."""
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    st = eng.init_state(**st)
    st, _ = eng.run(st, warm, thermo_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, th = eng.run(st, timed, thermo_every=20)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / timed * 1e3
    launches = {name: c.count for name, c in counters.items()}
    print(f"{tag}: launches in {warm + timed} steps {launches}")
    for name, cnt in launches.items():
        if (cnt != 0) if name in never else (cnt < 111):
            raise AssertionError(f"{tag}: {name} launched {cnt} times")
    for name in never:
        launches.pop(name)
    if not math.isfinite(float(st.energy)):
        raise AssertionError(f"{tag}: energy is not finite")
    qsum = float(st.q[:ne].double().sum())
    if not abs(qsum) <= 1e-4:
        raise AssertionError(f"{tag}: electrode charge sum {qsum:.3e}")
    print(f"{tag}: T={float(th['temp'][-1]):.2f} K, pe={float(st.energy):.6g}, "
          f"qleft={float(th['qleft'][-1]):.6g}, sum q_ele={qsum:.3e}")
    print(f"{tag}: {ms_step:.4f} ms/step ({1e3 / ms_step:.2f} steps/s), "
          f"{eng.system.natoms} atoms, float32  [{card}]")
    return st, th, ms_step, launches


# graphed-vs-eager pairs per cell and the steps of each run: each run
# starts from the same state
GRAPH_PAIRS = 5
GRAPH_STEPS = 100
GRAPH_PROFILE_STEPS = GRAPH_STEPS
GRAPHS = []


def _state_diff(a, b):
    """(bit-identical, max|dx|, max|dv|, max|dq|, |dpe|) of two states."""
    d = [float((u.double() - w.double()).abs().max()) for u, w in
         ((a.x, b.x), (a.v, b.v), (a.q, b.q), (a.energy, b.energy))]
    same = all(torch.equal(u, w) for u, w in ((a.x, b.x), (a.v, b.v),
                                              (a.q, b.q),
                                              (a.energy, b.energy)))
    return (same, *d)


def graph_phase(tag, cell, eng, st_kw, card):
    """The step replayed as CUDA graphs (``Engine.run``) against the eager
    step (``Engine.step`` in a loop), from the same state, GRAPH_STEPS
    steps per run: GRAPH_PAIRS alternating (eager, graphed) pairs on the
    host clock; eager vs eager, graphed vs eager and graphed vs graphed on
    x, v, q and pe, all bit for bit; the host syncs of a graphed run
    (torch.cuda.set_sync_debug_mode: none per step on the dense paths, one
    on the list paths); a torch.profiler window of the same replayed steps
    (the same list rebuilds): the device-busy share of the graphed step and
    each hand kernel's device time per launch.  Appends the cell's record to
    GRAPHS."""
    import warnings
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.step_breakdown import (device_busy,
                                                            kernel_of)
    from torch.profiler import ProfilerActivity, profile

    st0 = eng.init_state(**st_kw)
    eng.run(st0, 2, thermo_every=0)              # captured (or reused)
    torch.cuda.synchronize()
    eager_ms, graph_ms, eager_out, graph_out = [], [], [], []
    for _ in range(GRAPH_PAIRS):
        t0 = time.perf_counter()
        st = st0
        for _ in range(GRAPH_STEPS):
            st = eng.step(st)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) / GRAPH_STEPS * 1e3)
        eager_out.append(st)
        t0 = time.perf_counter()
        st, _ = eng.run(st0, GRAPH_STEPS, thermo_every=0)
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) / GRAPH_STEPS * 1e3)
        graph_out.append(st)
    # every pair of runs: eager-eager, graphed-eager, graphed-graphed
    ee = [_state_diff(eager_out[i], eager_out[j])
          for i in range(GRAPH_PAIRS) for j in range(i + 1, GRAPH_PAIRS)]
    ge = [_state_diff(g, e) for g in graph_out for e in eager_out]
    gg = [_state_diff(graph_out[i], graph_out[j])
          for i in range(GRAPH_PAIRS) for j in range(i + 1, GRAPH_PAIRS)]
    stats = {}
    for label, ds in (("eager_vs_eager", ee), ("graphed_vs_eager", ge),
                      ("graphed_vs_graphed", gg)):
        stats[label] = dict(
            bit_identical=all(d[0] for d in ds),
            max=[max(d[k] for d in ds) for k in range(1, 5)],
            median=[float(np.median([d[k] for d in ds])) for k in
                    range(1, 5)])
        st_ = stats[label]
        print(f"{tag}: {cell}, {GRAPH_STEPS} steps from one state, "
              f"{label} ({len(ds)} pairs): bit-identical "
              f"{st_['bit_identical']}; max / median |dx| "
              f"{st_['max'][0]:.3e} / {st_['median'][0]:.3e}, |dv| "
              f"{st_['max'][1]:.3e} / {st_['median'][1]:.3e}, |dq| "
              f"{st_['max'][2]:.3e} / {st_['median'][2]:.3e}, |dpe| "
              f"{st_['max'][3]:.3e} / {st_['median'][3]:.3e}")
    for label, st_ in stats.items():
        if not st_["bit_identical"]:
            raise AssertionError(f"{tag}: {cell}, {label} differ: the step "
                                 "is not bit-reproducible")
    # the thermo rows of a graphed run: its last pe is the eager state's
    st_th, th = eng.run(st0, GRAPH_STEPS, thermo_every=GRAPH_STEPS // 10)
    torch.cuda.synchronize()
    if not (_state_diff(st_th, eager_out[0])[0]
            and float(th["pe"][-1]) == float(eager_out[0].energy)):
        raise AssertionError(f"{tag}: {cell}, the graphed run with thermo "
                             "rows differs from the eager run")
    print(f"{tag}: {cell}, a graphed run with {len(th['pe'])} thermo rows: "
          "state and last pe bit-identical to the eager run's")
    print(f"{tag}: ms/step eager / graphed pairs " + ", ".join(
        f"{e:.4f} / {g:.4f}" for e, g in zip(eager_ms, graph_ms))
        + f"  [{card}]")
    # host syncs of one graphed run
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(st0, GRAPH_STEPS, thermo_every=0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if "called a synchronizing" in str(w.message):
            loc = f"{os.path.basename(w.filename)}:{w.lineno}"
            where[loc] = where.get(loc, 0) + 1
    syncs = sum(where.values())
    listed = eng.ncfg is not None
    print(f"{tag}: {syncs} host syncs in a graphed run of {GRAPH_STEPS} "
          f"steps ({'one per step allowed' if listed else 'none per step'},"
          f" plus the end-of-run check): {where}")
    if syncs > (GRAPH_STEPS if listed else 0) + 2:
        raise AssertionError(f"{tag}: {syncs} host syncs in the graphed run")
    if listed and syncs < GRAPH_STEPS:
        raise AssertionError(f"{tag}: the sync count missed the flag reads")
    # the profiled window, the timed runs' trajectory: busy share and
    # device time per launch
    before = {c.name: c.count for c in build.COUNTERS}
    r0 = eng.rebuilds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(st0, GRAPH_PROFILE_STEPS, thermo_every=0)
        torch.cuda.synchronize()
    rebuilds = eng.rebuilds - r0
    launched = {c.name: c.count - before[c.name] for c in build.COUNTERS
                if c.count != before[c.name]}
    busy, by_name = device_busy(prof, GRAPH_PROFILE_STEPS)
    with open(os.path.join(OUT_DIR, f"graph_profile_{cell}.txt"), "w") as fh:
        fh.write(card + "\n")
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    per_kernel = {}
    for name, (ms, cnt) in by_name.items():
        key = kernel_of(name)
        if key is not None:
            ms0, c0 = per_kernel.get(key, (0.0, 0.0))
            per_kernel[key] = (ms0 + ms, c0 + cnt)
    nk = sum(c for _, c in by_name.values())
    g_med = float(np.median(graph_ms))
    share = busy / g_med
    print(f"{tag}: graphed step {g_med:.4f} ms (median), device busy "
          f"{busy:.4f} ms/step (union of kernel intervals over "
          f"{GRAPH_PROFILE_STEPS} replayed steps, {rebuilds} list "
          f"rebuilds), busy share {share:.3f}, "
          f"{nk:.0f} device kernels per step; eager step "
          f"{float(np.median(eager_ms)):.4f} ms  [{card}]")
    for key, (ms, cnt) in sorted(per_kernel.items()):
        print(f"    {key}: device {ms:.4f} ms/step in {cnt:.1f} CUDA kernels "
              f"per step under replay")
    GRAPHS.append(dict(
        cell=cell, natoms=eng.system.natoms, eager_ms=eager_ms,
        graph_ms=graph_ms, busy_ms=busy, busy_share=share,
        kernels_per_step=nk, host_syncs=syncs, rebuilds_profiled=rebuilds,
        diffs=stats,
        launches=launched, kernel_device_ms_per_step={
            k: v[0] for k, v in per_kernel.items()}))
    return per_kernel, launched


def card_vs_cpu(tag, eng, system, md, cfg, nsteps, x0=None):
    """``nsteps`` steps on the card (float32) against the CPU (float64)
    from the same positions, each held to phase 5's bounds."""
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    t0 = time.perf_counter()
    conp64 = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                        device="cpu")
    eng64 = build_engine(system, md, conp64, dtype=torch.float64,
                         device="cpu")
    s32 = eng.init_state(x0=x0)
    s64 = eng64.init_state(x0=x0)
    agree(f"{tag}: step 0", s32, s64, conp64.ne)
    for i in range(nsteps):
        s32 = eng.step(s32)
        s64 = eng64.step(s64)
        agree(f"{tag}: step {i + 1}", s32, s64, conp64.ne)
    print(f"{tag}: {nsteps} steps matched the float64 CPU run "
          f"({time.perf_counter() - t0:.1f} s)")


def report(tag, results, names, card, tol=KERNEL_TOL):
    """One line per kernel: error against its plain version, both times and
    the bound, beside the card's name and power limit."""
    for name in names:
        r = results[name]
        extra = "".join(f", {k} {r[k]:.4f} ms" for k in ("host_ms",
                                                          "device_ms")
                        if k in r)
        print(f"{tag}: {name:20s} rel err {r['rel']:.3e} (tol {tol}), kernel "
              f"{r['ms']:.4f} ms{extra}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})  [{card}]")


def bonded_path(card, dev, results):
    """Phases 14-17 on the 8,772-atom bonded block cell; fills ``results``
    for K1 (with exclusions) and returns its launch count from the main
    path, where K7 and K8 must launch every step too."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78

    # ---- phase 14: set-up
    t0 = time.perf_counter()
    path = workloads.write_il_data(os.path.join(OUT_DIR, "il_8772.data"),
                                   n_pairs=1329, sheets=1, nx=27, ny=16)
    system, md, cfg = workloads.il_onelayer(0, data_path=path)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    ncfg = eng.ncfg
    print(f"phase 14: {system.natoms} atoms, Ne={conp.ne}, box {system.box}, "
          f"g_ewald={conp.ksp.g_ewald:.6f}, K-vectors={conp.ksp.kcount}, "
          f"nxy={conp.fksp.nxy}, K={ncfg.k_max}, U={ncfg.u_max}, "
          f"exclusions {tuple(eng.excl_idx.shape)}, "
          f"{time.perf_counter() - t0:.2f} s")
    if not (ncfg.block == 8 and eng.exclusions is not None
            and eng.cons is not None):
        raise AssertionError("phase 14: not the block list with exclusions "
                             "and SHAKE")

    # ---- phase 15: K1 with exclusions against its plain version
    rng = np.random.default_rng(14)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    x = torch.as_tensor(system.x0, dtype=torch.float32, device=dev)
    nbr, _ = eng.derived_state(x)
    if bool(nbr.overflow):
        raise AssertionError("phase 15: list capacity overflow")
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    bkw = dict(box=ncfg.grid.box, periodic=ncfg.grid.periodic,
               cutoff=md.cutoff, g_ewald=conp.ksp.g_ewald,
               qqr2e=system.units().qqr2e, exclusions=eng.exclusions)
    args = (x, q, eng.type_idx, nbr.bun, nbr.brows, eng.tables)
    for name, cf in (("block_pair", None), ("block_pair_conp", fuse)):
        kern = lambda: k1.block_pair(*args, conp_fuse=cf, **bkw)
        plain = lambda: k1.block_pair_plain(*args, conp_fuse=cf, **bkw)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare(name + " with exclusions", got, plain())
        same_bits(name + " with exclusions", got, kern())
        results[name] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                             plain_ms=median_ms(plain, reps=5),
                             host_ms=host_ms(kern),
                             device_ms=device_ms(kern, K1_PARTS, tag=name))
        nb = nbr.idx
        d = x[nb.clamp(max=x.shape[0] - 1)] - x[:, None, :]
        for ax in range(3):
            if system.periodic[ax]:
                L = system.box[ax]
                d[..., ax] -= L * torch.round(d[..., ax] / L)
        npairs = int((((d * d).sum(-1) < md.cutoff ** 2)
                      & (nb < x.shape[0])).sum())
        results[name].update(bound((args, cf, eng.exclusions), got,
                                   PAIR_FLOPS * npairs))
    seg, nseg = k1.block_segments(*nbr.bun.shape)
    print(f"phase 15: {nbr.bun.shape[0]} blocks x {nseg} union segments of "
          f"{seg} chunks = {nbr.bun.shape[0] * nseg} warp items")
    report("phase 15", results, ("block_pair", "block_pair_conp"), card)

    # ---- phase 16: the main path
    counters = {"block_pair_conp": k1.launches,
                "shake_positions": k78.shake_launches,
                "rattle_velocities": k78.rattle_launches}
    _, _, _, launches = main_run("phase 16", eng, {}, 11, 100, counters,
                                 conp.ne, card)
    graph_phase("phase 16b", "bonded", eng, {}, card)

    # ---- phase 17: card (float32) against CPU (float64)
    card_vs_cpu("phase 17", eng, system, md, cfg, 3)
    return {"block_pair_conp": launches["block_pair_conp"]}


def unfused_path(card, dev, results):
    """Phases 18-20 on the 3,776-atom ionic-liquid cell with
    use_pallas_pair=False; fills ``results`` for K6 and returns its launch
    count (K5, K7 and K8 launch every step too, K4 never)."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models import md as md_mod
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm

    # ---- phase 18: set-up and K6 against its plain version
    t0 = time.perf_counter()
    path = workloads.write_il_data(os.path.join(OUT_DIR, "il_3776.data"))
    system, md, cfg = workloads.il_onelayer(0, data_path=path)
    md = dataclasses.replace(md, use_pallas_pair=False)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"phase 18: {system.natoms} atoms, Ne={conp.ne}, use_pallas_pair="
          f"{md.use_pallas_pair}, {time.perf_counter() - t0:.2f} s")
    if eng.ncfg is not None:
        raise AssertionError("phase 18: not the dense path")
    rng = np.random.default_rng(18)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              qqr2e=system.units().qqr2e)
    ele = system.ele_mask
    z = np.asarray(system.x0)[:, 2]
    zl = z[ele & (z < 0.5 * system.box[2])].max()
    zr = z[ele & (z > 0.5 * system.box[2])].min()
    x_close = np.array(system.x0)
    zi = z[~ele]
    x_close[~ele, 2] = (zl + 1.0 + (zi - zi.min()) / (zi.max() - zi.min())
                        * (zr - zl - 2.0))
    # at x0 the ions sit >= 4 A from the inner sheets, beyond the clamped
    # Gaussian (eta r < 5.8, r < 2.93 A): every term is 0 there.  The
    # kernel's line is measured 1 A off the sheets (every ion's z mapped
    # between the inner sheets' 1 A planes), and again with the anions
    # nearest each wall moved 1.2 A off it (``near_sheet_positions``).
    # K6 searches the correction's range r_corr; its plain version the
    # full cutoff.
    x_1p2 = workloads.near_sheet_positions(system, gap=1.2)
    print(f"    conp_correction: r_corr {eng.r_corr:.6f} A of the "
          f"{md.cutoff} A cutoff")
    for tag, xx in (("at x0", system.x0), ("1 A off the sheets", x_close),
                    ("1.2 A off the sheets", x_1p2)):
        x = torch.as_tensor(xx, dtype=torch.float32, device=dev)
        zsort = z_perm(x, system.box, system.periodic)
        args = (x, q, eng.type_idx, conp.ele_idx_t, eng.ele_flag,
                eng.elyte_flag, eng.eta_tab, eng.fo_tab)
        kern = lambda: k56.conp_correction(*args, zsort=zsort,
                                           r_corr=eng.r_corr,
                                           gtab=eng.corr_gtab, **kw)
        plain = lambda: k56.conp_correction_plain(*args, **kw)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare("conp_correction " + tag, got, plain())
        same_bits("conp_correction " + tag, got, kern())
        print(f"    conp_correction {tag}: ecorr {float(got[1]):.4f}")
        if tag == "at x0":
            orders = k56.corr_orders(*zsort, eng.elyte_flag, eng.ele_flag)
            ref = k56.corr_orders(zsort[0].cpu(), zsort[1].cpu(),
                                  eng.elyte_flag.cpu(), eng.ele_flag.cpu())
            if not all(torch.equal(a.cpu().long(), b.long()) and
                       torch.equal(c.cpu(), d) for (a, c), (b, d) in
                       zip(orders, ref)):
                raise AssertionError("phase 18: K6's z orders differ from "
                                     "their plain version")
            print("    conp_correction: its electrolyte and electrode z "
                  "orders equal their plain version")
            continue
        if not abs(float(got[1])) > 1e-3:
            raise AssertionError(f"phase 18: ecorr {tag} is ~0")
        r = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                 plain_ms=median_ms(plain, reps=5),
                 device_ms=device_ms(kern, K6_PARTS, tag="conp_correction "
                                     + tag), r_corr=eng.r_corr)
        # the function needs the pairs within r_corr: beyond it every term
        # is exactly 0
        r.update(bound((args, zsort), got, CORR_PAIR_FLOPS * pairs_within(
            x[:conp.ne], x[conp.ne:], system.box, system.periodic,
            eng.r_corr ** 2)))
        if tag.startswith("1 A"):
            results["conp_correction"] = r
        else:
            results["conp_correction"].update(
                ms_1p2=r["ms"], device_ms_1p2=r["device_ms"],
                rel=max(rel, results["conp_correction"]["rel"]),
                abs=max(dabs, results["conp_correction"]["abs"]))
    report("phase 18", results, ("conp_correction",), card)

    # ---- phase 19: the main path
    counters = {"pair_forces": k4.launches, "b_realspace": k56.launches,
                "conp_correction": k56.corr_launches,
                "shake_positions": k78.shake_launches,
                "rattle_velocities": k78.rattle_launches}
    _, _, _, launches = main_run("phase 19", eng, {}, 11, 100, counters,
                                 conp.ne, card, never=("pair_forces",))
    graph_phase("phase 19b", "unfused_il", eng, {}, card)

    # ---- phase 20: card (float32) against CPU (float64), from anions 2 A
    # off the inner sheets: the engine's own K6 call sees nonzero terms
    # there (at x0 every term is 0), with the solver's z order and flags
    seen = {torch.float32: [], torch.float64: []}
    real = md_mod.conp_correction

    def spy(xx, *a, **k):
        out = real(xx, *a, **k)
        seen[xx.dtype].append(float(out[1]))
        return out

    md_mod.conp_correction = spy
    try:
        card_vs_cpu("phase 20", eng, system, md, cfg, 3,
                    x0=workloads.near_sheet_positions(system, gap=2.0))
    finally:
        md_mod.conp_correction = real
    e32, e64 = seen[torch.float32], seen[torch.float64]
    print(f"phase 20: engine ecorr per step, card {['%.4e' % e for e in e32]}"
          f", CPU float64 {['%.4e' % e for e in e64]}")
    if not (len(e32) == len(e64) == 4 and abs(e64[0]) > 0.0
            and abs(e32[0] - e64[0]) <= 1e-3 * abs(e64[0])):
        raise AssertionError("phase 20: the engine's correction energy at "
                             "step 0 is 0 or off the CPU's by more than 1e-3")
    return {"conp_correction": launches["conp_correction"]}


def fullmesh_path(card, dev, results):
    """Phases 21-23 on the 101,504-atom cell with mobile electrodes; fills
    ``results`` for K2b and returns its launch count (K1, K2a and K3 launch
    every step too)."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import pppm
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle

    # ---- phase 21: set-up and K2b against its plain version
    t0 = time.perf_counter()
    system, md, cfg = workloads.synthetic(98304, 40, lz=240.0, lxy=120.0)
    md = dataclasses.replace(md, kspace_style=KSpaceStyle.PPPM)
    cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM,
                              mobile_electrodes=True)
    x_near = workloads.near_wall_positions(system)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    grid = eng.pppm_grid
    ne = conp.ne
    geom = pppm._tile_geometry(grid, ne)
    work = ne * (grid.nx * grid.ny + grid.nz)
    print(f"phase 21: {system.natoms} atoms, Ne={ne}, mesh {grid.shape}, "
          f"Ne (nx ny + nz) = {work}, electrode tiles T={geom.t_tiles}, "
          f"cap={geom.cap}, block={eng.ncfg.block}, "
          f"{time.perf_counter() - t0:.2f} s")
    if not (conp.ele_zplanes is None and not pppm._use_dense(grid, ne)
            and eng.ncfg.block == 8):
        raise AssertionError("phase 21: the electrodes are not on the tiled "
                             "full-mesh path")
    rng = np.random.default_rng(21)
    x = torch.as_tensor(x_near[:ne], dtype=torch.float32, device=dev)
    q = torch.as_tensor(0.05 * rng.standard_normal(ne), dtype=torch.float32,
                        device=dev)
    slots = pppm.tile_slots(grid, x, q)
    if bool(slots.overflow):
        raise AssertionError("phase 21: electrode tile overflow")
    cfd = pppm._coeffs(grid, torch.float32, dev)
    kern = lambda: k2.spread_tiles(slots.rows, cfd, geom)
    plain = lambda: k2.tile_patches_plain(slots.rows, cfd, geom)
    got = kern()
    torch.cuda.synchronize()
    rel, dabs = compare("spread_tiles", (got,), (plain(),))
    results["spread_tiles"] = dict(rel=rel, abs=dabs, ms=median_ms(kern),
                                   plain_ms=median_ms(plain, reps=5))
    # K2b reads every slot's charge and the other rows of the charged slots
    # only: almost every slot of the grid's all-atom tile_cap is empty here
    charged = slots.rows[:, 6] != 0
    staged = slots.rows[:, :6].transpose(1, 2)[charged]      # (n, 6)
    results["spread_tiles"].update(bound(
        (slots.rows[:, 6], staged, cfd), got,
        SPREAD_FLOPS * staged.shape[0]))
    report("phase 21", results, ("spread_tiles",), card)

    # ---- phase 22: the main path
    counters = {"block_pair": k1.launches, "spread_mesh": k2.launches,
                "spread_tiles": k2.tiles_launches, "gather3": k3.launches}
    r0 = eng.rebuilds
    _, _, _, launches = main_run("phase 22", eng, dict(x0=x_near), 10, 100,
                                 counters, ne, card)
    rebuilds = eng.rebuilds - r0
    print(f"phase 22: {rebuilds} list rebuilds in 110 steps")
    if rebuilds < 1:
        raise AssertionError("phase 22: no list rebuild")
    graph_phase("phase 22b", "full_mesh", eng, dict(x0=x_near), card)

    # ---- phase 23: card (float32) against CPU (float64)
    card_vs_cpu("phase 23", eng, system, md, cfg, 2, x0=x_near)
    return {"spread_tiles": launches["spread_tiles"]}


def gather_probe_path(card, dev, results):
    """Phases 24-25, the window gather probe; fills ``results`` for K9 and
    returns its launch count from the probe run."""
    from lammps_user_conp2_tpu_torch import (exp_gather_chunk,
                                             exp_vmem_gather, k9_times)
    from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9

    # ---- phase 24: K9 against its plain version at the probe's shapes,
    # bit for bit, and its times beside each shape's bound and, at R = 1,
    # torch.gather's (k9_times.measure)
    shapes = k9_times.measure(k9, exp_vmem_gather, dev, rs=(8, 1, 3))
    for row in shapes:
        plan = k9.window_plan(row["nb"], row["W"],
                              torch.cuda.get_device_properties(
                                  dev).multi_processor_count)
        print(f"phase 24: window_gather ({row['nb']}, {row['W']}), {plan.cols} "
              f"lanes per item, a ring of {plan.slots} slots of "
              f"{plan.box_bytes} B ({plan.nbox} per window), "
              f"{plan.grid} CTAs over {plan.items} items: max|kernel - plain|"
              f" R=8 {row['err_r8']:.1e}, R=1 {row['err_r1']:.1e}, R=3 "
              f"{row['err_r3']:.1e}; R=8 {row['ms_r8']:.4f} ms (device "
              f"{row['device_ms_r8']:.4f}), R=1 {row['ms_r1']:.4f} (device "
              f"{row['device_ms_r1']:.4f}), torch.gather "
              f"{row['library_ms']:.4f} (device "
              f"{row['library_device_ms']:.4f}), bound "
              f"{row['bound_ms']:.6f} ms (bytes)  [{card}]")
        if max(row["err_r8"], row["err_r1"], row["err_r3"]) != 0.0:
            raise AssertionError("phase 24: window_gather differs from its "
                                 "plain version")
        if not row["device_ms_r1"] < row["library_device_ms"]:
            raise AssertionError("phase 24: window_gather at R = 1 is not "
                                 "faster than torch.gather")
    nb, W = exp_vmem_gather.PROBE_SHAPES[0]
    win, idx = exp_vmem_gather.probe_inputs(nb, W, dev)
    got = k9.window_gather(win, idx, 8)
    same_bits("window_gather", (got,), (k9.window_gather(win, idx, 8),))
    # ten calls a trace: single-call traces of K9 came back empty five
    # times running after phase 24's timing traces
    kernels_per_call("window_gather", lambda: k9.window_gather(win, idx, 8),
                     reps=10)
    compare("window_gather R=1 vs torch.gather",
            (k9.window_gather(win, idx, 1),), (torch.gather(win, 1, idx),),
            0.0)
    err = max(row[f"err_r{R}"] for row in shapes for R in (8, 1, 3))
    r = dict(rel=err, abs=err, ms=shapes[0]["ms_r8"],
             plain_ms=median_ms(lambda: k9.window_gather_plain(win, idx, 8),
                                reps=5),
             ms_r1=shapes[0]["ms_r1"], device_ms=shapes[0]["device_ms_r8"],
             shapes=shapes)
    r.update(bound((win, idx), got, 8 * got.numel()))
    r["library_ms"] = shapes[0]["library_ms"]
    del win, idx, got
    results["window_gather"] = r
    report("phase 24", results, ("window_gather",), card)

    # ---- phase 25: the port's probe (chained steps through K9) and the
    # global-memory gather it is measured against
    k9.launches.reset()
    probe = [exp_vmem_gather.run_probe(nb, W, R=8, device=dev)
             for nb, W in exp_vmem_gather.PROBE_SHAPES]
    launches = k9.launches.count
    print(f"phase 25: window_gather launched {launches} times in the probe")
    if launches < 1:
        raise AssertionError("phase 25: the probe did not launch K9")
    if not all(math.isfinite(p["ms"]) and p["ms"] > 0.0 for p in probe):
        raise AssertionError("phase 25: a probe time is not finite")
    hbm = exp_gather_chunk.run(device=dev)
    tab_np, idx_sets = exp_gather_chunk.make_inputs()
    tab = torch.as_tensor(tab_np, dtype=torch.float32, device=dev)
    for name, idx_np in idx_sets.items():
        idx = torch.as_tensor(idx_np, device=dev)
        compare(f"{name} gather sum, 16-byte elements vs indexing",
                (exp_gather_chunk.gather_sum_rows(tab, idx),),
                (exp_gather_chunk.gather_sum(tab, idx),), 1e-5)
    print("phase 25: ns/row, shared-memory window (K9, R=8): " + ", ".join(
        f"({p['nb']}, {p['W']}) {p['ns_row']:.4f}" for p in probe)
        + f"  [{card}]")
    print("phase 25: ns/row, global-memory gather (5.56M rows): " + ", ".join(
        f"{h['name']} {h['op']} {h['chunks']}x {h['ns_row']:.4f}"
        for h in hbm)
        + f"  [{card}]")
    return {"window_gather": launches}


if __name__ == "__main__":
    sys.exit(main())
