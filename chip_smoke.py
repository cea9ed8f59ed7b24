#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths (nine main paths through
``lammps_user_conp2_tpu_torch``: setup_conp -> build_engine -> init_state ->
Engine.run, float32; three of them again in float64 on the card; the
window gather probe ``exp_vmem_gather.run_probe``; the CG, nevery,
mixed-precision, mobile-electrode and chunked-Ewald paths of phases
30-34; the user's surface of phases 35-40: electrodes in any row
order, the command line, dump and rerun, checkpoints, the diagnostics and
the pressure, the matrix files and the profile; and the sharded step of
phases 41-43) and exits non-zero if any phase fails.

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
  9. 3 steps on the card (float32) against 3 steps on the CPU (float64,
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
from one state, 100 steps a run: GRAPH_PAIRS (two) alternating (eager,
graphed) pairs
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

Float64 on the card (the kernel wrappers take their plain versions on
CUDA float64 tensors, ``ops/kernels/build.kernel_route``):

 26. the mid-size, il and 100k cells set up and built in float64 on the
     card, 3 steps of ``Engine.run`` (graphs replayed) against the CPU
     float64 runs of phases 5, 9 and 13: max|dq| / max|q| and |dpe| / |pe|
     within F64_CARD_REL, printed per cell; no hand kernel launches.

The decks' charge and field modes on the phase-10 file (dense path, z
periodic, K4, K5, K7 and K8 every step; each main path 111 steps, a graph
phase of DECK_GRAPH_PAIRS pairs, 3 steps against float64 on the CPU):

 27. ``cond`` trial 4 (COND, FFIELD, PPPM, the feedback field), the fix
     scalar held to SCALAR_REL (as in phases 28 and 29); trials 1 and 3
     (CONQ, slab and FFIELD with the feedback field): 3 steps against the
     CPU, the right electrode at its target charge to 1e-4 e;
 28. ``il_onelayer`` trial 4 (EHGO with kappa 0, a callable target,
     FFIELD, PPPM), the fix scalar held to SCALAR_REL; then EHGO with kappa
     0.5, an explicit u0 and the anions given a width (fo != 0 on the
     electrode-anion pairs): K4 fused, K5 and K6 against their plain
     versions (2e-5) at x0 and with anions 2 A off the sheets, device ms;
 29. ``zmirror`` trial 3 (the 7,552-atom doubled cell, NOSLAB, zneutr,
     CONQ, zmirror, PPPM); 100 eager steps with the upper half equal to the
     lower half's mirror bit for bit after every step and each half's
     electrodes neutral to 1e-4 e.

The rest of the charge solve (the CG solvers with their warm start and
their blocks of ``CG_BLOCK`` iterations replayed as CUDA graphs, ``nevery``,
mixed precision, mobile electrodes, the chunked factored Ewald), each with
a graph phase of 2 pairs (graphed, eager and graphed again bit for bit;
host syncs per step):

 30. the 100k cell under CG_MATFREE in float32 (PPPM, the block list, the
     default cg_tolerance and cg_maxiter): the cold CG iterations; the
     operator apply's ms and device ms beside its GEMM bound, 8 x 2 Ne nxy
     nz FLOP at the float32 peak; CG_STEPS warm-started graphed steps with
     each solve's iterations and CG blocks (and a line when every step ran
     to cg_maxiter); K1, K2a and K3 every step; the charges after 3 steps
     against phase 9's INV run from the same state within CG_TOL_GAP; the
     operator, float32 and float64, against A assembled in float64;
 31. the mid-size cell under CG with nevery = 2: over 10 graphed steps the
     electrode charges bit-unchanged on skip steps and changed on solve
     steps, K4 once per step, K5 once per solve step and never on a skip
     step;
 32. the 100k cell with a float64 solve under a float32 engine, INV and
     CG_MATFREE: K1, K2a and K3 once per step each and no hand kernel in
     the float64 solve; INV against phase 26's float64 run within
     MIXED_F64_GAP, CG_MATFREE against the mixed INV run within
     CG_TOL_GAP (and CG_INV_GAP at CG_TIGHT_TOL);
 33. the mid-size cell under CG_MATFREE with mobile electrodes (every
     atom thermostatted, the electrodes given velocities): 3 steps in
     float32 against float64 on the card (no hand kernel there) within
     CG_TOL_GAP; the real-space block rebuilt from the moved electrodes
     and the operator there equal to A assembled at those positions;
 34. the chunked factored Ewald, CHUNK_CELL (13,440 atoms, nxy 1,813 >
     KXY_CHUNK, EWALD, INV, the block list): 3 steps in float32 against
     float64 on the card with phase 5's bounds, K1 in the float32 run; the
     peak device memory of a step beside the unchunked tables' size.

The user's surface (phases 35-40; each phase prints the kernels it
launched, the kernels line's ``launches_surface``):

 35. the mid-size cell with its 1,152 electrode rows spread through the
     7,296 atoms by a seeded permutation: the main path (10 warm-up and
     100 graphed steps, K4 with the fused correction and K5 every step,
     finite energy, neutral electrodes), a graph phase of 2 pairs of 50
     steps, and 3 card steps mapped by tag onto the electrodes-first card
     run with phase 5's bounds; cond 4 scrambled the same way (PPPM z
     planes, K4, K5, K7, K8) with the fix scalar;
 36. ``cli.main(["run", "il_onelayer", "0", "--f32", "--steps", "200",
     "--thermo", "20", "--log", ..., "--checkpoint", ...])`` with
     $CONP_REF_TESTS at a directory holding the il file: the log's header,
     11 thermo rows, Loop time and per-phase timing lines, K4, K5, K7 and
     K8 every step, the rows equal as printed to those of an
     ``Engine.run`` of the same deck;
 37. ``run --steps 60 --thermo 20 --dump`` then ``rerun``: K5 once per
     frame, each frame's electrode charges re-solved within RERUN_TOL of
     the dumped ones;
 38. at the il and 100k cells, 50 graphed steps, a checkpoint, a fresh
     engine, the file loaded and 50 more graphed steps: x, v, q, pe, the
     step counter and the thermo rows bit for bit against 100 steps; the
     file refused by the il cell scrambled and by the 100k engine;
 39. the il cell: each electrode's ``group_potential`` after the solve
     (the applied 2 V to DV_TOL, the spread within an electrode below
     SPREAD_TOL), ``potential_atom`` and ``pressure_tensor`` in float32
     against float64 on the CPU; the 100k cell (PPPM): ``pressure_tensor``
     and the left electrode's potential in float32, K2b launched, against
     float64 on the card; both within DIAG_REL, with their times;
 40. the mid-size cell set up with ``matout`` and again from the written
     ``inv_a_matrix`` (A^-1 to MATFILE_TOL, 3 steps with phase 5's
     bounds); ``cli.main(["profile", "il_onelayer", "0", "--f32"])`` and
     ``timers.profile_step`` at the 100k cell: each phase's time (CUDA
     events) and the kernels it launched (K5, K4, K7, K8 at the il cell;
     K1, K2a, K3 at the 100k cell).

The sharded step (phases 41-43, ``parallel/sharded.py``; the card is one,
so d > 1 runs as each rank's kernel work in turn and the step runs at d =
1 over a one-rank NCCL group through a FileStore):

 41. the 100k cell, float32, d = 2 and 4, one rank after another, no
     collectives: K1 over each rank's block slice of the padded list, K2a
     and K3 on each rank's atom rows with its own tile cap (the ranks'
     occupancy at x0 plus 25%), each against its plain version within
     KERNEL_TOL; the ranks' slot forces put together against the whole
     list's K1 output (whether bit for bit printed: ``block_segments``
     may split a slice's unions otherwise) and their rhok summed against
     the whole spread, within KERNEL_TOL; each kernel's ms per rank;
 42. the d = 1 sharded step at the 100k cell (K1, K2a, K3), the full-mesh
     cell (and K2b) and cond 4 on the il file (the dense path's K5 and
     K6, K7, K8, COND, the feedback field): SHARDED_STEPS steps from ``Engine.init_state``, twice, bit for
     bit, each kernel of the cell launched every step of the first run
     (counts set to 0 just before it), then ``Engine.step`` on the card
     from the same state with phase 5's bounds per step (cond 4 also the
     fix scalar);
 43. ``bench_sharded.measure`` at the 100k and mid-size cells: alternating
     eager runs of BENCH_SHARDED_STEPS steps of ``Engine.step`` and of the
     d = 1 sharded step (ms/step, the overhead), their host syncs per step
     and a profile of each (device busy, kernels and NCCL ms per step, the
     top kernels and host ops).  The process group is closed before the
     last line.  The kernels line's ``launches_sharded`` and
     ``ms_rank_slices`` carry phases 42 and 41.

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
order to the electrolyte included); K2b, K3, K7 and K8 ``device_ms`` (one
kernel each), K7 and K8 ``kernels_per_call`` and ``floor_ms``; K4, K5, K7
and K8 ``launches_decks`` (their launches on the main paths of phases
27-29), K4, K5 and K6 ``max_rel_err_ehgo_fo`` and ``device_ms_ehgo_fo``
(phase 28), ``bound_ms_decks`` (K4's and K5's bounds at the deck cells'
shapes, phases 27-29) and ``launches_surface`` (launches on phases 35-40,
by phase).  The il cell's figures carry
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
# phase 26: the steps of the card's float64 run, and its bound against
# the CPU float64 run (relative to the largest |q| and to |pe|)
F64_STEPS = 3
F64_CARD_REL = 1e-10
# the CPU float64 runs of phases 5, 9 and 13 at F64_STEPS, by cell; the
# card float32 states beside them and their max|dq_ele| (e)
CPU64 = {}
CARD32 = {}
GAP32 = {}
# phase 26's float64 card states after F64_STEPS steps, by cell
CARD64 = {}
# phases 27-29: the fix scalar, card float32 against CPU float64
SCALAR_REL = 1e-4
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
K2B_PARTS = ("spread_tiles_kernel",)
K3_PARTS = ("gather3_kernel",)
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


def agree(tag, s32, s64, ne, scalar=False):
    """Phase 5/9 bounds between a card float32 and a CPU float64 state;
    with ``scalar``, the fix scalar's relative gap too, to SCALAR_REL."""
    qe32 = s32.q[:ne].double().cpu()
    qe64 = s64.q[:ne]
    dq = float((qe32 - qe64).abs().max())
    qbound = 1e-4 * float(qe64.abs().max()) + 1e-6
    dpe = abs(float(s32.energy) - float(s64.energy)) / abs(float(s64.energy))
    df = float((s32.f.double().cpu() - s64.f).abs().max()) / float(
        s64.f.abs().max())
    ds = abs(float(s32.scalar_out) - float(s64.scalar_out)) / max(
        abs(float(s64.scalar_out)), 1e-30)
    print(f"{tag}: max|dq_ele| {dq:.3e} (bound {qbound:.3e}), pe rel "
          f"{dpe:.3e}, f rel {df:.3e}" + (f", fix scalar rel {ds:.3e} "
                                          f"({float(s64.scalar_out):.6g})"
                                          if scalar else ""))
    if not (dq <= qbound and dpe <= 1e-4 and df <= 1e-3):
        raise AssertionError(f"{tag}: outside the bounds")
    if scalar and not ds <= SCALAR_REL:
        raise AssertionError(f"{tag}: fix scalar rel {ds:.3e} > "
                             f"{SCALAR_REL}")


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
    card_vs_cpu("phase 5", eng, system, md, cfg, 3, x0=x_near, cell="mid")

    launches.update(production_path(card, dev, results))
    launches.update(il_path(card, dev, results))
    launches.update(bonded_path(card, dev, results))
    launches.update(unfused_path(card, dev, results))
    launches.update(fullmesh_path(card, dev, results))
    launches.update(gather_probe_path(card, dev, results))
    f64_path(card, dev)
    il_file = os.path.join(OUT_DIR, "il_3776.data")
    # K4, K5, K7 and K8's launches on the deck cells' main paths (their
    # ``launches`` stay those of phases 4 and 12)
    deck_launches = {
        "cond4": cond_path(card, dev, results, il_file),
        "il4_ehgo": ehgo_path(card, dev, results, il_file),
        "zmirror3": zmirror_path(card, dev, results, il_file)}
    for name in DECK_COUNTERS:
        results[name]["launches_decks"] = {
            cell: n[name] for cell, n in deck_launches.items()}
    for name, per_cell in DECK_BOUNDS.items():
        results[name]["bound_ms_decks"] = {
            cell: r["bound_ms"] for cell, r in per_cell.items()}
    # phases 30-34: the rest of the charge solve
    cg_matfree_path(card, dev, results)
    nevery_path(card, dev, results)
    mixed_path(card, dev, results)
    mobile_path(card, dev, results)
    chunked_path(card, dev, results)
    print("phases 30-34: " + json.dumps(results["solve_paths"])
          + f"  [{card}]")
    surface_paths(card, dev, results, il_file)
    # phases 41-43: the sharded step
    sharded_paths(card, dev, results, il_file)
    # each kernel's launches on those main runs, by cell, and on phases
    # 35-40, by phase
    for name, (_, counter) in KERNEL_IDS.items():
        per_cell = {cell: moved[counter] for cell, moved in
                    SOLVE_LAUNCHES.items() if moved.get(counter)}
        if per_cell:
            results[name]["launches_solve_paths"] = per_cell
        per_phase = {phase: moved[counter] for phase, moved in
                     SURFACE_LAUNCHES.items()
                     if isinstance(moved.get(counter), int) and moved[counter]}
        if per_phase:
            results[name]["launches_surface"] = per_phase
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
                                       * g["profile_steps"] / n)
        results[name]["device_ms_replay"] = per_cell
    # rule 2's order: launches per step x (device ms per launch - bound),
    # the bound at the cell's shapes where the kernels line has it
    gaps = []
    for name, (kid, counter) in KERNEL_IDS.items():
        r = results[name]
        for g in GRAPHS:
            if g["cell"] not in r["device_ms_replay"]:
                continue
            # the bound at the cell's shapes (the deck cells': phases
            # 27-29's ``deck_bounds``); cells with none stay out of the order
            key = {"mid": "bound_ms", "bonded": "bound_ms",
                   "il": "bound_ms_il", "unfused_il": "bound_ms_il",
                   "100k": "bound_ms_100k",
                   "full_mesh": "bound_ms_100k"}.get(g["cell"])
            if g["cell"] in r.get("bound_ms_decks", {}):
                b = r["bound_ms_decks"][g["cell"]]
            elif key is not None:
                b = r.get(key, r["bound_ms"])
            else:
                continue
            per_step = g["launches"][counter] / g["profile_steps"]
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
            "floor_ms", "kernels_per_call", "shapes", "launches_decks",
            "max_rel_err_ehgo_fo", "device_ms_ehgo_fo",
            "launches_solve_paths", "launches_surface", "bound_ms_decks",
            "launches_sharded", "ms_rank_slices")
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
                                  plain_ms=median_ms(plain, reps=5),
                                  device_ms=device_ms(kern, K3_PARTS))
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
    card_vs_cpu("phase 9", eng, system, md, cfg, F64_STEPS, x0=x_near,
                cell="100k")
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
        if i + 1 == F64_STEPS:
            CPU64["il"] = (system, md, cfg, None, s64)
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
        # thread-local, as models/graphs.py captures: the profiler's buffer
        # thread may call CUDA while this captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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
    qsum = float(eng.conp.ele_rows(st.q).double().sum())
    if not abs(qsum) <= 1e-4:
        raise AssertionError(f"{tag}: electrode charge sum {qsum:.3e}")
    print(f"{tag}: T={float(th['temp'][-1]):.2f} K, pe={float(st.energy):.6g}, "
          f"qleft={float(th['qleft'][-1]):.6g}, sum q_ele={qsum:.3e}")
    print(f"{tag}: {ms_step:.4f} ms/step ({1e3 / ms_step:.2f} steps/s), "
          f"{eng.system.natoms} atoms, float32  [{card}]")
    return st, th, ms_step, launches


# graphed-vs-eager pairs per cell and the steps of each run: each run
# starts from the same state (three before phases 35-40 were added)
GRAPH_PAIRS = 2
GRAPH_STEPS = 100
GRAPHS = []


def _state_diff(a, b):
    """(bit-identical, max|dx|, max|dv|, max|dq|, |dpe|) of two states."""
    d = [float((u.double() - w.double()).abs().max()) for u, w in
         ((a.x, b.x), (a.v, b.v), (a.q, b.q), (a.energy, b.energy))]
    same = all(torch.equal(u, w) for u, w in ((a.x, b.x), (a.v, b.v),
                                              (a.q, b.q),
                                              (a.energy, b.energy)))
    return (same, *d)


def graph_phase(tag, cell, eng, st_kw, card, pairs=None, steps=None):
    """The step replayed as CUDA graphs (``Engine.run``) against the eager
    step (``Engine.step`` in a loop), from the same state, GRAPH_STEPS
    steps per run: GRAPH_PAIRS alternating (eager, graphed) pairs on the
    host clock; eager vs eager, graphed vs eager and graphed vs graphed on
    x, v, q and pe, all bit for bit; the host syncs of a graphed run
    (torch.cuda.set_sync_debug_mode: none per step on the dense paths, one
    on the list paths, and with the CG solvers one more per solve and one
    per CG block: exactly the eager step's reads); a torch.profiler window
    of the same replayed steps (the same list rebuilds): the device-busy
    share of the graphed step and each hand kernel's device time per
    launch.  ``pairs``: the (eager, graphed) pairs (GRAPH_PAIRS when None);
    ``steps``: the steps of each run (GRAPH_STEPS when None).  Appends the
    cell's record to GRAPHS."""
    import warnings
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    from lammps_user_conp2_tpu_torch.step_breakdown import (device_busy,
                                                            kernel_of)
    from torch.profiler import ProfilerActivity, profile

    npairs = GRAPH_PAIRS if pairs is None else pairs
    nsteps = GRAPH_STEPS if steps is None else steps
    st0 = eng.init_state(**st_kw)
    eng.run(st0, 2, thermo_every=0)              # captured (or reused)
    torch.cuda.synchronize()
    eager_ms, graph_ms, eager_out, graph_out = [], [], [], []
    for _ in range(npairs):
        t0 = time.perf_counter()
        st = st0
        for _ in range(nsteps):
            st = eng.step(st)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) / nsteps * 1e3)
        eager_out.append(st)
        t0 = time.perf_counter()
        st, _ = eng.run(st0, nsteps, thermo_every=0)
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) / nsteps * 1e3)
        graph_out.append(st)
    # every pair of runs: eager-eager, graphed-eager, graphed-graphed
    ee = [_state_diff(eager_out[i], eager_out[j])
          for i in range(npairs) for j in range(i + 1, npairs)]
    ge = [_state_diff(g, e) for g in graph_out for e in eager_out]
    gg = [_state_diff(graph_out[i], graph_out[j])
          for i in range(npairs) for j in range(i + 1, npairs)]
    stats = {}
    for label, ds in (("eager_vs_eager", ee), ("graphed_vs_eager", ge),
                      ("graphed_vs_graphed", gg)):
        stats[label] = dict(
            bit_identical=all(d[0] for d in ds),
            max=[max(d[k] for d in ds) for k in range(1, 5)],
            median=[float(np.median([d[k] for d in ds])) for k in
                    range(1, 5)])
        st_ = stats[label]
        print(f"{tag}: {cell}, {nsteps} steps from one state, "
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
    st_th, th = eng.run(st0, nsteps, thermo_every=max(nsteps // 10, 1))
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
    # host syncs of one graphed run: the skin flag per step on the list
    # paths, and with CG one read after the solve's head and one per block
    cg = eng.conp is not None and eng.conp.cfg.solver.name != "INV"
    b0 = eng.cg_blocks
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(st0, nsteps, thermo_every=0)
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
    blocks = eng.cg_blocks - b0
    solves = sum(eng.solves(st0.step + i) for i in range(nsteps)) if cg \
        else 0
    reads = (nsteps if listed else 0) + solves + blocks
    print(f"{tag}: {syncs} host syncs in a graphed run of {nsteps} "
          f"steps ({syncs / nsteps:.2f} per step; flag reads: "
          f"{'one per step' if listed else 'none per step'}"
          + (f", {solves} CG solves with {blocks} CG blocks" if cg else "")
          + f" = {reads}, plus the end-of-run check): {where}")
    if syncs > reads + 2:
        raise AssertionError(f"{tag}: {syncs} host syncs in the graphed run")
    if syncs < reads:
        raise AssertionError(f"{tag}: the sync count missed the flag reads")
    # the profiled window, the timed runs' trajectory: busy share and
    # device time per launch
    before = {c.name: c.count for c in build.COUNTERS}
    r0 = eng.rebuilds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(st0, nsteps, thermo_every=0)
        torch.cuda.synchronize()
    rebuilds = eng.rebuilds - r0
    launched = {c.name: c.count - before[c.name] for c in build.COUNTERS
                if c.count != before[c.name]}
    busy, by_name = device_busy(prof, nsteps)
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
          f"{nsteps} replayed steps, {rebuilds} list "
          f"rebuilds), busy share {share:.3f}, "
          f"{nk:.0f} device kernels per step; eager step "
          f"{float(np.median(eager_ms)):.4f} ms  [{card}]")
    for key, (ms, cnt) in sorted(per_kernel.items()):
        print(f"    {key}: device {ms:.4f} ms/step in {cnt:.1f} CUDA kernels "
              f"per step under replay")
    GRAPHS.append(dict(
        cell=cell, natoms=eng.system.natoms, eager_ms=eager_ms,
        graph_ms=graph_ms, busy_ms=busy, busy_share=share,
        kernels_per_step=nk, host_syncs=syncs, profile_steps=nsteps,
        host_syncs_per_step=syncs / nsteps, cg_blocks=blocks,
        rebuilds_profiled=rebuilds,
        diffs=stats,
        launches=launched, kernel_device_ms_per_step={
            k: v[0] for k, v in per_kernel.items()}))
    return per_kernel, launched


def card_vs_cpu(tag, eng, system, md, cfg, nsteps, x0=None, cell=None,
                scalar=False):
    """``nsteps`` steps on the card (float32) against the CPU (float64)
    from the same positions, each held to phase 5's bounds (and the fix
    scalar as ``agree`` takes ``scalar``).  With ``cell``, the CPU run's set-up and its
    state after F64_STEPS steps are kept in CPU64 for phase 26.  Returns
    the final (card, CPU) states."""
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    t0 = time.perf_counter()
    conp64 = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                        device="cpu")
    eng64 = build_engine(system, md, conp64, dtype=torch.float64,
                         device="cpu")
    s32 = eng.init_state(x0=x0)
    s64 = eng64.init_state(x0=x0)
    agree(f"{tag}: step 0", s32, s64, conp64.ne, scalar)
    for i in range(nsteps):
        s32 = eng.step(s32)
        s64 = eng64.step(s64)
        agree(f"{tag}: step {i + 1}", s32, s64, conp64.ne, scalar)
        if cell is not None and i + 1 == F64_STEPS:
            CPU64[cell] = (system, md, cfg, x0, s64)
            CARD32[cell] = s32
            GAP32[cell] = float((s32.q[:conp64.ne].double().cpu()
                                 - s64.q[:conp64.ne]).abs().max())
    print(f"{tag}: {nsteps} steps matched the float64 CPU run "
          f"({time.perf_counter() - t0:.1f} s)")
    return s32, s64


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
                                   plain_ms=median_ms(plain, reps=5),
                                   device_ms=device_ms(kern, K2B_PARTS))
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


def f64_path(card, dev):
    """Phase 26: the float64 engine on the card.  The mid-size, il and 100k
    cells, set up and built in float64 on the card, run F64_STEPS steps of
    ``Engine.run`` (replayed as CUDA graphs: the kernel wrappers take their
    plain versions on the card) against the CPU float64 runs of phases 5,
    9 and 13: max|dq| over max|q| and |dpe| / |pe| within F64_CARD_REL,
    the gap printed per cell; no hand kernel launches."""
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    gaps = {}
    for cell in ("mid", "il", "100k"):
        system, md, cfg, x0, ref = CPU64[cell]
        t0 = time.perf_counter()
        conp = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                          device=dev)
        eng = build_engine(system, md, conp, dtype=torch.float64, device=dev)
        for c in build.COUNTERS:
            c.reset()
        st, _ = eng.run(eng.init_state(x0=x0), F64_STEPS, thermo_every=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        moved = {c.name: c.count for c in build.COUNTERS if c.count}
        if moved:
            raise AssertionError(f"phase 26: {cell}: hand kernels launched "
                                 f"in float64: {moved}")
        if len(eng._step_graphs) != 1:
            raise AssertionError(f"phase 26: {cell}: Engine.run did not "
                                 "replay one set of graphs")
        CARD64[cell] = st
        dq = float((st.q.cpu() - ref.q).abs().max()) / float(
            ref.q.abs().max())
        dpe = abs(float(st.energy) - float(ref.energy)) / abs(
            float(ref.energy))
        dx = float((st.x.cpu() - ref.x).abs().max())
        gaps[cell] = dict(dq_rel=dq, dpe_rel=dpe, dx=dx)
        path = ("per-atom Verlet list" if eng.ncfg is not None
                else "dense pair sweep")
        print(f"phase 26: {cell}, {system.natoms} atoms, float64 on the card "
              f"({path}, {'PPPM' if eng.pppm_grid is not None else 'Ewald'}),"
              f" {F64_STEPS} graphed steps against the CPU float64 run: "
              f"max|dq|/max|q| {dq:.3e}, |dpe|/|pe| {dpe:.3e}, max|dx| "
              f"{dx:.3e} A (bound {F64_CARD_REL:.0e}); set-up, capture and "
              f"run {secs:.1f} s; no hand kernel launched  [{card}]")
        if not (dq <= F64_CARD_REL and dpe <= F64_CARD_REL):
            raise AssertionError(f"phase 26: {cell}: float64 card vs CPU gap "
                                 f"above {F64_CARD_REL}")
        del eng, conp
        torch.cuda.empty_cache()
    print("phase 26: float64 gaps " + json.dumps(gaps))


DECK_COUNTERS = ("pair_forces_conp", "b_realspace", "shake_positions",
                 "rattle_velocities")


def _deck_engine(tag, deck, n, path, dev, **cfg_kw):
    """(system, md, cfg, conp, eng) of ``workloads.<deck>(n)`` on the il
    file, float64 set-up, float32 engine on the card; the ConpConfig
    fields in ``cfg_kw`` replaced."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    t0 = time.perf_counter()
    system, md, cfg = getattr(workloads, deck)(n, data_path=path)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    grid = eng.pppm_grid
    print(f"{tag}: {deck} trial {n}: {system.natoms} atoms, Ne={conp.ne}, "
          f"{cfg.mode.name}, {cfg.ff.name}, {cfg.pairmode.name}, "
          f"{cfg.kspace.name}" + (f" mesh {grid.shape}" if grid else "")
          + f", periodic {system.periodic}, efield {md.efield}, feedback "
          f"{md.efield_feedback}, zmirror {md.zmirror is not None}, "
          f"callable target {callable(cfg.target)}, set-up "
          f"{time.perf_counter() - t0:.2f} s")
    if not (eng.ncfg is None and eng.cons is not None
            and system.periodic[2] == (cfg.ff.name != "NORMAL")):
        raise AssertionError(f"{tag}: not the dense path with SHAKE, z "
                             "periodic exactly outside the slab mode")
    return system, md, cfg, conp, eng


def _deck_main(tag, cell, deck, n, path, dev, card):
    """The deck cell's main path (11 warm-up and 100 timed steps, K4, K5,
    K7 and K8 every step), its graph phase (graphed vs eager and graphed vs
    graphed bit for bit, the replay profile) and 3 steps card float32 vs
    CPU float64 with the fix scalar; returns (system, md, cfg, conp, eng,
    launches, final card state of the agreement run)."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    system, md, cfg, conp, eng = _deck_engine(tag, deck, n, path, dev)
    deck_bounds(tag, cell, system, md, conp, eng, card)
    counters = dict(zip(DECK_COUNTERS, (k4.launches, k5.launches,
                                        k78.shake_launches,
                                        k78.rattle_launches)))
    _, th, _, launches = main_run(tag, eng, {}, 11, 100, counters, conp.ne,
                                  card)
    print(f"{tag}: fix scalar f_e {float(th['f_e'][-1]):.6g}, qright "
          f"{float(th['qright'][-1]):.6g}")
    graph_phase(tag + "b", cell, eng, {}, card, pairs=DECK_GRAPH_PAIRS)
    s32, _ = card_vs_cpu(tag, eng, system, md, cfg, 3, scalar=True)
    return system, md, cfg, conp, eng, launches, s32


# K4's and K5's bounds at the deck cells' shapes and x0, by cell (the
# kernels line's ``bound_ms_decks``)
DECK_BOUNDS = {"pair_forces_conp": {}, "b_realspace": {}}


def deck_bounds(tag, cell, system, md, conp, eng, card):
    """K4's and K5's bounds at the deck cell's shapes, its x0 and charges
    (as phase 11 works them out at the il cell): their tensors read and
    written once, and PAIR_FLOPS per pair within the cutoff, B_ROW_FLOPS
    per electrode-electrolyte pair within the Coulomb cutoff, z periodic
    or not as the deck is."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
    dev = eng.type_idx.device
    x0 = torch.as_tensor(system.x0, dtype=torch.float32, device=dev)
    q = torch.as_tensor(system.q0, dtype=torch.float32, device=dev)
    zsort = z_perm(x0, system.box, system.periodic)
    pkw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    pairs = k4_pairs(tag, k4, x0, zsort, system, md.cutoff, card,
                     m=eng.excl_idx.shape[1])
    got = k4.pair_forces(x0, q, eng.type_idx, eng.tables, eng.exclusions,
                         zsort=zsort, conp_fuse=fuse,
                         ele_idx=conp.ele_idx_t, **pkw)
    DECK_BOUNDS["pair_forces_conp"][cell] = bound(
        (x0, q, eng.type_idx, eng.tables, eng.exclusions, zsort, fuse), got,
        PAIR_FLOPS * pairs)
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    bargs = (x0, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
             conp.fo_rows, conp.type_t)
    got = k5.b_realspace(*bargs, zsort=zsort, box=system.box,
                         periodic=system.periodic, cut_coulsq=conp.cut_coulsq,
                         g_ewald=conp.ksp.g_ewald)
    xe = conp.ele_rows(x0)
    xl = x0[conp.elyte_t]
    DECK_BOUNDS["b_realspace"][cell] = bound(
        (bargs, zsort), got, B_ROW_FLOPS * pairs_within(
            xe, xl, system.box, system.periodic, conp.cut_coulsq))
    torch.cuda.synchronize()
    for name in DECK_BOUNDS:
        r = DECK_BOUNDS[name][cell]
        print(f"{tag}: {name} bound at the {cell} cell {r['bound_ms']:.6f} "
              f"ms ({r['bound_by']})")


# phase 28's EHGO variant: the anions' Gaussian width (1/A)
EHGO_ANION_ETA = 1.6
# (eager, graphed) pairs of the deck cells' graph phases (27-29)
DECK_GRAPH_PAIRS = 2


def cond_path(card, dev, results, path):
    """Phase 27: the cond deck on the 3,776-atom file.  Trial 4 (COND,
    FFIELD, PPPM, the feedback field): the main path, its graph phase and 3
    steps card vs CPU with the fix scalar held to SCALAR_REL; trials 1 and
    3 (CONQ, slab and FFIELD with the feedback field): 3 steps card vs CPU
    with the fix scalar, and the right electrode holds its target charge
    to 1e-4 e.  Returns K4, K5,
    K7 and K8's launches on trial 4's main path."""
    *_, launches, _ = _deck_main("phase 27", "cond4", "cond", 4, path, dev,
                                 card)
    for n in (1, 3):
        tag = f"phase 27: trial {n}"
        system, md, cfg, conp, eng = _deck_engine(tag, "cond", n, path, dev)
        s32, _ = card_vs_cpu(tag, eng, system, md, cfg, 3, scalar=True)
        qr = float(eng.thermo(s32)["qright"])
        print(f"{tag}: right electrode {qr:.8f} e, target {cfg.target} "
              f"(off by {abs(qr - cfg.target):.3e} e)")
        if not abs(qr - cfg.target) <= 1e-4:
            raise AssertionError(f"{tag}: right electrode off its target")
        del eng, conp
    return launches


def ehgo_path(card, dev, results, path):
    """Phase 28: il_onelayer trial 4 (EHGO with kappa 0, a callable target,
    FFIELD, PPPM) as phase 27's trial 4; then EHGO with kappa 0.5 and an
    explicit u0, the anions given a width of EHGO_ANION_ETA (fo != 0 on the
    electrode-anion pairs): K4 fused, K5 and K6 against their plain versions
    at this path's shapes (2e-5, tools/kernel_oracle.py), at x0 and with
    anions 2 A off the sheets, with their device ms.  Returns K4, K5, K7
    and K8's launches on trial 4's main path."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
    system, md, cfg, _, _, launches, _ = _deck_main(
        "phase 28", "il4_ehgo", "il_onelayer", 4, path, dev, card)
    tag = "phase 28: kappa 0.5"
    u0 = 1.2 * math.sqrt(2 / math.pi) * cfg.eta / system.units().evscale
    # the anions (type 4) take a width too: with the electrode type alone
    # fo != 0 only between electrodes, in A, and no kernel sees it
    ehgo = dataclasses.replace(cfg.ehgo, kappa=0.5, eta_by_type=(
        (5, cfg.eta, u0), (4, EHGO_ANION_ETA, None)))
    system, md, cfg, conp, eng = _deck_engine(tag, "il_onelayer", 4, path,
                                              dev, ehgo=ehgo)
    fo_max = float(eng.fo_tab.abs().max())
    print(f"{tag}: max|fo| {fo_max:.6g}, r_corr {eng.r_corr} A")
    if not fo_max > 0.0:
        raise AssertionError(f"{tag}: no overlap term")
    rng = np.random.default_rng(28)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    pkw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
               g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    out = {}
    for label, xs in (("x0", system.x0), ("anions 2 A off the sheets",
                      workloads.near_sheet_positions(system, gap=2.0))):
        x = torch.as_tensor(xs, dtype=torch.float32, device=dev)
        zsort = z_perm(x, system.box, system.periodic)
        kern = lambda: k4.pair_forces(x, q, eng.type_idx, eng.tables,
                                      eng.exclusions, zsort=zsort,
                                      conp_fuse=fuse, **pkw)
        got = kern()
        torch.cuda.synchronize()
        rel, dabs = compare(f"pair_forces_conp fo != 0, {label}", got,
                            k4.pair_forces_plain(
                                x, q, eng.type_idx, eng.tables,
                                eng.exclusions, conp_fuse=fuse, **pkw))
        if not abs(float(got[3])) > 0.0:
            raise AssertionError(f"{tag}: K4's ecorr is 0 at {label}")
        q_el = torch.where(conp.elyte_t, q, torch.zeros_like(q))
        bargs = (x, q_el, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
                 conp.fo_rows, conp.type_t)
        bkw = dict(box=system.box, periodic=system.periodic,
                   cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
        kb = lambda: k5.b_realspace(*bargs, zsort=zsort, **bkw)
        rb = compare(f"b_realspace fo != 0, {label}", (kb(),),
                     (k5.b_realspace_plain(*bargs, **bkw),))
        cargs = (x, q, eng.type_idx, conp.ele_idx_t, eng.ele_flag,
                 eng.elyte_flag, eng.eta_tab, eng.fo_tab)
        ckw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
                   qqr2e=system.units().qqr2e)
        kc = lambda: k5.conp_correction(*cargs, zsort=zsort, r_corr=eng.r_corr,
                                        gtab=eng.corr_gtab, **ckw)
        rc = compare(f"conp_correction fo != 0, {label}", kc(),
                     k5.conp_correction_plain(*cargs, **ckw))
        out[label] = dict(
            k4=(rel, dabs, device_ms(kern, K4_PARTS)),
            k5=(*rb, device_ms(kb, K5_PARTS)),
            k6=(*rc, device_ms(kc, K6_PARTS)))
        print(f"{tag}, {label}: device ms per call K4 fused "
              f"{out[label]['k4'][2]:.4f}, K5 {out[label]['k5'][2]:.4f}, K6 "
              f"{out[label]['k6'][2]:.4f}; ecorr {float(got[3]):.6g}  [{card}]")
    # the kernels line: the worst error and the device ms per position set
    for name, key in (("pair_forces_conp", "k4"), ("b_realspace", "k5"),
                      ("conp_correction", "k6")):
        results[name]["max_rel_err_ehgo_fo"] = max(
            o[key][0] for o in out.values())
        results[name]["device_ms_ehgo_fo"] = {
            label: o[key][2] for label, o in out.items()}
    return launches


def zmirror_path(card, dev, results, path):
    """Phase 29: zmirror trial 3 on the doubled 3,776-atom file (7,552
    atoms, NOSLAB, zneutr, CONQ, zmirror, PPPM): the main path and its
    graph phase (graphed vs eager bit for bit, the replay profile); 100
    eager steps with the upper half equal to the lower half's mirror after
    every step, bit for bit, and each half's electrodes neutral to 1e-4 e;
    3 steps card vs CPU with the fix scalar.  Returns K4, K5, K7 and K8's
    launches on the main path."""
    system, md, cfg, conp, eng, launches, _ = _deck_main(
        "phase 29", "zmirror3", "zmirror", 3, path, dev, card)
    zm = eng.zmirror
    pos = torch.as_tensor(system.x0[:, 2] > 0.0, device=dev)
    ele = torch.as_tensor(system.ele_mask, device=dev)
    st = eng.init_state()
    worst = 0.0
    for i in range(100):
        st = eng.step(st)
        src = st.x[zm.src_idx]
        dst = st.x[zm.dst_idx]
        if not (torch.equal(dst[:, :2], src[:, :2])
                and torch.equal(dst[:, 2], zm.zoffset - src[:, 2])):
            raise AssertionError(f"phase 29: step {i + 1}: the mirrored half "
                                 "differs from the mirror of its source")
        halves = [float(st.q[ele & m].double().sum()) for m in (pos, ~pos)]
        worst = max(worst, *map(abs, halves))
    print(f"phase 29: 100 eager steps, the upper half the lower half's "
          f"mirror bit for bit after every step; max |sum q_ele| per half "
          f"{worst:.3e} e")
    if not worst <= 1e-4:
        raise AssertionError("phase 29: a half's electrodes are not neutral")
    return launches


# phases 30-34: the rest of the charge solve
# CG against INV, e, where the CG tolerance does not set the gap (the JAX
# package's note puts the default tolerance's gap near 1e-4 e at its
# dilute deck: tests/test_modes.py:101-103)
CG_INV_GAP = 2e-4
# the tolerance of phase 32's float64 CG run held to CG_INV_GAP (a float32
# CG below its rounding floor wanders); and the bound of the default
# tolerance's own gap to INV, e: at the 100k cell the CG stops after 4
# cold iterations, 1.335e-3 e from INV with a float32 and with a float64
# solve alike (NVIDIA H100 80GB HBM3, 700 W); the port's CG takes the JAX
# package's iterations (tests/test_torch_cg.py)
CG_TIGHT_TOL = 1e-12
CG_TOL_GAP = 2e-3
# the matrix-free operator against A assembled in float64 (relative to
# max|A p|): its float64 build, and its float32 build against that
OP_REL64 = 1e-9
OP_REL32 = 1e-4
# phase 32: the mixed-precision INV run against phase 26's float64 run, e
MIXED_F64_GAP = 1e-5
# phase 30's warm-started steps, and the steps of each run in the graph
# phases of 30 and 32-34
CG_STEPS = 20
CG_GRAPH_STEPS = 20
# phase 34's cell: the mid-size density in a 70 A wide box, above KXY_CHUNK
CHUNK_CELL = dict(n_elyte=12288, nele_side=24, lz=60.0, lxy=70.0)
# hand-kernel launches on the main runs of phases 30-34, by cell and counter
SOLVE_LAUNCHES = {}


def device_ms_all(fn, reps=10) -> float:
    """Device time per call of every CUDA kernel ``fn`` launches
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type.name == "CUDA") / 1e3 / reps


def _launch_counts() -> dict:
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    return {c.name: c.count for c in build.COUNTERS}


def _moved(before) -> dict:
    from lammps_user_conp2_tpu_torch.ops.kernels import build
    return {c.name: c.count - before[c.name] for c in build.COUNTERS
            if c.count != before[c.name]}


def _ele_gap(a, b, ne) -> float:
    return float((a.q[:ne].double().cpu() - b.q[:ne].double().cpu()).abs()
                 .max())


def cg_matfree_path(card, dev, results):
    """Phase 30: the 100k cell under CG_MATFREE in float32, as
    ``tools/step_breakdown_large.py`` configures it (PPPM, the block list,
    the default cg_tolerance and cg_maxiter): the cold CG iterations; the
    operator apply's ms and device ms beside its GEMM bound; CG_STEPS
    warm-started graphed steps, each solve's iterations and CG blocks (and
    whether every step ran to cg_maxiter); K1, K2a and K3 every step; the
    charges after F64_STEPS steps against phase 9's INV run from the same
    state within CG_TOL_GAP; the operator against A (``operator_check``);
    a graph phase of 2 pairs."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import CG_BLOCK, setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell
    from lammps_user_conp2_tpu_torch.utils.config import Solver
    tag = "phase 30"
    system, md, cfg = large_cell()
    cfg = dataclasses.replace(cfg, solver=Solver.CG_MATFREE)
    x_near = workloads.near_wall_positions(system)
    t0 = time.perf_counter()
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    fk, ne = conp.fksp, conp.ne
    print(f"{tag}: {system.natoms} atoms, Ne={ne}, CG_MATFREE (tolerance "
          f"{cfg.cg_tolerance}, maxiter {cfg.cg_maxiter}, CG_BLOCK "
          f"{CG_BLOCK}), "
          f"PPPM mesh {eng.pppm_grid.shape}, the operator's factored Ewald "
          f"nxy={fk.nxy}, nz={fk.nz}, block list {eng.ncfg.block}, set-up "
          f"{time.perf_counter() - t0:.2f} s")
    if not (eng.ncfg.block == 8 and eng.fksp is None):
        raise AssertionError(f"{tag}: not the block list with PPPM forces")
    st = eng.init_state(x0=x_near)
    cold = conp.cg_iterations(st.x, st.q, st.nbr, eng.ncfg, st.tasg)
    print(f"{tag}: cold CG iterations at x_near: {cold}")
    # the operator apply: eight (Ne, nxy, nz) products
    pend = conp.solve_begin(st.x, st.q, st.nbr, eng.ncfg, st.tasg,
                            step=st.step_t + 1, scalar_prev=st.scalar_out)
    op = conp.operator(pend)
    p = pend.cg.p
    apply_ms = median_ms(lambda: op(p))
    apply_dev = device_ms_all(lambda: op(p))
    flops = 8 * 2 * ne * fk.nxy * fk.nz
    apply_bound = flops / F32_FLOP_PER_S * 1e3
    print(f"{tag}: operator apply {apply_ms:.4f} ms (events), device "
          f"{apply_dev:.4f} ms; GEMM bound {apply_bound:.4f} ms ({flops:.4g} "
          f"FLOP at {F32_FLOP_PER_S:.3g} FLOP/s float32), "
          f"{100 * apply_bound / apply_dev:.1f}% of it  [{card}]")
    del pend, op, p
    # warm-started graphed steps, one run each: the iterations per solve
    before = _launch_counts()
    its, blocks = [], []
    t0 = time.perf_counter()
    for _ in range(CG_STEPS):
        b0 = eng.cg_blocks
        st, _ = eng.run(st, 1, thermo_every=0)
        runner = next(iter(eng._step_graphs.values()))
        its.append(int(runner.pend.cg.it))
        blocks.append(eng.cg_blocks - b0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    moved = _moved(before)
    SOLVE_LAUNCHES["100k_cg_matfree"] = moved
    print(f"{tag}: {CG_STEPS} warm-started graphed steps, CG iterations per "
          f"solve {its}, CG blocks replayed per step {blocks} (mean "
          f"{np.mean(blocks):.2f}), {1e3 * secs / CG_STEPS:.2f} ms/step with "
          f"a run per step; launches {moved}  [{card}]")
    if all(i >= cfg.cg_maxiter for i in its):
        print(f"{tag}: CG ran to cg_maxiter={cfg.cg_maxiter} on every step "
              f"(float32 never met <r, p>/Ne < {cfg.cg_tolerance})")
    for name in ("block_pair", "spread_mesh", "gather3"):
        if moved.get(name, 0) != CG_STEPS:
            raise AssertionError(f"{tag}: {name} launched "
                                 f"{moved.get(name, 0)} times in {CG_STEPS} "
                                 "steps")
    if not math.isfinite(float(st.energy)):
        raise AssertionError(f"{tag}: energy is not finite")
    # the charges after F64_STEPS steps against phase 9's INV run, at the
    # default tolerance
    s = eng.init_state(x0=x_near)
    for _ in range(F64_STEPS):
        s = eng.step(s)
    gap = _ele_gap(s, CARD32["100k"], ne)
    print(f"{tag}: after {F64_STEPS} steps max|q_ele(CG_MATFREE) - "
          f"q_ele(INV, phase 9)| {gap:.3e} e at the default tolerance "
          f"(bound {CG_TOL_GAP})")
    if not gap <= CG_TOL_GAP:
        raise AssertionError(f"{tag}: CG_MATFREE vs INV gap {gap:.3e} e")
    op_err = operator_check(tag, conp, s.x, dev, card)
    graph_phase(f"{tag}b", "100k_cg_matfree", eng, dict(x0=x_near), card,
                pairs=2, steps=CG_GRAPH_STEPS)
    results["solve_paths"] = dict(
        cg_cold_iterations=cold, cg_iterations=its, cg_blocks=blocks,
        apply_ms=apply_ms, apply_device_ms=apply_dev,
        apply_bound_ms=apply_bound, cg_vs_inv_gap=gap,
        operator_rel_err=op_err)
    del eng, conp, st, s
    torch.cuda.empty_cache()


def operator_check(tag, conp, x, dev, card):
    """The CG_MATFREE operator of ``conp`` at positions x (the solve dtype,
    the real-space block rebuilt at x with mobile electrodes) against the
    same operator built in float64, and that against A assembled in float64
    on the CPU at x as INV's set-up assembles it, on a neutral random p:
    within OP_REL32 and OP_REL64 of max|A p|.  Returns both errors."""
    from lammps_user_conp2_tpu_torch.models import conp as C
    from lammps_user_conp2_tpu_torch.models.electrodes import assemble_amatrix
    from lammps_user_conp2_tpu_torch.ops import ewald_factored as ewf
    ne, k, g = conp.ne, conp.kernels, conp.ksp.g_ewald
    ele = conp.ele_idx
    xe = x[:ne].double()
    a = assemble_amatrix(xe.cpu().numpy(), conp.type_idx[ele],
                         k.self_diag[ele], conp.ksp, k, box=conp.box,
                         periodic=conp.periodic, cut_coulsq=conp.cut_coulsq)
    rb = C.realspace_block(xe, torch.as_tensor(conp.type_idx[ele],
                                               device=dev),
                           k.potential_A, g=g, box=conp.box,
                           periodic=conp.periodic, cut_coulsq=conp.cut_coulsq)
    diag = torch.as_tensor(k.self_diag[ele] - 2.0 / math.sqrt(math.pi) * g,
                           dtype=torch.float64, device=dev)
    op64 = C.make_matfree_operator(
        ewf.factorize(conp.ksp, device=dev, dtype=torch.float64), xe, rb,
        diag, slabflag=conp.ksp.slabflag, volume=conp.ksp.volume)
    op = conp._matfree_operator(x.to(conp.solve_dtype))
    p = np.random.default_rng(30).standard_normal(ne)
    p -= p.mean()
    ap = a.numpy() @ p
    pt = torch.as_tensor(p, device=dev)
    got64 = op64(pt).cpu().numpy()
    got = op(pt.to(conp.solve_dtype)).double().cpu().numpy()
    scale = np.abs(ap).max()
    rel64 = float(np.abs(got64 - ap).max() / scale)
    rel = float(np.abs(got - got64).max() / scale)
    print(f"{tag}: the matrix-free operator at the step's positions: float64 "
          f"against A assembled in float64 {rel64:.3e} (bound {OP_REL64}), "
          f"{conp.solve_dtype} against float64 {rel:.3e} (bound {OP_REL32}) "
          f"of max|A p|  [{card}]")
    if not (rel64 <= OP_REL64 and rel <= OP_REL32):
        raise AssertionError(f"{tag}: the operator is not A")
    return dict(float64_vs_a=rel64, solve_dtype_vs_float64=rel)


def nevery_path(card, dev, results):
    """Phase 31: the mid-size cell under CG with nevery = 2, float32: over
    10 graphed steps (a run each) the electrode charges bit-unchanged on
    the steps that skip the solve and changed on the others; K4 once per
    step, K5 once on solve steps and never on skip steps; a graph phase of
    2 pairs (both variants of the step replayed)."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.utils.config import Solver
    tag = "phase 31"
    system, md, cfg = workloads.synthetic(**CELL)
    cfg = dataclasses.replace(cfg, solver=Solver.CG, nevery=2)
    x_near = workloads.near_wall_positions(system)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    ne = conp.ne
    if eng.ncfg is not None:
        raise AssertionError(f"{tag}: not the dense path")
    st = eng.init_state(x0=x_near)
    rows = []
    total = {}
    for i in range(10):
        before = _launch_counts()
        q0 = st.q[:ne].clone()
        b0 = eng.cg_blocks
        st, _ = eng.run(st, 1, thermo_every=0)
        moved = _moved(before)
        for k, n in moved.items():
            total[k] = total.get(k, 0) + n
        solve = eng.solves(i)
        same = torch.equal(st.q[:ne], q0)
        k4n, k5n = moved.get("pair_forces", 0), moved.get("b_realspace", 0)
        rows.append(f"step {i + 1} {'solve' if solve else 'skip'}: q_ele "
                    f"{'unchanged' if same else 'changed'}, K4 {k4n}, K5 "
                    f"{k5n}, CG blocks {eng.cg_blocks - b0}")
        if not (same != solve and k4n == 1 and k5n == int(solve)):
            raise AssertionError(f"{tag}: {rows[-1]}")
    SOLVE_LAUNCHES["mid_cg_nevery2"] = total
    print(f"{tag}: {system.natoms} atoms, CG, nevery 2, 10 graphed steps: "
          + "; ".join(rows))
    graph_phase(f"{tag}b", "mid_cg_nevery2", eng, dict(x0=x_near), card,
                pairs=2, steps=50)
    del eng, conp
    torch.cuda.empty_cache()


def mixed_path(card, dev, results):
    """Phase 32: the 100k cell with a float64 solve under a float32 engine,
    under INV and CG_MATFREE: F64_STEPS graphed steps; K1, K2a and K3 once
    per step each and no other hand kernel (the float64 solve takes the
    plain versions: K2a moves by 1 per step, not 2); INV against phase 26's
    float64 run within MIXED_F64_GAP, CG_MATFREE against the mixed INV run
    within CG_TOL_GAP at the default tolerance and CG_INV_GAP at
    CG_TIGHT_TOL; a graph phase of 2 pairs each at the default
    tolerance."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell
    from lammps_user_conp2_tpu_torch.utils.config import Solver
    tag = "phase 32"
    system, md, cfg = large_cell()
    x_near = workloads.near_wall_positions(system)
    ref = {}
    gaps = {}
    for solver in ("INV", "CG_MATFREE", "CG_MATFREE tight"):
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, solver=Solver[solver.split()[0]])
        if solver.endswith("tight"):
            c = dataclasses.replace(c, cg_tolerance=CG_TIGHT_TOL)
        conp = setup_conp(system, md, c, solve_dtype=torch.float64,
                          device=dev)
        eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
        ne = conp.ne
        if not (eng.ncfg.block == 8 and eng.fksp is None
                and eng.dtype == torch.float32):
            raise AssertionError(f"{tag}: not the float32 block-list engine")
        st = eng.init_state(x0=x_near)
        before = _launch_counts()
        st, _ = eng.run(st, F64_STEPS, thermo_every=0)
        torch.cuda.synchronize()
        moved = _moved(before)
        cell = "100k_mixed_" + solver.lower().replace(" ", "_")
        SOLVE_LAUNCHES[cell] = moved
        want = {n: F64_STEPS for n in ("block_pair", "spread_mesh",
                                       "gather3")}
        if moved != want:
            raise AssertionError(f"{tag}: {solver}: launches {moved}, not "
                                 f"{want}")
        if solver == "INV":
            gaps[solver] = _ele_gap(st, CARD64["100k"], ne)
            bound = MIXED_F64_GAP
            against = "phase 26's float64 run"
        else:
            gaps[solver] = _ele_gap(st, ref["INV"], ne)
            bound = CG_INV_GAP if solver.endswith("tight") else CG_TOL_GAP
            against = "the mixed INV run"
        ref[solver] = st
        print(f"{tag}: {solver}, tolerance {c.cg_tolerance}, float64 solve "
              f"under a float32 engine, "
              f"{F64_STEPS} graphed steps (set-up and run "
              f"{time.perf_counter() - t0:.1f} s): launches {moved}; "
              f"max|dq_ele| against {against} {gaps[solver]:.3e} e (bound "
              f"{bound})  [{card}]")
        if not gaps[solver] <= bound:
            raise AssertionError(f"{tag}: {solver} gap {gaps[solver]:.3e}")
        if not solver.endswith("tight"):
            graph_phase(f"{tag}b", cell, eng, dict(x0=x_near), card,
                        pairs=2, steps=CG_GRAPH_STEPS)
        del eng, conp
        torch.cuda.empty_cache()
    results["solve_paths"]["mixed_gaps"] = gaps
    del ref


def mobile_path(card, dev, results):
    """Phase 33: the mid-size cell under CG_MATFREE with mobile electrodes
    (a thermostat on every atom, the electrodes given velocities): 3 steps
    in float32 against the same run in float64 on the card (the plain
    route: no hand kernel launches there), the gap within CG_TOL_GAP (the
    two CG runs stop at different iterates); the electrodes moved, the
    real-space block rebuilt from them after step 1 and the operator there
    equal to A assembled at the moved positions (``operator_check``); a
    graph phase of 2 pairs."""
    import dataclasses
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.utils.config import (Solver,
                                                          ThermostatConfig)
    tag = "phase 33"
    system, md, cfg = workloads.synthetic(**CELL)
    system = dataclasses.replace(system, groups=dict(
        system.groups, all=np.ones(system.natoms, bool)))
    md = dataclasses.replace(md, thermostats=(
        ThermostatConfig("all", 300.0, 300.0, 100.0),))
    cfg = dataclasses.replace(cfg, solver=Solver.CG_MATFREE,
                              mobile_electrodes=True)
    x_near = workloads.near_wall_positions(system)
    rng = np.random.default_rng(33)
    v0 = np.array(system.v0)
    v0[system.ele_mask] = 0.005 * rng.standard_normal(
        (int(system.ele_mask.sum()), 3))
    runs = {}
    for dt in (torch.float32, torch.float64):
        conp = setup_conp(system, md, cfg, solve_dtype=dt, device=dev)
        eng = build_engine(system, md, conp, dtype=dt, device=dev)
        before = _launch_counts()
        st = eng.init_state(x0=x_near, v0=v0)
        st, _ = eng.run(st, F64_STEPS, thermo_every=0)
        torch.cuda.synchronize()
        moved = _moved(before)
        if dt == torch.float64 and moved:
            raise AssertionError(f"{tag}: hand kernels launched in float64: "
                                 f"{moved}")
        if dt == torch.float32:
            SOLVE_LAUNCHES["mid_mobile_cg_matfree"] = moved
            if not (moved.get("pair_forces", 0) >= F64_STEPS
                    and moved.get("b_realspace", 0) >= F64_STEPS):
                raise AssertionError(f"{tag}: K4/K5 launches {moved}")
        runs[dt] = (conp, eng, st)
        print(f"{tag}: {dt}: launches {moved}")
    conp32, eng32, s32 = runs[torch.float32]
    ne = conp32.ne
    gap = _ele_gap(s32, runs[torch.float64][2], ne)
    # the float32 and the float64 CG stop at different iterates, each
    # within the default tolerance's gap of the exact answer
    bound = CG_TOL_GAP
    dx = float((s32.x[:ne].double().cpu()
                - torch.as_tensor(x_near[:ne])).abs().max())
    s1, _ = eng32.run(eng32.init_state(x0=x_near, v0=v0), 1, thermo_every=0)
    pend = conp32.solve_begin(s1.x, s1.q, step=s1.step_t + 1,
                              scalar_prev=s1.scalar_out)
    drb = float((pend.op.real_block - conp32.real_block).abs().max())
    print(f"{tag}: {system.natoms} atoms, mobile electrodes moved up to "
          f"{dx:.3e} A in {F64_STEPS} steps; real-space block after step 1 "
          f"differs from the set-up one by up to {drb:.3e}; float32 vs "
          f"float64 on the card max|dq_ele| {gap:.3e} e (bound {bound}; "
          f"phase 5's float32 vs float64 gap with INV {GAP32['mid']:.3e})  "
          f"[{card}]")
    if not (dx > 0.0 and drb > 0.0):
        raise AssertionError(f"{tag}: the electrodes or their block did not "
                             "move")
    if not gap <= bound:
        raise AssertionError(f"{tag}: float32 vs float64 gap {gap:.3e}")
    op_err = operator_check(tag, conp32, s1.x, dev, card)
    del runs, pend
    graph_phase(f"{tag}b", "mid_mobile_cg_matfree", eng32,
                dict(x0=x_near, v0=v0), card, pairs=2, steps=CG_GRAPH_STEPS)
    results["solve_paths"]["mobile_gap"] = gap
    results["solve_paths"]["mobile_operator_rel_err"] = op_err
    del eng32, conp32
    torch.cuda.empty_cache()


def chunked_path(card, dev, results):
    """Phase 34: the chunked factored Ewald, CHUNK_CELL (13,440 atoms, EWALD,
    INV, nxy above KXY_CHUNK, the block list on the card): 3 steps in
    float32 against float64 on the card with phase 5's bounds; K1 in the
    float32 run, no hand kernel in the float64 one; a graph phase of 2
    pairs; the peak device memory a step adds beside the size of the
    unchunked (N, nxy) tables."""
    import types
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops import ewald_factored as ewf
    tag = "phase 34"
    system, md, cfg = workloads.synthetic(**CHUNK_CELL)
    x_near = workloads.near_wall_positions(system)
    states = {}
    engs = {}
    for dt in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        conp = setup_conp(system, md, cfg, solve_dtype=dt, device=dev)
        eng = build_engine(system, md, conp, dtype=dt, device=dev)
        before = _launch_counts()
        st = eng.init_state(x0=x_near)
        st, _ = eng.run(st, F64_STEPS, thermo_every=0)
        torch.cuda.synchronize()
        moved = _moved(before)
        print(f"{tag}: {dt}: {system.natoms} atoms, Ne={conp.ne}, EWALD nxy="
              f"{conp.fksp.nxy} nz={conp.fksp.nz} (KXY_CHUNK "
              f"{ewf.KXY_CHUNK}), list block={eng.ncfg.block}, set-up and "
              f"run {time.perf_counter() - t0:.1f} s; launches {moved}")
        if not (conp.fksp.nxy > ewf.KXY_CHUNK and eng.ncfg is not None):
            raise AssertionError(f"{tag}: not a chunked Ewald list cell")
        if dt == torch.float32:
            SOLVE_LAUNCHES["chunked_ewald"] = moved
            if not (eng.ncfg.block == 8
                    and moved.get("block_pair", 0) >= F64_STEPS):
                raise AssertionError(f"{tag}: K1 did not run: {moved}")
        elif moved:
            raise AssertionError(f"{tag}: hand kernels in float64: {moved}")
        states[dt], engs[dt] = st, eng
    s64 = states[torch.float64]
    ref = types.SimpleNamespace(q=s64.q.cpu(), energy=s64.energy.cpu(),
                                f=s64.f.cpu(), scalar_out=s64.scalar_out.cpu())
    agree(f"{tag}: after {F64_STEPS} steps, float32 vs float64 on the card",
          states[torch.float32], ref, int(system.ele_mask.sum()))
    eng = engs[torch.float32]
    del engs, states, s64, ref
    torch.cuda.empty_cache()
    graph_phase(f"{tag}b", "chunked_ewald", eng, dict(x0=x_near), card,
                pairs=2, steps=CG_GRAPH_STEPS)
    st = eng.init_state(x0=x_near)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = eng.step(st)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    whole = 2 * system.natoms * eng.conp.fksp.nxy * 4
    print(f"{tag}: peak device memory a float32 step adds {peak / 2**20:.1f} "
          f"MiB; the unchunked (N, nxy) tables alone {whole / 2**20:.1f} MiB "
          f"(2 x {system.natoms} x {eng.conp.fksp.nxy} x 4 bytes)  [{card}]")
    results["solve_paths"]["chunked_peak_mib"] = peak / 2**20
    results["solve_paths"]["unchunked_tables_mib"] = whole / 2**20
    del eng, st
    torch.cuda.empty_cache()


# ---------------------------------------------------------- phases 35-40
# each phase's launches by counter name (the kernels line's
# ``launches_surface``)
SURFACE_LAUNCHES = {}
# phase 39: card float32 against float64, relative to the largest |value|
DIAG_REL = 1e-3
# phase 39's oracle on the il cell (tests/test_diagnostics.py:46-57)
DV_TOL = 1e-3
SPREAD_TOL = 2e-4
# phase 37: the dump's 8 significant digits (tests/test_checkpoint_rerun.py)
RERUN_TOL = 2e-7
# phase 40: A^-1 as printed (%20.12f, the JAX writer's digits): half the
# last digit, plus float64 rounding of entries below 10
MATFILE_TOL = 5e-13 + 10 * 2.0 ** -52


def _f32_engine(system, md, cfg, dev):
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    return build_engine(system, md, conp, dtype=torch.float32, device=dev)


def _by_tag(st, perm):
    """A state of the scrambled system (its row k is row perm[k] of the
    electrodes-first one) in the electrodes-first row order."""
    import types
    inv = torch.as_tensor(np.argsort(perm), device=st.x.device)
    return types.SimpleNamespace(x=st.x[inv], q=st.q[inv], f=st.f[inv],
                                 energy=st.energy, scalar_out=st.scalar_out)


def _cpu64(st):
    import types
    return types.SimpleNamespace(
        q=st.q.double().cpu(), f=st.f.double().cpu(),
        energy=st.energy.double().cpu(), scalar_out=st.scalar_out.double().cpu())


def _steps_from(eng, st, n):
    for _ in range(n):
        st = eng.step(st)
    return st


def noncontig_path(card, dev, results, il_file):
    """Phase 35: electrodes in any row order.  The mid-size cell under a
    seeded permutation that spreads its 1,152 electrode rows through the
    7,296 atoms: the main path (10 warm-up and 100 graphed steps, K4 with
    the fused correction and K5 every step, finite energy, neutral
    electrodes), a graph phase of 2 pairs (graphed and eager bit for bit),
    and 3 card steps mapped by tag onto the electrodes-first card run from
    the same positions within phase 5's bounds; then 3 steps of cond 4
    scrambled (PPPM z planes, K4, K5, K7, K8) against its electrodes-first
    run, with the fix scalar."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    tag = "phase 35"
    t0 = time.perf_counter()
    system, md, cfg = workloads.synthetic(**CELL)
    perm = np.random.default_rng(35).permutation(system.natoms)
    scr = reorder_atoms(system, perm)
    eng = _f32_engine(scr, md, cfg, dev)
    first = _f32_engine(system, md, cfg, dev)
    rows = np.asarray(eng.conp.ele_idx)
    print(f"{tag}: mid-size cell, {system.natoms} atoms, its {len(rows)} "
          f"electrode rows spread over rows {rows.min()}-{rows.max()} (seed "
          f"35), ele_contig {eng.conp.ele_contig}; set-up "
          f"{time.perf_counter() - t0:.2f} s")
    if eng.conp.ele_contig or not first.conp.ele_contig:
        raise AssertionError(f"{tag}: the permutation left the electrodes "
                             "first")
    x_near = workloads.near_wall_positions(system)
    counters = {"pair_forces": k4.launches, "b_realspace": k5.launches}
    _, _, _, launched = main_run(tag, eng, dict(x0=x_near[perm]), 10, 100,
                                 counters, eng.conp.ne, card)
    SURFACE_LAUNCHES["35 mid scrambled"] = launched
    graph_phase(f"{tag}b", "mid_scrambled", eng, dict(x0=x_near[perm]), card,
                pairs=2, steps=50)
    a = first.init_state(x0=x_near)
    b = eng.init_state(x0=x_near[perm])
    for i in range(4):
        if i:
            a, b = first.step(a), eng.step(b)
        agree(f"{tag}: step {i}, scrambled vs electrodes first (card)",
              _by_tag(b, perm), _cpu64(a), first.conp.ne)
    del eng, first, a, b
    # cond 4 scrambled: PPPM with the electrodes' z planes, SHAKE/RATTLE
    system, md, cfg = workloads.cond(4, data_path=il_file)
    perm = np.random.default_rng(36).permutation(system.natoms)
    eng = _f32_engine(reorder_atoms(system, perm), md, cfg, dev)
    first = _f32_engine(system, md, cfg, dev)
    if eng.conp.ele_contig or eng.conp.ele_zplanes is None:
        raise AssertionError(f"{tag}: cond 4 is not scrambled on z planes")
    a, b = first.init_state(), eng.init_state()
    before = _launch_counts()
    for i in range(4):
        if i:
            a, b = first.step(a), eng.step(b)
        agree(f"{tag}: cond 4 step {i}, scrambled vs electrodes first "
              "(card)", _by_tag(b, perm), _cpu64(a), first.conp.ne,
              scalar=True)
    moved = _moved(before)
    SURFACE_LAUNCHES["35 cond4 scrambled"] = moved
    print(f"{tag}: cond 4, 2 x 3 steps and 2 x init, launches {moved}")
    for name in ("pair_forces", "b_realspace", "shake_positions",
                 "rattle_velocities"):
        if moved.get(name, 0) < 6:
            raise AssertionError(f"{tag}: cond 4: {name} launched "
                                 f"{moved.get(name, 0)} times")
    del eng, first
    torch.cuda.empty_cache()


def _deck_dir(il_file) -> str:
    """A ``$CONP_REF_TESTS`` directory holding the il file as the decks'
    ``il_onelayer/data``; set in the environment."""
    import shutil
    ref = os.path.abspath(os.path.join(OUT_DIR, "ref_tests"))
    os.makedirs(os.path.join(ref, "il_onelayer"), exist_ok=True)
    shutil.copyfile(il_file, os.path.join(ref, "il_onelayer", "data"))
    os.environ["CONP_REF_TESTS"] = ref
    return ref


def _cli(argv):
    """(stdout, seconds) of ``cli.main(argv)`` in this process."""
    import contextlib
    import io
    from lammps_user_conp2_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: exit code {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def cli_path(card, dev, results, il_file, tmp):
    """Phases 36 and 37: the command line in this process.  36: ``run
    il_onelayer 0 --f32 --steps 200 --thermo 20 --log --checkpoint`` on the
    3,776-atom file under $CONP_REF_TESTS: the log's header, 11 thermo
    rows, the Loop time line and the per-phase timing lines; K4, K5, K7
    and K8 every step; the rows equal, as printed, those of an
    ``Engine.run`` of the same deck.  37: ``run --steps 60 --thermo 20
    --dump``, then ``rerun``: K5 once per frame, each frame's electrode
    charges re-solved to RERUN_TOL of the dumped ones."""
    from lammps_user_conp2_tpu_torch import cli
    from lammps_user_conp2_tpu_torch.utils import dump
    from lammps_user_conp2_tpu_torch.utils.lammps_log import \
        parse_thermo_blocks
    tag = "phase 36"
    ref = _deck_dir(il_file)
    log = os.path.join(OUT_DIR, "cli_il_onelayer_0.log")
    ck = os.path.join(tmp, "cli_il.npz")
    before = _launch_counts()
    out, secs = _cli(["run", "il_onelayer", "0", "--f32", "--steps", "200",
                      "--thermo", "20", "--log", log, "--checkpoint", ck])
    moved = _moved(before)
    SURFACE_LAUNCHES["36 cli run"] = moved
    lines = open(log).read().splitlines()
    rows = [ln for ln in lines if ln and ln[0].isdigit()]
    notes = [ln for ln in lines if ln.startswith("#")]
    print(f"{tag}: cli run il_onelayer 0 --f32 (CONP_REF_TESTS={ref}): "
          f"{out.strip()}; {secs:.1f} s with set-up, the timing flush and "
          f"the checkpoint; launches {moved}  [{card}]")
    for ln in notes:
        print(f"    {ln}")
    if lines[0] != cli.THERMO_HEADER or len(rows) != 11:
        raise AssertionError(f"{tag}: the log has {len(rows)} thermo rows")
    for key in ("# Loop time", "# b_vector:", "# charge_solve:",
                "# pair_forces:", "# kspace_forces:", "# full_step:"):
        if not any(ln.startswith(key) for ln in notes):
            raise AssertionError(f"{tag}: the log has no '{key}' line")
    for name in ("pair_forces", "b_realspace", "shake_positions",
                 "rattle_velocities"):
        if moved.get(name, 0) < 200:
            raise AssertionError(f"{tag}: {name} launched "
                                 f"{moved.get(name, 0)} times in 200 steps")
    system, md, cfg = cli.load_deck("il_onelayer", 0)
    eng = _f32_engine(system, md, cfg, dev)
    st0 = eng.init_state()
    _, th = eng.run(st0, 200, thermo_every=20)
    want = [cli.thermo_line(eng.thermo(st0))] + [cli.thermo_line(r) for r in
                                                 cli.thermo_rows(th)]
    if rows != want:
        bad = [(a, b) for a, b in zip(rows, want) if a != b]
        raise AssertionError(f"{tag}: the log's rows differ from "
                             f"Engine.run's: {bad[:2]}")
    print(f"{tag}: the log's 11 thermo rows equal Engine.run's as printed; "
          f"last: {rows[-1]}")

    tag = "phase 37"
    traj = os.path.join(tmp, "il.traj")
    log2 = os.path.join(OUT_DIR, "cli_il_onelayer_0_dump.log")
    _, secs = _cli(["run", "il_onelayer", "0", "--f32", "--steps", "60",
                    "--thermo", "20", "--dump", traj, "--log", log2,
                    "--no-timing"])
    before = _launch_counts()
    out, rsecs = _cli(["rerun", "il_onelayer", "0", traj, "--f32"])
    moved = _moved(before)
    SURFACE_LAUNCHES["37 cli rerun"] = moved
    logged = parse_thermo_blocks(log2)[0]
    got = np.array([[float(v) for v in ln.split()]
                    for ln in out.splitlines()[1:]])
    print(f"{tag}: run --dump 60 steps {secs:.1f} s, rerun of "
          f"{len(got)} frames {rsecs:.1f} s; launches in the rerun {moved}")
    if moved.get("b_realspace", 0) != 3 or got.shape[0] != 3:
        raise AssertionError(f"{tag}: K5 launched {moved} for 3 frames")
    dql = np.abs(got[:, 1] - logged["c_qleft"][1:]).max()
    frames = dump.read_dump(traj)
    res = dump.rerun_charges(eng.conp, frames, system.q0, tags=system.tag)
    gap = 0.0
    for (_, ftags, cols), (_, qn, _) in zip(frames, res):
        pos = np.searchsorted(ftags, system.tag)
        gap = max(gap, float(np.abs(qn[system.ele_mask]
                                    - cols["q"][pos][system.ele_mask]).max()))
    print(f"{tag}: re-solved electrode charges vs dumped: max {gap:.3e} e "
          f"per atom (bound {RERUN_TOL}), |dqleft| {dql:.3e} e against the "
          f"log  [{card}]")
    if not gap <= RERUN_TOL:
        raise AssertionError(f"{tag}: rerun charges off by {gap:.3e} e")
    del eng
    torch.cuda.empty_cache()


def checkpoint_path(card, dev, results, il_file, tmp):
    """Phase 38: at the il and 100k cells, 50 graphed steps, a checkpoint,
    a fresh engine, the file loaded and 50 more graphed steps against an
    uninterrupted 100-step run: x, v, q, pe and the thermo rows bit for
    bit; a checkpoint loaded into the il cell scrambled, and the il
    checkpoint into the 100k engine, raise.  Returns the il and 100k
    engines and the 100k cell's near-wall positions."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell
    from lammps_user_conp2_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    tag = "phase 38"
    engines = {}
    for cell in ("il", "100k"):
        if cell == "il":
            system, md, cfg = workloads.il_onelayer(0, data_path=il_file)
            kw = {}
        else:
            system, md, cfg = large_cell()
            kw = dict(x0=workloads.near_wall_positions(system))
        t0 = time.perf_counter()
        eng = _f32_engine(system, md, cfg, dev)
        st0 = eng.init_state(**kw)
        full, th_full = eng.run(st0, 100, thermo_every=10)
        half, _ = eng.run(st0, 50, thermo_every=10)
        path = os.path.join(tmp, f"ck_{cell}.npz")
        save_checkpoint(path, eng, half)
        size = os.path.getsize(path)
        fresh = _f32_engine(system, md, cfg, dev)
        before = _launch_counts()
        resumed = load_checkpoint(path, fresh)
        end, th_end = fresh.run(resumed, 50, thermo_every=10)
        torch.cuda.synchronize()
        moved = _moved(before)
        SURFACE_LAUNCHES[f"38 {cell} resumed"] = moved
        same = (_state_diff(end, full)[0]
                and torch.equal(end.step_t, full.step_t)
                and all(torch.equal(torch.as_tensor(th_end[k]).cpu(),
                                    torch.as_tensor(th_full[k])[5:].cpu())
                        for k in th_full))
        print(f"{tag}: {cell}, {system.natoms} atoms: 50 + checkpoint "
              f"({size / 2**20:.1f} MiB) + fresh engine + 50 graphed steps "
              f"vs 100: bit-identical {same} (x, v, q, pe, step counter, 5 "
              f"thermo rows); {time.perf_counter() - t0:.1f} s; launches "
              f"in the resumed run {moved}  [{card}]")
        if not same:
            raise AssertionError(f"{tag}: {cell}: the resumed run differs: "
                                 f"{_state_diff(end, full)}")
        engines[cell] = (eng, kw)
        del fresh, full, half, end, resumed
        torch.cuda.empty_cache()
        if cell == "il":
            il_path = path
            scrambled = _f32_engine(reorder_atoms(system, np.roll(np.arange(
                system.natoms), 5)), md, cfg, dev)
            try:
                load_checkpoint(path, scrambled)
            except ValueError as e:
                print(f"{tag}: il checkpoint into the scrambled il set-up "
                      f"raises: {e}")
            else:
                raise AssertionError(f"{tag}: loaded into the scrambled il")
            del scrambled
    try:
        load_checkpoint(il_path, engines["100k"][0])
    except ValueError as e:
        print(f"{tag}: il checkpoint into the 100k engine raises: {e}")
    else:
        raise AssertionError(f"{tag}: the il checkpoint loaded at 100k")
    return engines


def _timed(fn):
    """(result, seconds) of one call, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rel_max(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def diagnostics_path(card, dev, results, engines):
    """Phase 39: the diagnostics and the pressure at full width.  il cell:
    ``group_potential`` of each electrode after the solve (right minus left
    the applied 2 V to DV_TOL, the spread within an electrode below
    SPREAD_TOL), ``potential_atom`` and ``pressure_tensor`` in float32 on
    the card against float64 on the CPU (the same state).  100k cell
    (PPPM): ``pressure_tensor`` and the left electrode's potential in
    float32 (K2b launches in both) against float64 on the card.  Both
    within DIAG_REL of the largest |value|; the times printed."""
    import types
    from lammps_user_conp2_tpu_torch.models import diagnostics as dg
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.models.pressure import pressure_tensor
    tag = "phase 39"
    times = {}
    for cell in ("il", "100k"):
        eng, kw = engines[cell]
        system = eng.system
        st = eng.init_state(**kw)
        pkw = dg.engine_potential_kw(eng)
        before = _launch_counts()
        ele = eng.left_mask | eng.right_mask
        group = (torch.ones_like(eng.left_mask) if cell == "il"
                 else eng.left_mask)
        pot, t_pot = _timed(lambda: dg.potential_atom(
            st.x, st.q, group_mask=group, **pkw))
        p32, t_p = _timed(lambda: pressure_tensor(eng, st))
        moved = _moved(before)
        SURFACE_LAUNCHES[f"39 {cell}"] = moved
        times[cell] = dict(potential_atom_s=t_pot, pressure_tensor_s=t_p)
        gl = float(dg.group_potential(st.x, st.q, eng.left_mask, **pkw))
        gr = float(dg.group_potential(st.x, st.q, eng.right_mask, **pkw))
        print(f"{tag}: {cell}, {system.natoms} atoms, float32: "
              f"potential_atom over {int(group.sum())} atoms {t_pot:.3f} s, "
              f"pressure_tensor {t_p:.3f} s (P = "
              f"{[round(float(v), 3) for v in p32]} atm); group potentials "
              f"left {gl:.6f} V, right {gr:.6f} V; launches {moved}  [{card}]")
        if cell == "il":
            target = eng.conp.cfg.target
            sl = float(pot[eng.left_mask].std())
            sr = float(pot[eng.right_mask].std())
            print(f"{tag}: il: right - left {gr - gl:.6f} V (applied "
                  f"{target} V, bound {DV_TOL}), spread within the left / "
                  f"right electrode {sl:.3e} / {sr:.3e} V (bound "
                  f"{SPREAD_TOL})")
            if not (abs(gr - gl - target) <= DV_TOL and sl <= SPREAD_TOL
                    and sr <= SPREAD_TOL):
                raise AssertionError(f"{tag}: il: the electrodes are not the "
                                     "applied equipotentials")
            # float64 on the CPU, the same state
            md, cfg = eng.md, eng.conp.cfg
            conp64 = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                                device="cpu")
            eng64 = build_engine(system, md, conp64, dtype=torch.float64,
                                 device="cpu")
            where = "the CPU"
        else:
            if moved.get("spread_tiles", 0) < 2:
                raise AssertionError(f"{tag}: 100k: K2b launched {moved}")
            conp64 = setup_conp(system, eng.md, eng.conp.cfg,
                                solve_dtype=torch.float64, device=dev)
            eng64 = build_engine(system, eng.md, conp64, dtype=torch.float64,
                                 device=dev)
            where = "the card"
        d64 = eng64.type_idx.device
        st64 = types.SimpleNamespace(
            x=st.x.to(d64, torch.float64), q=st.q.to(d64, torch.float64),
            v=st.v.to(d64, torch.float64))
        pot64, t_pot64 = _timed(lambda: dg.potential_atom(
            st64.x, st64.q, group_mask=group.to(d64),
            **dg.engine_potential_kw(eng64)))
        p64, t_p64 = _timed(lambda: pressure_tensor(eng64, st64))
        dpot, dp = _rel_max(pot, pot64), _rel_max(p32, p64)
        times[cell].update(potential_atom_f64_s=t_pot64,
                           pressure_tensor_f64_s=t_p64, pot_rel=dpot,
                           p_rel=dp)
        print(f"{tag}: {cell}: float32 against float64 on {where}: "
              f"potential_atom {dpot:.3e}, pressure_tensor {dp:.3e} of the "
              f"largest (bound {DIAG_REL}); float64 {t_pot64:.3f} s and "
              f"{t_p64:.3f} s  [{card}]")
        if not (dpot <= DIAG_REL and dp <= DIAG_REL):
            raise AssertionError(f"{tag}: {cell}: float32 off float64")
        del eng64, conp64, st64, pot64
        torch.cuda.empty_cache()
    results["surface"] = dict(diagnostics=times)


def matio_profile_path(card, dev, results, engines):
    """Phase 40: matrix files and ``profile``.  The mid-size cell set up
    with ``matout`` (``amatrix``, ``inv_a_matrix`` into a temporary working
    directory), then with ``ainv_file`` on the written inverse: A^-1
    equal to MATFILE_TOL, and 3 steps of both within phase 5's bounds.
    ``cli profile il_onelayer 0 --f32``: each phase's time (CUDA events)
    and the kernels it launched (K5 in b_vector and charge_solve, K4 in
    pair_forces, K4, K5, K7 and K8 in full_step); ``timers.profile_step``
    at the 100k cell: K1 in pair_forces, K2a in pppm_spread, K3 in
    pppm_gather."""
    import dataclasses
    import tempfile
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.utils.timers import profile_step
    tag = "phase 40"
    system, md, cfg = workloads.synthetic(**CELL)
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            eng = _f32_engine(system, md, dataclasses.replace(
                cfg, matout=True), dev)
            t_write = time.perf_counter() - t0
        finally:
            os.chdir(here)
        sizes = {f: os.path.getsize(os.path.join(d, f))
                 for f in ("amatrix", "inv_a_matrix")}
        t0 = time.perf_counter()
        eng_f = _f32_engine(system, md, dataclasses.replace(
            cfg, ainv_file=os.path.join(d, "inv_a_matrix")), dev)
        t_read = time.perf_counter() - t0
    gap = float((eng.conp.ainv - eng_f.conp.ainv).abs().max())
    print(f"{tag}: mid-size matout set-up {t_write:.2f} s (files {sizes} "
          f"bytes), ainv_file set-up {t_read:.2f} s; max|A^-1 file - "
          f"memory| {gap:.3e} (bound {MATFILE_TOL})")
    if not gap <= MATFILE_TOL:
        raise AssertionError(f"{tag}: A^-1 from the file off by {gap:.3e}")
    x_near = workloads.near_wall_positions(system)
    a, b = eng.init_state(x0=x_near), eng_f.init_state(x0=x_near)
    for i in range(4):
        if i:
            a, b = eng.step(a), eng_f.step(b)
        agree(f"{tag}: step {i}, ainv_file vs in memory (card)", b, _cpu64(a),
              eng.conp.ne)
    del eng, eng_f, a, b
    torch.cuda.empty_cache()

    out, secs = _cli(["profile", "il_onelayer", "0", "--f32", "--iters",
                      "10"])
    cut = out.index("launches ")
    prof = {k: float(v.split()[0]) for k, v in json.loads(out[:cut]).items()}
    launched = json.loads(out[cut + len("launches "):])
    il_need = {"b_vector": ("b_realspace",), "charge_solve": ("b_realspace",),
               "pair_forces": ("pair_forces",),
               "full_step": ("pair_forces", "b_realspace", "shake_positions",
                             "rattle_velocities")}
    eng100, kw = engines["100k"]
    st = eng100.init_state(**kw)
    launched100 = {}
    prof100 = {k: v * 1e3 for k, v in profile_step(
        eng100, st, iters=10, launches=launched100).items()}
    big_need = {"pair_forces": ("block_pair",), "pppm_spread": ("spread_mesh",),
                "pppm_gather": ("gather3",),
                "full_step": ("block_pair", "spread_mesh", "gather3")}
    for cell, p, lau, need in (("il", prof, launched, il_need),
                               ("100k", prof100, launched100, big_need)):
        print(f"{tag}: profile at the {cell} cell (ms per call, CUDA events; "
              f"kernels launched per phase)  [{card}]")
        for phase, ms in p.items():
            print(f"    {phase:14s} {ms:10.4f} ms  {lau.get(phase, {})}")
        for phase, names in need.items():
            for name in names:
                if not lau.get(phase, {}).get(name):
                    raise AssertionError(f"{tag}: {cell}: {phase} did not "
                                         f"launch {name}")
        SURFACE_LAUNCHES[f"40 profile {cell}"] = {
            phase: lau[phase] for phase in lau if lau[phase]}
    results["surface"].update(profile_il_ms=prof, profile_100k_ms=prof100,
                              cli_profile_s=secs)


def surface_paths(card, dev, results, il_file):
    """Phases 35-40: the user's surface (electrodes in any row order, the
    command line, dump and rerun, checkpoints, the diagnostics and the
    pressure, the matrix files and the per-phase profile)."""
    import tempfile
    t0 = time.perf_counter()
    noncontig_path(card, dev, results, il_file)
    with tempfile.TemporaryDirectory() as tmp:
        cli_path(card, dev, results, il_file, tmp)
        engines = checkpoint_path(card, dev, results, il_file, tmp)
    diagnostics_path(card, dev, results, engines)
    matio_profile_path(card, dev, results, engines)
    del engines
    torch.cuda.empty_cache()
    results["surface"]["seconds"] = time.perf_counter() - t0
    print(f"phases 35-40: {time.perf_counter() - t0:.1f} s; launches by "
          f"phase {json.dumps(SURFACE_LAUNCHES)}  [{card}]")


# phases 41-43: the sharded step (``parallel/sharded.py``)
SHARDED_DS = (2, 4)
SHARDED_STEPS = 3
BENCH_SHARDED_STEPS = 20
BENCH_SHARDED_PAIRS = 2
# kernels line name -> the phase 42 cells' launches / phase 41's per-rank
# device-clock times, by d
SHARDED_LAUNCHES = {}
RANK_MS = {}


def _host64(st):
    """A card state's q, f, pe and fix scalar in float64 on the host, the
    shape ``agree`` reads its reference in."""
    import types
    return types.SimpleNamespace(
        q=st.q.double().cpu(), f=st.f.double().cpu(),
        energy=st.energy.double().cpu(), scalar_out=st.scalar_out.double()
        .cpu())


def rank_slices(card, dev, eng, x_np):
    """Phase 41: K1, K2a and K3 on each rank's share of the 100k cell at d
    in SHARDED_DS, one rank after another in one process (no collectives):
    each against its plain version; the ranks' slot forces put together
    against the whole list's K1 output (bit for bit printed, KERNEL_TOL
    held); the ranks' rhok summed against the whole spread."""
    from lammps_user_conp2_tpu_torch.ops import neighbors, pppm
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.parallel.sharded import make_layout
    tag = "phase 41"
    system, conp = eng.system, eng.conp
    n = system.natoms
    rng = np.random.default_rng(1)
    q_np = system.q0.copy()
    q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    bkw = dict(box=eng.ncfg.grid.box, periodic=eng.ncfg.grid.periodic,
               cutoff=eng.md.cutoff, g_ewald=conp.ksp.g_ewald,
               qqr2e=system.units().qqr2e)
    nbr, _ = eng.derived_state(x)
    grid = eng.pppm_grid
    whole = k1.block_pair(x, q, eng.type_idx, nbr.bun, nbr.brows, eng.tables,
                          conp_fuse=fuse, **bkw)
    rhok_w = pppm._spread_rhok_tiled(grid, x, q_elyte,
                                     pppm.tile_slots(grid, x, q_elyte))
    cfd = pppm._coeffs(grid, torch.float32, dev)
    for d in SHARDED_DS:
        lay = make_layout(eng, d, x0=x_np)
        rg = lay.rank_grid
        geom = pppm._tile_geometry(rg, lay.nrow)
        nbp = neighbors.pad_block_list(nbr, n, d)
        nb_l = nbp.bun.shape[0] // d
        print(f"{tag}: d={d}: {lay.nrow} atom rows and {nb_l} blocks per "
              f"rank, rank tile cap {geom.cap} (the grid's "
              f"{pppm._tile_geometry(grid, n).cap})")
        f_parts, rhok, ms = [], 0.0, {"block_pair_conp": [],
                                      "spread_mesh": [], "gather3": []}
        for r in range(d):
            sl = slice(r * nb_l, (r + 1) * nb_l)
            args = (x, q, eng.type_idx, nbp.bun[sl], nbp.brows[sl],
                    eng.tables)
            kern = lambda: k1.block_pair(*args, conp_fuse=fuse, **bkw)
            got = kern()
            torch.cuda.synchronize()
            compare(f"{tag}: d={d} rank {r} block_pair", got,
                    k1.block_pair_plain(*args, conp_fuse=fuse, **bkw))
            f_parts.append(got[0])
            ms["block_pair_conp"].append(median_ms(kern, reps=10))
            xi = lay.my_rows(x, r)
            qi = lay.my_rows(q_elyte, r, 0.0)
            slots = pppm.refresh_tile_slots(rg, pppm.tile_assign(rg, xi), xi,
                                            qi)
            if bool(slots.overflow):
                raise AssertionError(f"{tag}: d={d} rank {r}: tile overflow")
            kern = lambda: k2.spread_mesh(slots.rows, cfd, geom)
            got = kern()
            torch.cuda.synchronize()
            compare(f"{tag}: d={d} rank {r} spread_mesh", (got,),
                    (k2.spread_mesh_plain(slots.rows, cfd, geom),))
            ms["spread_mesh"].append(median_ms(kern, reps=10))
            rhok = rhok + pppm._spread_rhok_tiled(rg, xi, qi, slots)
            _, uz = pppm.pppm_energy_u_zbin(rg, rhok_w, lay.nrow)
            up = pppm._wrap_pad_xy(uz, geom.hw + geom.dm).contiguous()
            kern = lambda: k3.gather3(up, slots.rows, cfd, geom)
            got = kern()
            torch.cuda.synchronize()
            compare(f"{tag}: d={d} rank {r} gather3", (got,),
                    (k3.gather3_plain(up, slots.rows, cfd, geom),))
            ms["gather3"].append(median_ms(kern, reps=10))
        f_all = torch.cat(f_parts)[:nbr.brows.numel()]
        print(f"{tag}: d={d}: the ranks' slot forces put together equal the "
              f"whole list's K1 output bit for bit: "
              f"{torch.equal(f_all, whole[0])}")
        compare(f"{tag}: d={d} slot forces put together", (f_all,),
                (whole[0],))
        compare(f"{tag}: d={d} rhok of the ranks summed",
                (torch.view_as_real(rhok),), (torch.view_as_real(rhok_w),))
        for name, v in ms.items():
            RANK_MS.setdefault(name, {})[f"d{d}"] = v
        print(f"{tag}: d={d}: ms per rank (CUDA events) " + json.dumps(ms)
              + f"  [{card}]")


def sharded_cell(tag, cell, eng, x0, comm, counters, card, scalar=False):
    """Phase 42 at one cell: SHARDED_STEPS d = 1 sharded steps from
    ``eng.init_state``, twice (bit for bit), each kernel in ``counters``
    launched every step of the first run; then ``Engine.step`` on the card
    from the same state, every step held to phase 5's bounds.  Returns the
    sharded engine and the start state."""
    from lammps_user_conp2_tpu_torch.parallel.sharded import (
        build_sharded_engine)
    t0 = time.perf_counter()
    sheng = build_sharded_engine(
        eng, comm, x0=None if x0 is None else np.asarray(x0))
    st0 = eng.init_state(x0=x0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    runs = []
    for _ in range(2):
        st, states = st0, []
        for _ in range(SHARDED_STEPS):
            st = sheng.step(st)
            states.append(st)
        torch.cuda.synchronize()
        if not runs:
            launches = {name: c.count for name, c in counters.items()}
        runs.append(states)
    same = all(_state_diff(a, b)[0] for a, b in zip(*runs))
    print(f"{tag}: {cell}: {SHARDED_STEPS} sharded steps over a one-rank "
          f"NCCL group, launches {launches}; two runs bit-identical: {same}")
    if not same:
        raise AssertionError(f"{tag}: {cell}: the sharded step is not "
                             "bit-reproducible")
    for name, cnt in launches.items():
        if cnt < SHARDED_STEPS:
            raise AssertionError(f"{tag}: {cell}: {name} launched {cnt} "
                                 f"times in {SHARDED_STEPS} sharded steps")
        SHARDED_LAUNCHES.setdefault(name, {})[cell] = cnt
    st = st0
    for i, s_sh in enumerate(runs[0]):
        st = eng.step(st)
        agree(f"{tag}: {cell} step {i + 1}, sharded vs Engine.step", s_sh,
              _host64(st), eng.conp.ne, scalar)
    print(f"{tag}: {cell}: {time.perf_counter() - t0:.1f} s  [{card}]")
    return sheng, st0


def sharded_paths(card, dev, results, il_file):
    """Phases 41-43: the sharded step on one card."""
    import dataclasses
    import tempfile
    from lammps_user_conp2_tpu_torch import bench_sharded, workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    from lammps_user_conp2_tpu_torch.ops.kernels import block_pair as k1
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k56
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
    from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2
    from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
    from lammps_user_conp2_tpu_torch.parallel import comm as C
    from lammps_user_conp2_tpu_torch.parallel.sharded import (
        build_sharded_engine)
    from lammps_user_conp2_tpu_torch.step_breakdown_large import large_cell
    from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
    t0 = time.perf_counter()
    system, md, cfg = large_cell()
    x_near = workloads.near_wall_positions(system)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=dev)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
    # ---- phase 41: per-rank kernel slices
    rank_slices(card, dev, eng, x_near)
    # ---- phase 42: the d = 1 sharded step over NCCL, three cells
    store = os.path.join(tempfile.mkdtemp(), "store")
    comm = C.init_group(dev, 0, 1, store)
    try:
        big = dict(block_pair=k1.launches, spread_mesh=k2.launches,
                   gather3=k3.launches)
        sheng, st0 = sharded_cell("phase 42", "100k", eng, x_near, comm, big,
                                  card)
        # ---- phase 43: bench_sharded at the 100k and mid-size cells
        bench = {"100k": bench_sharded.measure(
            eng, sheng, st0, BENCH_SHARDED_STEPS, BENCH_SHARDED_PAIRS)}
        del sheng, st0, eng, conp
        torch.cuda.empty_cache()
        fsys, fmd, fcfg = workloads.synthetic(98304, 40, lz=240.0, lxy=120.0)
        fmd = dataclasses.replace(fmd, kspace_style=KSpaceStyle.PPPM)
        fcfg = dataclasses.replace(fcfg, kspace=KSpaceStyle.PPPM,
                                   mobile_electrodes=True)
        feng = build_engine(fsys, fmd, setup_conp(
            fsys, fmd, fcfg, solve_dtype=torch.float32, device=dev),
            dtype=torch.float32, device=dev)
        sharded_cell("phase 42", "full_mesh", feng,
                     workloads.near_wall_positions(fsys), comm,
                     dict(big, spread_tiles=k2.tiles_launches), card)
        del feng
        torch.cuda.empty_cache()
        *_, ceng = _deck_engine("phase 42", "cond", 4, il_file, dev)
        sharded_cell("phase 42", "cond4", ceng, None, comm,
                     dict(shake_positions=k78.shake_launches,
                          rattle_velocities=k78.rattle_launches,
                          b_realspace=k56.launches,
                          conp_correction=k56.corr_launches), card,
                     scalar=True)
        meng, mx = bench_sharded.cell_engine("mid", dev)
        msh = build_sharded_engine(meng, comm, x0=mx)
        bench["mid"] = bench_sharded.measure(
            meng, msh, meng.init_state(x0=mx), BENCH_SHARDED_STEPS,
            BENCH_SHARDED_PAIRS)
    finally:
        C.close_group()
    for cell, r in bench.items():
        print(f"phase 43: cell={cell} single_ms={r['single_ms']:.4f} "
              f"sharded_d1_ms={r['sharded_d1_ms']:.4f} "
              f"overhead_pct={r['overhead_pct']:.1f} (eager, {r['steps']} "
              f"steps x {r['pairs']} alternating pairs: single "
              f"{r['single_runs_ms']}, sharded {r['sharded_runs_ms']}), host "
              f"syncs per step {r['host_syncs_per_step']}  [{card}]")
        for name, pr in r["profile"].items():
            step_ms = r["single_ms" if name == "single" else "sharded_d1_ms"]
            print(f"phase 43: cell={cell} {name}: device busy "
                  f"{pr['busy_ms']:.4f} ms/step ({pr['busy_ms'] / step_ms:.3f} "
                  f"of the step), {pr['kernels_per_step']:.0f} kernels/step, "
                  f"NCCL {pr['nccl_ms']:.4f} ms/step; top device kernels "
                  f"(ms/step, per step) {pr['top_device']}; top host ops "
                  f"(self ms/step, per step) {pr['top_host']}")
    results["sharded"] = dict(bench=bench, rank_ms=RANK_MS,
                              launches=SHARDED_LAUNCHES,
                              seconds=time.perf_counter() - t0)
    for name, per_d in RANK_MS.items():
        results[name]["ms_rank_slices"] = per_d
    names = {"block_pair": "block_pair_conp", "spread_mesh": "spread_mesh",
             "gather3": "gather3", "spread_tiles": "spread_tiles",
             "shake_positions": "shake_positions",
             "rattle_velocities": "rattle_velocities",
             "b_realspace": "b_realspace",
             "conp_correction": "conp_correction"}
    for counter, per_cell in SHARDED_LAUNCHES.items():
        results[names[counter]]["launches_sharded"] = per_cell
    print(f"phases 41-43: {time.perf_counter() - t0:.1f} s  [{card}]")


if __name__ == "__main__":
    sys.exit(main())
