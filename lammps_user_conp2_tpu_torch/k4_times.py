"""K4's z-order entry (``pair_forces`` with ``zsort``) at the mid-size and
100k cells, for this checkout or another one.

    python3 lammps_user_conp2_tpu_torch/k4_times.py [--root DIR] [--out FILE]

Imports ``lammps_user_conp2_tpu_torch`` from the checkout at DIR (default:
the one this file is in), so that two trees' K4 can be held side by side on
one card: ``--root`` an unpacked parent commit, then this tree, then the
parent again.  It reaches the kernel only through ``workloads``,
``models.conp.setup_conp``, ``models.md.build_engine``,
``ops.kernels.zorder.z_perm`` and ``ops.kernels.pair_kernel`` (``pair_forces``
with the fused CONP correction, ``sweep_ctas``), as every tree since the
kernel's redesign has them.  Per cell (the synthetic capacitor of
``chip_smoke.CELL``, and the 99,362-atom cell of
``step_breakdown_large.large_cell``, at ``near_wall_positions`` with seeded
electrode charges): the persistent sweep's CTA count, a SHA-256 of the
output bytes (f, evdwl, ecoul, ecorr; equal digests mean the same bits), ms
per call between two CUDA events (median of 20 single calls) and device ms
per call from torch.profiler (the median record of each of its kernels over
20 calls).  Prints the card's name and power limit and one JSON line
{"k4_times": ...}; ``--out`` also writes it to FILE.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPS = 20
# the mid-size cell (chip_smoke.CELL)
MID = dict(n_elyte=6144, nele_side=24, lz=60.0, lxy=50.0)
PARTS = ("pair_schedule", "pair_sweep", "pair_reduce")


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


def profiled_ms(fn, reps=REPS):
    """Device ms per call: per kernel of PARTS, the median record times its
    records per call, summed; None when the trace keeps no record."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rec = {p: [] for p in PARTS}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            for p in PARTS:
                if p in e.name and not e.name.startswith(p + "_items"):
                    rec[p].append(e.time_range.elapsed_us() / 1e3)
    if not any(rec.values()):
        return None
    return sum(float(np.median(t)) * max(1, round(len(t) / reps))
               for t in rec.values() if t)


def measure(pkg, dev) -> dict:
    """The numbers above for the mid-size and 100k cells."""
    import importlib
    wl = importlib.import_module(pkg + ".workloads")
    setup_conp = importlib.import_module(pkg + ".models.conp").setup_conp
    build_engine = importlib.import_module(pkg + ".models.md").build_engine
    k4 = importlib.import_module(pkg + ".ops.kernels.pair_kernel")
    z_perm = importlib.import_module(pkg + ".ops.kernels.zorder").z_perm
    large_cell = importlib.import_module(
        pkg + ".step_breakdown_large").large_cell
    out = {}
    for cell, (system, md, cfg) in (("mid", wl.synthetic(**MID)),
                                    ("100k", large_cell())):
        conp = setup_conp(system, md, cfg, solve_dtype=torch.float32,
                          device=dev)
        eng = build_engine(system, md, conp, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(1)
        q_np = system.q0.copy()
        q_np[system.ele_mask] = 0.05 * rng.standard_normal(conp.ne)
        x = torch.as_tensor(wl.near_wall_positions(system),
                            dtype=torch.float32, device=dev)
        q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
        zsort = z_perm(x, system.box, system.periodic)
        fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
        kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
                  g_ewald=eng.ksp_force.g_ewald, qqr2e=system.units().qqr2e,
                  zsort=zsort, conp_fuse=fuse)
        fn = lambda: k4.pair_forces(x, q, eng.type_idx, eng.tables, None,
                                    **kw)
        got = fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in got:
            h.update(t.detach().cpu().numpy().tobytes())
        nt = -(-system.natoms // k4.TILE)
        out[cell] = dict(natoms=system.natoms,
                         ctas=k4.sweep_ctas(True, 0, nt * (nt + 1) // 2),
                         sha256=h.hexdigest(), ms=event_ms(fn),
                         device_ms=profiled_ms(fn))
        del eng, conp, got
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_times: no CUDA device visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    pkg = "lammps_user_conp2_tpu_torch"
    mod = __import__(pkg)
    if not os.path.abspath(mod.__file__).startswith(root + os.sep):
        raise RuntimeError(f"k4_times: {pkg} came from {mod.__file__}, "
                           f"not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    line = json.dumps({"k4_times": dict(root=root, card=card,
                                        cells=measure(pkg, torch.device(
                                            "cuda:0")))})
    print(card)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
