"""The readings that set a cell's limits: the program's compared numbers
over many seeds, and the control's (the plain reference in TF32 in the
program's place) at the same samples, each seed a short window of the
cell's own chunks, all in one process; with ``--fault`` the program's
numbers with that fault planted (``perfbench/faults.py``) and no control.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,...
        [--chunks 4] [--fault <name>] [--out <file.jsonl>]

One JSON line per seed: the seed, the program's numbers, the control's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, in place of this script's own directory
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    if args.fault:
        faults.plant(args.fault)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, 0.0, False, t_start=t,
                             min_chunks=args.chunks,
                             control=not args.fault,
                             log=lambda m: print(m, file=sys.stderr))
        line = json.dumps(dict(workload=args.workload, seed=seed,
                               fault=args.fault, program=r["values"],
                               control=r.get("values_control"),
                               seconds=time.perf_counter() - t))
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
