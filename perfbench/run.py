"""The benchmark of ``lammps_user_conp2_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the run's log and, last on standard error, each number that
decides ``correct`` beside its limit; the last line of standard output is
the result as one JSON object.  Needs as many CUDA devices as the cell
asks for, and exits with 2 and no result without them.  The kernel
library builds into the package's ``_build/`` and the CUDA caches go to
``.perfbench_cache/`` in the checkout; the deck's data file is written
from the seed under ``TMPDIR`` and removed at the end.  The CPU libraries
run one thread.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"
for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CACHE / sub)
# one host thread for the CPU libraries: the step is host-bound by its
# graph launches at these decks, and with the libraries' default thread
# pools more runs fell into the host's slower speed (PERF.md, section 2)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# the checkout's root, in place of this script's own directory
sys.path[0] = str(ROOT)


def finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.nojax import jax_modules
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, log=log)
    found = jax_modules(sys.modules)
    if found:
        print(f"JAX was loaded in the run: {found}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out.pop("values")
    out["checks"] = {name: {"value": finite(v), "limit": lim}
                     for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"{name} {v:.6e} limit {lim:.6e}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
