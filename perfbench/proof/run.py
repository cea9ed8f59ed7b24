"""The reference's readings at the synthetic 100k state: the program's,
the TF32 control's and, where asked, those of the program in float64 and
of the reference's other k-space (the exact Ewald sum, the other
differentiation, the program's own mesh), each seed one run of the
harness (``harness.run_cell``) with the state written from the seed.

    python3 perfbench/proof/run.py --seeds 11,12,13,14,15 [--chunks 3]
        [--f64 11] [--variants 11] [--out <file.jsonl>]

Not a cell of the benchmark: it proves on the card that one run can judge
the state (``synthetic.json``: 99,362 atoms, PPPM 1e-4 on the block list
and the tiled mesh).  One JSON line per run: the seed, the run's kind,
its readings and the control's, the reference's seconds and peak device
memory (from the harness's log), and the program's list and mesh sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
# the checkout's root, in place of this script's own directory
sys.path[0] = str(ROOT)


def load(name="synthetic"):
    """(config, traffic) of the state."""
    return (json.loads((HERE / f"{name}.json").read_text()),
            json.loads((HERE / "trial.json").read_text()))


@contextlib.contextmanager
def on_state(config):
    """The harness writes the state's file (``state.write_data``) and the
    program reads it (``state.program_deck`` in place of ``cli.load_deck``)
    while this holds."""
    from lammps_user_conp2_tpu_torch import cli

    from perfbench import harness
    from perfbench.proof import state
    args = config["state"]

    def write(cfg, seed, directory):
        return state.write_data(Path(directory) / cfg["deck"]["name"]
                                / "data", seed, **args)

    def deck(workload, trial):
        from lammps_user_conp2_tpu_torch import workloads
        return state.program_deck(Path(workloads.ref_tests()) / workload
                                  / "data", **args)

    old = harness.write_data, cli.load_deck
    harness.write_data, cli.load_deck = write, deck
    try:
        yield
    finally:
        harness.write_data, cli.load_deck = old


def sizes_seen(box):
    """Wraps ``harness.program_sizes`` to keep what it read in ``box``."""
    from perfbench import harness
    inner = harness.program_sizes

    def wrapped(eng, st):
        box.update(inner(eng, st))
        return dict(box)
    return wrapped


def prove(config, traffic, seed, *, device=None, dtype=None, control=True,
          min_chunks=3, log=print) -> dict:
    """One harness run at the state: readings, the control's, the log's
    reference seconds and memory."""
    import torch

    from perfbench import harness
    lines = []

    def keep(msg):
        lines.append(msg)
        log(msg)

    cell = dict(name="synthetic", chips=1, config=config, traffic=traffic,
                limits={}, end_to_end=[], per_layer=[])
    t = time.perf_counter()
    with on_state(config):
        out = harness.run_cell(cell, seed, 0.0, False, device=device,
                               dtype=dtype or torch.float32, t_start=t,
                               min_chunks=min_chunks, control=control,
                               log=keep)
    ref = next(m for m in lines if m.startswith("reference:"))
    num = lambda pat, text: float(re.search(pat, text).group(1))
    res = dict(seed=seed, program=out["values"],
               control=out.get("values_control"),
               reference_s=num(r"in ([0-9.]+) s", ref),
               reference_peak_bytes=int(num(r"peak (\d+) B", ref)),
               program_peak_bytes=out["device"]["memory_peak_bytes"],
               steps=out["attempted"] * int(traffic["chunk_steps"]),
               seconds=time.perf_counter() - t)
    ctl = [m for m in lines if m.startswith("control:")]
    if ctl:
        res.update(control_s=num(r"control: ([0-9.]+) s", ctl[0]),
                   control_peak_bytes=int(num(r"peak with the reference's "
                                              r"(\d+) B", ctl[0])))
    return res


def variants(config):
    """[(kind, config)] of the reference's other k-space: the exact Ewald
    sum, the other differentiation."""
    ewald = copy.deepcopy(config)
    del ewald["deck"]["pppm_diff"]
    other = copy.deepcopy(config)
    other["deck"]["pppm_diff"] = {"ik": "ad", "ad": "ik"}[
        config["deck"]["pppm_diff"]]
    return [("ewald", ewald),
            (f"mesh_{other['deck']['pppm_diff']}", other)]


@contextlib.contextmanager
def program_mesh(dims):
    """The reference's mesh at ``dims`` in place of its rule's."""
    from perfbench.reference import conp_md
    old = conp_md.slab_mesh
    conp_md.slab_mesh = lambda *_: tuple(dims)
    try:
        yield
    finally:
        conp_md.slab_mesh = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--f64", default="", help="seeds of the float64 program")
    ap.add_argument("--variants", default="",
                    help="seeds of the reference's other k-space")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = load()
    out = open(args.out, "a") if args.out else None
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    log = lambda m: print(m, file=sys.stderr, flush=True)
    sizes = {}
    harness.program_sizes = sizes_seen(sizes)
    runs = [(s, "mesh", config, torch.float32, True)
            for s in seeds(args.seeds)]
    runs += [(s, "program_f64", config, torch.float64, False)
             for s in seeds(args.f64)]
    for s in seeds(args.variants):
        runs += [(s, kind, cfg, torch.float32, True)
                 for kind, cfg in variants(config)]
        runs.append((s, "program_mesh", config, torch.float32, True))
    for seed, kind, cfg, dtype, control in runs:
        ctx = (program_mesh(sizes["mesh"]) if kind == "program_mesh"
               else contextlib.nullcontext())
        with ctx:
            res = prove(cfg, traffic, seed, dtype=dtype, control=control,
                        min_chunks=args.chunks, log=log)
        line = json.dumps(dict(res, kind=kind, sizes=sizes))
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
