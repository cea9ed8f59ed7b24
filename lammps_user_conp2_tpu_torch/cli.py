"""Command-line deck runner: ``python -m lammps_user_conp2_tpu_torch ...``.

The JAX package's CLI on the port, with its flags and their meanings:

  run        run a deck's trial, print LAMMPS-style thermo, write a log
             (and a trajectory dump and a checkpoint when asked)
  run-suite  run a deck's equivalent trials and compare their charges
  rerun      re-solve the electrode charges of a dumped trajectory
  compare    overlay a column of two or more logs (numerically)
  profile    per-phase timing of the step on the engine's path, and on
             the card the graphed step's layers and step loop under the
             tracer (``utils/timers.step_loop``)

The decks (``dilute``, ``il_onelayer``, ``il_twolayer``, ``cond``,
``zmirror``, every trial, and ``synthetic``) read their data under
``$CONP_REF_TESTS`` (``workloads.ref_tests``; ``workloads.
write_dilute_data`` and ``write_il_data`` write files they read).
Everything runs on the card unless ``--cpu`` is given, and raises without
one; ``--f32`` is the float32 step path that launches the hand kernels,
the default float64 (the plain versions on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .utils import timers

# the log's columns, as the reference's thermo_style custom
# (tests/cond/input:74) plus PotEng
THERMO_HEADER = "Step Temp c_tempsl c_qleft c_qright c_dipole f_e PotEng"
THERMO_COLS = ("step", "temp", "tempsl", "qleft", "qright", "dipole", "f_e",
               "pe")


@timers.span("setup.deck")
def load_deck(workload: str, trial: int):
    """(system, md, cfg) of a deck's trial; ``synthetic`` takes the trial as
    its electrolyte count (0: its default)."""
    from . import workloads
    if workload == "synthetic":
        return workloads.synthetic(**({"n_elyte": trial} if trial else {}))
    return getattr(workloads, workload)(trial)


def build(args):
    """(system, engine) of the command's deck, solver and pair path."""
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .utils.config import Solver
    from .utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    system, md, cfg = load_deck(args.workload, args.trial)
    if args.solver:
        cfg = dataclasses.replace(cfg, solver=Solver(args.solver))
    if args.pair_path:
        md = dataclasses.replace(md, pair_path=args.pair_path)
    if args.kmax:
        md = dataclasses.replace(md, neighbor_kmax=args.kmax)
    dtype = torch.float32 if args.f32 else torch.float64
    solver = setup_conp(system, md, cfg, solve_dtype=dtype, device=device)
    return system, build_engine(system, md, solver, dtype=dtype,
                                device=device)


def thermo_line(row: dict) -> str:
    return " ".join(f"{float(row[c]):.8g}" for c in THERMO_COLS)


def thermo_rows(th: dict) -> list:
    """The rows of ``Engine.run``'s thermo dict, one dict per row; each
    column but the host's ``step`` is a host read (``timers.host_read``)."""
    timers.host_read("thermo_rows", sum(torch.is_tensor(v) for k, v in
                                        th.items() if k != "step"))
    th = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
          for k, v in th.items()}
    return [{k: v[i] for k, v in th.items()} for i in range(len(th["step"]))]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_run(args):
    from .utils import dump as dumpio
    system, eng = build(args)
    dev = eng.type_idx.device
    st = eng.init_state()
    out = open(args.log, "w") if args.log else sys.stdout
    try:
        print(THERMO_HEADER, file=out)
        print(thermo_line(eng.thermo(st)), file=out)
        nchunk = args.thermo
        if not args.dump:
            # the whole run as one Engine.run (the CUDA-graph replay on the
            # card), the thermo rows taken on the device
            _sync(dev)
            t0 = time.perf_counter()
            st, th = eng.run(st, args.steps, thermo_every=nchunk)
            _sync(dev)
            wall = time.perf_counter() - t0
            for row in thermo_rows(th or {"step": []}):
                print(thermo_line(row), file=out)
            if nchunk > 0 and args.steps % nchunk != 0:
                # the rows carry multiples of the interval only: the run's
                # last step too, as the reference log ends on it
                print(thermo_line(eng.thermo(st)), file=out)
        else:
            # a trajectory dump fetches the state per chunk
            with open(args.dump, "w") as dumpf:
                t0 = time.perf_counter()
                for start in range(0, args.steps, nchunk):
                    n = min(nchunk, args.steps - start)
                    st, th = eng.run(st, n, thermo_every=n)
                    row = thermo_rows(th)[-1]
                    print(thermo_line(row), file=out, flush=True)
                    dumpio.write_dump_frame(
                        dumpf, int(row["step"]), system.natoms,
                        system.box_lo, system.box_hi, system.tag,
                        st.x.cpu().numpy(), st.q.cpu().numpy())
                wall = time.perf_counter() - t0
        print(f"# Loop time {wall:.3f} s for {args.steps} steps "
              f"({args.steps / wall:.3f} steps/s)", file=out)
        if args.log and not args.no_timing:
            # the run-end timing flush, after the set-up's spans as LAMMPS
            # prints its own breakdown: the reference's Btime/Ctime/Ktime
            # and CG-iteration lines (fix_conp.cpp:553-567, 926-928)
            for line in timers.span_lines("setup."):
                print(f"# {line}", file=out)
            for k, v in timers.profile_step(eng, st, iters=3).items():
                print(f"# {k}: {v * 1e3:.3f} ms", file=out)
            if eng.conp is not None:
                it = eng.conp.cg_iterations(st.x, st.q, st.nbr, eng.ncfg,
                                            st.tasg)
                if it:
                    print(f"# cg_iterations: {it}", file=out)
        if args.checkpoint:
            from .utils.checkpoint import save_checkpoint
            save_checkpoint(args.checkpoint, eng, st)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.log:
        print(f"wrote {args.log}; {args.steps / wall:.2f} steps/s")
    return 0


def cmd_rerun(args):
    from .utils import dump as dumpio
    system, eng = build(args)
    frames = dumpio.read_dump(args.traj)
    out = dumpio.rerun_charges(eng.conp, frames, system.q0, tags=system.tag)
    print("Step c_qleft c_qright f_e")
    for (step, _, _), (_, qn, fe) in zip(frames, out):
        ql = qn[system.ele_left_mask].sum()
        qr = qn[system.ele_right_mask].sum()
        print(f"{step} {ql:.8g} {qr:.8g} {fe:.8g}")
    return 0


def cmd_compare(args):
    from .utils.lammps_log import parse_thermo_blocks
    series = []
    for path in args.logs:
        blocks = parse_thermo_blocks(path)
        if not blocks:
            print(f"{path}: no thermo block found")
            return 1
        series.append((path, blocks[-1]))
    col = args.column
    base = series[0][1][col]
    print(f"column {col}, {len(base)} rows; reference = {series[0][0]}")
    for path, blk in series[1:]:
        n = min(len(base), len(blk[col]))
        diff = np.abs(blk[col][:n] - base[:n])
        print(f"{path}: max|diff|={diff.max():.3e} "
              f"rms={np.sqrt((diff ** 2).mean()):.3e}")
    return 0


# each deck's trials that run the same physics in other modes, and the
# charge column the reference's compare.gnu overlays
SUITE_TRIALS = {
    "dilute": ([0, 1, 2], "c_qleft"),
    "il_onelayer": ([0, 1, 3], "c_qleft"),
    "il_twolayer": ([0, 1, 2], "c_qleft"),
}


def cmd_run_suite(args):
    """Run a deck's equivalent trials and report how far their charges
    agree: the reference's validation (runs per trial and compare.gnu) in
    one command."""
    if args.workload not in SUITE_TRIALS:
        raise ValueError(f"run-suite has no trial set for {args.workload}")
    trials, col = SUITE_TRIALS[args.workload]
    logs = []
    for n in trials:
        a = argparse.Namespace(**vars(args))
        a.trial = n
        a.log = f"log.{args.workload}_{n}"
        a.dump = a.checkpoint = None
        a.no_timing = True
        cmd_run(a)
        logs.append(a.log)
    return cmd_compare(argparse.Namespace(logs=logs, column=col))


def cmd_profile(args):
    _, eng = build(args)
    launches = {}
    st = eng.init_state()
    res = timers.profile_step(eng, st, iters=args.iters, launches=launches)
    print(json.dumps({k: f"{v * 1e3:.3f} ms" for k, v in res.items()},
                     indent=1))
    print("launches " + json.dumps(launches))
    if st.x.is_cuda:
        # the graphed step under the tracer: each layer's device ms, the
        # host's launch and loop time and reads per step, the idle share
        # inside the launches
        print("step_loop " + json.dumps(timers.step_loop(eng, st)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lammps_user_conp2_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("workload", help="dilute | il_onelayer | il_twolayer | "
                       "cond | zmirror | synthetic")
        p.add_argument("trial", type=int, nargs="?", default=0)
        p.add_argument("--f32", action="store_true",
                       help="float32 step path (the hand kernels on the card)")
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (default: the card; raises "
                            "without one)")
        p.add_argument("--solver", choices=("inv", "cg", "cg_matfree"),
                       default=None,
                       help="charge solver override (default: the deck's; "
                            "the reference's is inv, fix_conp.cpp:90)")
        p.add_argument("--pair-path",
                       choices=("auto", "dense", "cell", "nlist", "block",
                                "tile"),
                       default=None, help="real-space pair path override")
        p.add_argument("--kmax", type=int, default=None,
                       help="Verlet-list per-atom capacity override "
                            "(default: sized from the neighbour count at x0)")

    p = sub.add_parser("run")
    add_common(p)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--thermo", type=int, default=20)
    p.add_argument("--log", default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--no-timing", action="store_true",
                   help="skip the per-phase timing flush at the run's end")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("run-suite")
    add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--thermo", type=int, default=20)
    p.set_defaults(fn=cmd_run_suite)

    p = sub.add_parser("rerun")
    add_common(p)
    p.add_argument("traj")
    p.set_defaults(fn=cmd_rerun)

    p = sub.add_parser("compare")
    p.add_argument("logs", nargs="+")
    p.add_argument("--column", default="c_qleft")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("profile")
    add_common(p)
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
