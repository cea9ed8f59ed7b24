"""Electrode capacitance, the headline observable of constant-potential
studies (the port of the repository's ``tools/capacitance.py``).

    python -m lammps_user_conp2_tpu_torch.capacitance <workload> <trial>
        [--steps N] [--thermo K] [--cpu]

Two estimators, in e/V:

* static: C = dQ_left/dV from the set-up's linear algebra.  The charge
  update is q = A^-1 b + dV elesetq (fix_conp.cpp:1153-1158), so
  dQ_left/dV = sum_left elesetq = totsetq, the ``<d,d>`` the reference
  logs at set-up (fix_conp.cpp:458-461): no simulation needed.  It is the
  float64 set-up's value whatever the solve dtype.
* fluctuation: C_diff = <dQ^2> / (k_B T) over an equilibrium trajectory at
  fixed potential, the left electrode's charge Q sampled every ``--thermo``
  steps, T the run's mean temperature.

The run is ``Engine.run`` (CUDA graphs on the card, float32; float64 on
the CPU with ``--cpu``), ``max(steps // 10, 10)`` steps of equilibration
and then ``--steps`` sampled steps.  The decks read their data under
``$CONP_REF_TESTS``, as the command line's do.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def static_capacitance(solver) -> float:
    """dQ_left/dV in e/V: the set-up's float64 totsetq."""
    return float(solver.totsetq64)


def fluctuation_capacitance(qleft_series, temp_k: float, units) -> float:
    """C_diff = <dQ^2>/(k_B T) in e/V: Q in e, k_B T in energy units, and
    the potential unit is energy per charge over ``evscale`` (volts), so C
    = var(Q) evscale / (boltz T)."""
    var = float(np.var(np.asarray(qleft_series, np.float64)))
    return var * units.evscale / (units.boltz * temp_k)


def estimate(workload: str, trial: int, steps: int, thermo: int = 5, *,
             device=None) -> dict:
    """Both estimators for a deck's trial on ``device`` (None: the card,
    float32; the CPU: float64): {"static", "fluctuation", "temp_mean",
    "samples", "area"}."""
    from .cli import load_deck
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .utils.device import resolve_device

    dev = resolve_device(device)
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    system, md, cfg = load_deck(workload, trial)
    solver = setup_conp(system, md, cfg, solve_dtype=dtype, device=dev)
    eng = build_engine(system, md, solver, dtype=dtype, device=dev)
    st = eng.init_state()
    st, _ = eng.run(st, max(steps // 10, 10), thermo_every=0)
    st, th = eng.run(st, steps, thermo_every=thermo)
    qleft = th["qleft"].double().cpu().numpy()
    temp = float(th["temp"].double().mean())
    return dict(static=static_capacitance(solver),
                fluctuation=fluctuation_capacitance(qleft, temp,
                                                    system.units()),
                temp_mean=temp, samples=len(qleft),
                area=system.box[0] * system.box[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("trial", type=int)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--thermo", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64 (default: the card, "
                         "float32; raises without one)")
    args = ap.parse_args(argv)
    r = estimate(args.workload, args.trial, args.steps, args.thermo,
                 device="cpu" if args.cpu else None)
    c = r["static"]
    print(f"static capacitance dQ_left/dV = {c:.17g} e/V "
          f"({c / r['area'] * 1e2:.4f} e/V per nm^2 of xy area)")
    print(f"fluctuation capacitance <dQ^2>/(kB T) = {r['fluctuation']:.6g} "
          f"e/V at <T> = {r['temp_mean']:.6g} K over {r['samples']} samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
