"""How far the SHAKE constraints hold along an ionic-liquid trajectory.

    python -m lammps_user_conp2_tpu_torch.shake_residual [--cell small|full]
        [--device cuda|cpu] [--dtype float32|float64] [--steps 2000]
        [--every 100] [--out chiprun_out]

Runs ``workloads.il_onelayer(0)`` on the file of ``workloads.write_il_data``
(``full``: the 3,776-atom cell; ``small``: the 352-atom test cell with the
cutoff and k-space accuracy the CPU tests use) and prints, every ``--every``
steps: the constraint residual max|r^2 - d^2|/d^2 of each slot (bond 1,
bond 2, the 1-3 distance), the signed length errors r - d of the two
bonds (min and max over the cations, A) and the largest bend of a cation
away from 180 degrees.  The last line is one JSON object with the series.

Why: the decks' 180-degree angle constraint is degenerate with the two
bonds.  At a straight rotor the three constraint directions are parallel,
so SHAKE corrects only along the axis; a bend that the forces make cannot
be removed, and with the 1-3 distance held (the last slot of each sweep)
the bonds of a bent rotor come out long.  Their residual follows the bend,
which the angle potential and the temperature bound, not the sweep count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

SMALL = dict(n_pairs=40, sheets=1, nx=6, ny=4, seed=0)
SMALL_MD = dict(cutoff=7.0, kspace_accuracy=1e-5)


def il_cell(cell: str, out_dir: str):
    """(system, md, cfg) of il_onelayer(0) on the ``cell`` fixture file."""
    from . import workloads
    os.makedirs(out_dir, exist_ok=True)
    if cell == "small":
        path = workloads.write_il_data(
            os.path.join(out_dir, "il_small.data"), **SMALL)
        system, md, cfg = workloads.il_onelayer(0, data_path=path)
        return system, dataclasses.replace(md, **SMALL_MD), cfg
    path = workloads.write_il_data(os.path.join(out_dir, "il_3776.data"))
    return workloads.il_onelayer(0, data_path=path)


def rotor_geometry(cons, x, *, box, periodic) -> dict:
    """Signed bond length errors and the bend of each 3-site cluster whose
    last slot is its 1-3 distance (the il decks' cations)."""
    from .ops.pairs import min_image
    a = cons.atoms.long()
    rows = torch.arange(a.shape[0], device=a.device)
    ci, cj = cons.ci.long(), cons.cj.long()
    vec = lambda s: min_image(x[a[rows, ci[:, s]]] - x[a[rows, cj[:, s]]],
                              box, periodic).double()
    out = {}
    for s in range(ci.shape[1] - 1):
        err = vec(s).norm(dim=1) - cons.dist2[:, s].double().sqrt()
        out[f"bond{s + 1}_err_min"] = float(err.min())
        out[f"bond{s + 1}_err_max"] = float(err.max())
    mid = 3 - ci[:, -1] - cj[:, -1]            # the column off the 1-3 slot
    u = min_image(x[a[rows, ci[:, -1]]] - x[a[rows, mid]], box,
                  periodic).double()
    w = min_image(x[a[rows, cj[:, -1]]] - x[a[rows, mid]], box,
                  periodic).double()
    cos = (u * w).sum(1) / (u.norm(dim=1) * w.norm(dim=1))
    bend = 180.0 - torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))
    out["bend_max_deg"] = float(bend.max())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("small", "full"), default="full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    from .models.conp import setup_conp
    from .models.md import build_engine
    from .models.shake import constraint_residuals

    dtype = getattr(torch, args.dtype)
    system, md, cfg = il_cell(args.cell, args.out)
    conp = setup_conp(system, md, cfg, solve_dtype=dtype, device=args.device)
    eng = build_engine(system, md, conp, dtype=dtype, device=args.device)
    kw = dict(box=system.box, periodic=system.periodic)
    st = eng.init_state()
    series = []
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        st = eng.step(st)
        if i % args.every and i not in (1, 3, 11, 20, 50, 111):
            continue
        rec = dict(step=i, residual=constraint_residuals(eng.cons, st.x, **kw),
                   **rotor_geometry(eng.cons, st.x, **kw),
                   temp=float(eng.thermo(st)["temp"]),
                   seconds=time.perf_counter() - t0)
        if not math.isfinite(float(st.energy)):
            raise SystemExit(f"shake_residual: energy not finite at step {i}")
        series.append(rec)
        print(f"step {i:5d}  residual {['%.3e' % r for r in rec['residual']]}"
              f"  bond err [{rec['bond1_err_min']:.1e}, "
              f"{rec['bond1_err_max']:.1e}] [{rec['bond2_err_min']:.1e}, "
              f"{rec['bond2_err_max']:.1e}] A  bend max "
              f"{rec['bend_max_deg']:.2f} deg  T {rec['temp']:.1f} K  "
              f"{rec['seconds']:.1f} s", flush=True)
    print(json.dumps(dict(cell=args.cell, natoms=system.natoms,
                          device=str(args.device), dtype=args.dtype,
                          series=series)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
