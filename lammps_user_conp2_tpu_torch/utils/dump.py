"""LAMMPS-style trajectory dumps and rerun.

The reference decks dump ``id xu yu zu q`` (tests/il_onelayer/input:101-103)
and rerun from those files (``rerun sol2.traj dump x y z``) to check that
the electrode charges regenerate from the positions.  The same format is
written here, and rerun is the charge solve at each frame's positions.
"""

from __future__ import annotations

import numpy as np
import torch


def write_dump_frame(f, step: int, natoms: int, box_lo, box_hi, tag, x,
                     q=None) -> None:
    """One frame (numpy arrays, rows in any order; ``id`` is the tag)."""
    f.write("ITEM: TIMESTEP\n%d\n" % step)
    f.write("ITEM: NUMBER OF ATOMS\n%d\n" % natoms)
    f.write("ITEM: BOX BOUNDS pp pp pp\n")
    for ax in range(3):
        f.write(f"{box_lo[ax]:.16e} {box_hi[ax]:.16e}\n")
    if q is None:
        f.write("ITEM: ATOMS id x y z\n")
        for i in range(natoms):
            f.write(f"{int(tag[i])} {x[i,0]:.8g} {x[i,1]:.8g} {x[i,2]:.8g}\n")
    else:
        f.write("ITEM: ATOMS id xu yu zu q\n")
        for i in range(natoms):
            f.write(f"{int(tag[i])} {x[i,0]:13.8g} {x[i,1]:13.8g} "
                    f"{x[i,2]:13.8g} {q[i]:13.8g}\n")


def read_dump(path: str):
    """[(step, tags, {column: values})] per frame, each frame's rows sorted
    by tag."""
    frames = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("ITEM: TIMESTEP"):
            raise ValueError(f"{path}:{i + 1}: expected ITEM: TIMESTEP")
        step = int(lines[i + 1])
        natoms = int(lines[i + 3])
        i += 4
        if not lines[i].startswith("ITEM: BOX"):
            raise ValueError(f"{path}:{i + 1}: expected ITEM: BOX BOUNDS")
        i += 4
        cols = lines[i].split()[2:]
        i += 1
        data = np.array([[float(v) for v in lines[i + k].split()]
                         for k in range(natoms)])
        i += natoms
        order = np.argsort(data[:, cols.index("id")], kind="stable")
        data = data[order]
        frames.append((step, data[:, 0].astype(np.int64),
                       {c: data[:, k] for k, c in enumerate(cols)}))
    return frames


def rerun_charges(solver, frames, q0, *, tags):
    """The electrode charges of dumped frames (the reference's ``rerun ...
    dump x y z`` trials): [(step, q (N,) numpy, fix scalar)] per frame,
    each a charge solve at the frame's positions from the charges ``q0``.

    ``tags`` (the System's tag array) is required: ``read_dump`` sorts each
    frame by tag, while the solver takes the System's row order, which
    differs after ``models.system.electrodes_first``; each frame's rows are
    mapped to that order and the charges come back in it."""
    if tags is None:
        raise ValueError("rerun_charges needs the System's tags")
    dev = solver.ele_idx_t.device
    dt = solver.solve_dtype
    q = torch.as_tensor(np.asarray(q0), dtype=dt, device=dev)
    out = []
    for step, ftags, cols in frames:
        x = np.stack([cols[next(c for c in (a, a + "u") if c in cols)]
                      for a in ("x", "y", "z")], axis=1)
        # ftags ascend (read_dump sorts): the frame row of each system tag
        pos = np.searchsorted(ftags, np.asarray(tags))
        if not np.array_equal(ftags[np.minimum(pos, len(ftags) - 1)],
                              np.asarray(tags)):
            raise ValueError(f"frame {step}: its tags are not the system's")
        xt = torch.as_tensor(x[pos], dtype=dt, device=dev)
        st = torch.tensor(step, dtype=torch.int64, device=dev)
        qn, scalar, _ = solver.solve_full(xt, q, step=st)
        out.append((step, qn.cpu().numpy(), float(scalar)))
    return out
