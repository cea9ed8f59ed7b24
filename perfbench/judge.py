"""What decides ``correct``: the program's answers at states that the timed
window produced, against the plain reference's answers at the same
states.

A sample is one state of the program (its positions, velocities,
thermostat and charges) with what the program made of it: the electrode
charges and the fix scalar solved at its positions, the forces and the
potential energy, the thermo row it printed there (chunk ends), and the
states after one and two more steps of the same CUDA graphs.  The
reference (``reference.conp_md.Reference``) works each of these out again
from the positions, velocities and thermostat alone, its second step from
its own first; ``readings`` reduces the gaps to a few numbers, each held
to its limit in ``perfbench/limits/<cell>.json``.  The positions after
the second step carry the velocities after the first (the closing kick
and thermostat half), which the charges and energy there then show; the
velocities along the SHAKE bonds that RATTLE removes go back out of them
at the next SHAKE.  ``constraint_residuals`` reads the constraints off a
state, for the log; it decides nothing.
"""

from __future__ import annotations

import numpy as np
import torch

# the thermo row's columns (the CLI's, without the step)
THERMO = ("temp", "tempsl", "qleft", "qright", "dipole", "f_e", "pe")
# what a sample keeps of each state after a step
STEP = ("x", "v", "q", "f", "pe", "scalar")


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy()


def model_answers(model, state) -> dict:
    """A sample's answers worked out by ``model`` (the reference, or the
    control in its place) from ``state`` (host float64 arrays in the
    reference's atom order: x, v, xi, vxi, and q0 the file's charges)."""
    t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.dev)
    x, v = t(state["x"]), t(state["v"])
    q0 = t(state["q0"])
    q, sc = model.solve(x, q0)
    f, pe = model.forces(x, q)
    row = model.thermo(v, q, x, sc, pe)
    nxt = model.step(x, v, t(state["xi"]), t(state["vxi"]), q0)
    nxt2 = model.step(nxt["x"], nxt["v"], nxt["xi"], nxt["vxi"], q0)
    after = lambda s: {k: (_np(s[k]) if s[k].dim() else float(s[k]))
                       for k in STEP}
    return dict(q=_np(q), scalar=float(sc), f=_np(f), pe=float(pe),
                row={k: float(row[k]) for k in THERMO}, next=after(nxt),
                next2=after(nxt2))


def _rel(a, b, scale=None):
    """max |a - b| over max |b| (or over ``scale``); inf where a is not
    finite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.all(np.isfinite(a)):
        return float("inf")
    den = float(np.max(np.abs(b))) if scale is None else scale
    return float(np.max(np.abs(a - b))) / max(den, 1e-300)


def units(deck) -> np.ndarray:
    """(N,) the rigid unit of each atom: one per SHAKE cluster (the
    connected constrained atoms), every other atom a unit of its own."""
    from .reference.conp_md import clusters
    unit = np.arange(deck.natoms)
    for atoms, _, _ in clusters(deck.shake):
        for members in atoms:
            unit[members] = members[0]
    return np.unique(unit, return_inverse=True)[1]


def _by_unit(a, unit, weight=None):
    """Per-unit sums of the rows of ``a`` (weighted rows with ``weight``,
    divided by the unit's total weight)."""
    n = int(unit.max()) + 1
    w = np.ones(len(unit)) if weight is None else weight
    out = np.zeros((n,) + a.shape[1:])
    np.add.at(out, unit, a * (w[:, None] if a.ndim > 1 else w))
    if weight is not None:
        out /= np.bincount(unit, weights=weight, minlength=n)[:, None]
    return out


def _mi(dx, deck):
    box = np.asarray(deck.box)
    return np.where(np.asarray(deck.periodic), dx - box * np.round(dx / box),
                    dx)


def constraint_residuals(x, v, deck) -> tuple:
    """(positions, velocities) of one state against the deck's SHAKE
    constraints: max | |r_ij| - d | / d, and max |v_ij . r_ij| / |r_ij|
    over the largest |v_ij| (what RATTLE removes); inf where not finite."""
    c = np.asarray(deck.shake, np.float64)
    i, j, d = c[:, 0].astype(int), c[:, 1].astype(int), c[:, 2]
    r = _mi(x[i] - x[j], deck)
    rn = np.linalg.norm(r, axis=1)
    vij = v[i] - v[j]
    pos = np.max(np.abs(rn - d) / d)
    vel = np.max(np.abs((vij * r).sum(1)) / rn) / max(
        float(np.max(np.linalg.norm(vij, axis=1))), 1e-300)
    return tuple(float(a) if np.isfinite(a) else float("inf")
                 for a in (pos, vel))


def readings(samples, deck) -> dict:
    """The compared numbers over ``samples`` [(state, got, ref)]: ``got``
    the program's (or the control's) answers, ``ref`` the reference's.

    q: electrode charges, max gap over max |q_ref|, at each state and
    after its first and second step; fix_scalar: |gap| over the left
    electrode's sum of |q_ref|, likewise; forces: the force on each rigid
    unit (``units``: a SHAKE cluster's sites summed, where the bonded terms
    cancel), max gap over max |F_ref|, at each state and after its first
    step (after the second, float32's drift of the positions makes sound
    runs read as far as the control at il4); pe: |gap| / |pe_ref|, at
    each state and after both steps; thermo: each column of the printed
    row, |gap| over its scale (the temperatures and pe: |ref|; qleft, f_e
    and qright: the electrode's sum of |q_ref|; the dipole: sum |q z| of
    the group), max over the chunk ends; step_v: the velocity of each
    rigid unit's centre of mass after each of the two steps, max gap over
    max |V_ref|."""
    ele, sol, left, right = deck.ele, deck.sol, deck.left, deck.right
    unit = units(deck)
    r = dict(q=0.0, fix_scalar=0.0, forces=0.0, pe=0.0, thermo=0.0,
             step_v=0.0)
    up = lambda k, v: r.__setitem__(k, max(r[k], v if np.isfinite(v)
                                           else float("inf")))
    for st, got, ref in samples:
        steps = ((got["next"], ref["next"]), (got["next2"], ref["next2"]))
        for n, (g, e) in enumerate(((got, ref),) + steps):
            ql = float(np.abs(e["q"][left]).sum())
            up("q", _rel(g["q"][ele], e["q"][ele]))
            up("fix_scalar", _rel(g["scalar"], e["scalar"], ql))
            if n < 2:
                up("forces", _rel(_by_unit(g["f"], unit),
                                  _by_unit(e["f"], unit)))
            up("pe", _rel(g["pe"], e["pe"]))
        if got.get("row") is not None:
            scale = dict(
                qleft=np.abs(ref["q"][left]).sum(),
                f_e=np.abs(ref["q"][left]).sum(),
                qright=np.abs(ref["q"][right]).sum(),
                dipole=np.abs(ref["q"] * st["x"][:, 2])[sol].sum())
            for k in THERMO:
                up("thermo", _rel(got["row"][k], ref["row"][k],
                                  scale.get(k)))
        for g, e in steps:
            up("step_v", _rel(_by_unit(g["v"], unit, deck.mass),
                              _by_unit(e["v"], unit, deck.mass)))
    return r


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers ``limits``
    names; a number missing or not finite fails."""
    out = []
    ok = True
    for name, lim in limits.items():
        v = values.get(name, float("nan"))
        good = bool(np.isfinite(v) and v <= lim["limit"])
        ok = ok and good
        out.append((name, v, lim["limit"]))
    return ok, out
