"""Faults planted under the program's timed path, for the tests and for
``calibrate.py --fault``: ``plant(name)`` patches the program's classes
(before the engine is built, so that the CUDA graphs capture the fault)
and returns the function that takes the patch out again.

unchanged: a step that returns its state unchanged (``Engine._post_tail``,
which the eager step and the CUDA graphs' segments both end in);
half_forces: half of the atoms' forces left out; altered_charge: an
electrode charge altered where the solve produces it; no_closing_kick,
no_closing_thermostat, no_rattle: the step's second half-kick, its
closing thermostat half or its RATTLE left out (the first two planted on
``md.integrate_half``, K10's entry, so that they run on the card).
"""

from __future__ import annotations

import dataclasses

import torch


def _unchanged(self, state, *a, **k):
    return dataclasses.replace(state, step=state.step + 1,
                               step_t=state.step_t + 1)


def _half_forces(inner):
    def compute_forces(self, x, q, *a, **k):
        f, pe = inner(self, x, q, *a, **k)
        keep = torch.arange(f.shape[0], device=f.device) < f.shape[0] // 2
        return torch.where(keep[:, None], f, torch.zeros_like(f)), pe
    return compute_forces


def _altered_charge(inner):
    def solve_end(self, pend, x, q, step=None):
        qn, scalar, kc = inner(self, pend, x, q, step)
        # no host read: the solve runs inside a CUDA graph capture
        bump = torch.zeros_like(qn).index_fill(0, self.ele_idx_t[:1], 1.0)
        return qn + bump * (1e-2 * qn.abs().max()), scalar, kc
    return solve_end


def _closing(inner, drop):
    """``md.integrate_half`` with the stage ``drop`` left out of the step's
    second half (the stage sequences that start with the kick or are the
    thermostat half alone); a sequence with nothing left returns its
    input.  Every sequence it passes on is one the kernel runs."""
    def integrate_half(itg, v, f, x, xi, vxi, stages):
        if stages[0] != "nhc" or stages == ("nhc",):
            stages = tuple(s for s in stages if s != drop)
            if not stages:
                return v, x, xi, vxi
        return inner(itg, v, f, x, xi, vxi, stages)
    return integrate_half


def plant(name: str):
    from lammps_user_conp2_tpu_torch.models import conp, md
    owner, attr, new = {
        "unchanged": lambda: (md.Engine, "_post_tail", _unchanged),
        "half_forces": lambda: (md.Engine, "compute_forces",
                                _half_forces(md.Engine.compute_forces)),
        "altered_charge": lambda: (conp.ConpSolver, "solve_end",
                                   _altered_charge(
                                       conp.ConpSolver.solve_end)),
        "no_closing_kick": lambda: (md, "integrate_half", _closing(
            md.integrate_half, "kick")),
        "no_closing_thermostat": lambda: (md, "integrate_half", _closing(
            md.integrate_half, "nhc")),
        "no_rattle": lambda: (md, "rattle_velocities",
                              lambda cons, x, v, **k: v),
    }[name]()
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    return lambda: setattr(owner, attr, old)
