"""Faults planted under the program's timed path, for the tests and for
``calibrate.py --fault``: ``plant(name)`` patches the program's classes
(before the engine is built, so that the CUDA graphs capture the fault)
and returns the function that takes the patch out again.

unchanged: a step that returns its state unchanged (the eager step only);
half_forces: half of the atoms' forces left out; altered_charge: an
electrode charge altered where the solve produces it; no_closing_kick,
no_closing_thermostat, no_rattle: the step's second half-kick, its
closing thermostat half or its RATTLE left out.
"""

from __future__ import annotations

import dataclasses

import torch


def _unchanged(self, state):
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
        bump = torch.zeros_like(qn)
        bump[self.ele_idx_t[0]] = 1e-2 * float(qn.abs().max())
        return qn + bump, scalar, kc
    return solve_end


def _closing(inner, name, skip):
    """``Engine._post_tail`` with the integrator's ``name`` replaced by
    ``skip`` inside it: the step's second use of it."""
    def post_tail(self, *a, **k):
        setattr(self.integrator, name, skip)
        try:
            return inner(self, *a, **k)
        finally:
            delattr(self.integrator, name)
    return post_tail


def plant(name: str):
    from lammps_user_conp2_tpu_torch.models import conp, md
    owner, attr, new = {
        "unchanged": lambda: (md.Engine, "step", _unchanged),
        "half_forces": lambda: (md.Engine, "compute_forces",
                                _half_forces(md.Engine.compute_forces)),
        "altered_charge": lambda: (conp.ConpSolver, "solve_end",
                                   _altered_charge(
                                       conp.ConpSolver.solve_end)),
        "no_closing_kick": lambda: (md.Engine, "_post_tail", _closing(
            md.Engine._post_tail, "kick", lambda v, f: v)),
        "no_closing_thermostat": lambda: (md.Engine, "_post_tail", _closing(
            md.Engine._post_tail, "thermostat_half",
            lambda v, xi, vxi: (v, xi, vxi))),
        "no_rattle": lambda: (md, "rattle_velocities",
                              lambda cons, x, v, **k: v),
    }[name]()
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    return lambda: setattr(owner, attr, old)
