"""Velocity-Verlet integration with group Nose-Hoover chain thermostats.

Semantics follow LAMMPS fix nvt (Nose-Hoover chains, default tchain=3,
group thermostatting as in the test decks `fix 1 sol nvt temp T T 100`):

    nhc half-kick -> velocity half-kick -> drift -> [forces] ->
    velocity half-kick -> nhc half-kick

Atoms outside every integrator group are frozen (the electrodes: velocities
zeroed, no integration fix).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.units import Units


class NHCParams(nn.Module):
    """Static parameters of one thermostat; the group mask is a buffer."""

    def __init__(self, group_mask: torch.Tensor, dof: float, t_start: float,
                 t_stop: float, damp: float, tchain: int):
        super().__init__()
        self.register_buffer("group_mask", group_mask)   # (N,) bool
        self.dof = dof            # 3*Ng - 3 - constraints inside the group
        self.t_start = t_start
        self.t_stop = t_stop
        self.damp = damp          # fs
        self.tchain = tchain


def group_ke(v, mass, mask, mvv2e):
    """2x kinetic energy (sum m v^2 * mvv2e) of a group."""
    mv2 = torch.sum(mass[:, None] * v * v, dim=1)
    return mvv2e * torch.sum(torch.where(mask, mv2, torch.zeros_like(mv2)))


def group_temperature(v, mass, mask, dof, units: Units):
    return group_ke(v, mass, mask, units.mvv2e) / (dof * units.boltz)


def nhc_half_step(v, xi, vxi, params: NHCParams, mass, dt, boltz, mvv2e,
                  t_target):
    """Half-step Nose-Hoover chain update; returns (v_scaled, xi, vxi).

    Martyna-Tuckerman-Klein chain (tchain links, one Suzuki-Yoshida loop
    like LAMMPS default tloop=1).  ``vxi`` is not modified in place."""
    m = params.tchain
    dof = params.dof
    kt = boltz * t_target
    # thermostat masses: Q1 = dof kT damp^2, Qk = kT damp^2
    q = [dof * kt * params.damp ** 2] + [kt * params.damp ** 2] * (m - 1)
    ke2 = group_ke(v, mass, params.group_mask, mvv2e)  # sum m v^2
    vxi = vxi.clone()

    dt2 = dt / 2.0
    dt4 = dt / 4.0
    dt8 = dt / 8.0

    # update chain velocities from the end inward
    g = [(ke2 - dof * kt) / q[0]]
    for k in range(1, m):
        g.append((q[k - 1] * vxi[k - 1] ** 2 - kt) / q[k])

    vxi[m - 1] = vxi[m - 1] + g[m - 1] * dt4
    for k in range(m - 2, -1, -1):
        ef = torch.exp(-dt8 * vxi[k + 1])
        vxi[k] = (vxi[k] * ef + g[k] * dt4) * ef

    # scale particle velocities
    scale = torch.exp(-dt2 * vxi[0])
    v = torch.where(params.group_mask[:, None], v * scale, v)
    ke2 = ke2 * scale * scale
    xi = xi + dt2 * vxi

    # second pass outward
    g[0] = (ke2 - dof * kt) / q[0]
    for k in range(0, m - 1):
        ef = torch.exp(-dt8 * vxi[k + 1])
        vxi[k] = (vxi[k] * ef + g[k] * dt4) * ef
        g[k + 1] = (q[k] * vxi[k] ** 2 - kt) / q[k + 1]
    vxi[m - 1] = vxi[m - 1] + g[m - 1] * dt4
    return v, xi, vxi


class Integrator(nn.Module):
    """Velocity Verlet with per-group NHC thermostats and frozen non-mobile
    atoms.  ``dtfm`` is kick's factor, formed as ``kick`` forms it, for
    K10 (``ops/kernels/integrate_kernel``: a half step in one launch on
    the card)."""

    def __init__(self, *, dt: float, units: Units, mass: torch.Tensor,
                 mobile_mask: torch.Tensor, thermostats):
        super().__init__()
        self.dt = dt
        self.units = units
        self.register_buffer("mass", mass)                # (N,)
        self.register_buffer("mobile_mask", mobile_mask)  # (N,) bool
        self.thermostats = nn.ModuleList(thermostats)
        self.register_buffer("dtfm", (dt / 2.0) * units.ftm2v / mass)

    def thermostat_half(self, v, xi, vxi):
        """One NHC half step for every thermostat (constant target
        temperature t_start, as in every reference deck)."""
        if not len(self.thermostats):
            return v, xi, vxi
        new_xi, new_vxi = [], []
        for i, p in enumerate(self.thermostats):
            v, xi_i, vxi_i = nhc_half_step(
                v, xi[i], vxi[i], p, self.mass, self.dt, self.units.boltz,
                self.units.mvv2e, p.t_start)
            new_xi.append(xi_i)
            new_vxi.append(vxi_i)
        return v, torch.stack(new_xi), torch.stack(new_vxi)

    def kick(self, v, f):
        dtfm = (self.dt / 2.0) * self.units.ftm2v / self.mass[:, None]
        return torch.where(self.mobile_mask[:, None], v + dtfm * f, v)

    def drift(self, x, v):
        return torch.where(self.mobile_mask[:, None], x + self.dt * v, x)


def make_nhc_params(group_mask: np.ndarray, t_start, t_stop, damp, *,
                    nconstraints: int = 0, tchain: int = 3,
                    device=None) -> NHCParams:
    """One thermostat on ``group_mask`` with 3 Ng - 3 - nconstraints degrees
    of freedom, its mask on ``device`` (None: the card)."""
    dof = 3 * int(group_mask.sum()) - 3 - nconstraints
    return NHCParams(torch.as_tensor(group_mask, device=resolve_device(device)),
                     float(dof), float(t_start), float(t_stop), float(damp),
                     tchain)
