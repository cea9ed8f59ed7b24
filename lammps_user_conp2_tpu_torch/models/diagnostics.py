"""Diagnostic computes: potential/atom, group potential and nghosts.

potential/atom (compute_potential_atom.cpp): the electric potential at each
atom of a group, in volts: the real-space erfc sum with the Gaussian
electrode corrections, the k-space part (the PPPM mesh readout or the
direct Ewald sum) minus the Gaussian self term, and the slab correction,
divided by evscale (compute_potential_atom.cpp:181).  The pair sum runs
over row blocks of the group's atoms against every atom, so an electrode's
potential at 100k atoms needs a (block, N) transient, not an (N, N) one.

nghosts (compute_nghosts.cpp) counts the periodic images a one-rank LAMMPS
run would ghost for each atom: geometry only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import ewald as ewald_ops
from ..ops import pppm as pppm_ops
from ..ops.erfc import ERFC_MAX, erfc_as
from ..ops.pairs import min_image

MY_PIS = math.sqrt(math.pi)


def potential_atom(x, q, *, group_mask, elecheck, box, periodic, cutoff,
                   g_ewald, evscale, volume, eta: float = 0.0,
                   pairflag: bool = True, kspaceflag: bool = True,
                   slabflag: bool = False, qsumflag: bool = True,
                   pppm_grid=None, kvecs=None, ug=None, block: int = 512):
    """Per-atom potential (N,) in volts, 0 outside ``group_mask`` (a (N,)
    bool tensor); ``elecheck`` (N,) +-1 on the electrodes, 0 elsewhere, for
    the eta correction.  k-space: the mesh of ``pppm_grid``, else the
    direct Ewald sum over ``kvecs`` (K, 3) with weights ``ug`` (K,)."""
    n = x.shape[0]
    rows = torch.nonzero(group_mask).squeeze(1)
    xg, qg = x[rows], q[rows]
    is_ele = elecheck != 0
    pot = torch.zeros(rows.shape[0], dtype=x.dtype, device=x.device)

    if pairflag:
        cutsq = min(cutoff ** 2, (ERFC_MAX / g_ewald) ** 2)
        cols = torch.arange(n, device=x.device)
        parts = []
        # a pair counts when either atom is in the group (cpa.cpp:263-265):
        # the group's rows against every atom give the same sums
        for r0 in range(0, rows.shape[0], block):
            rb = rows[r0:r0 + block]
            dx = min_image(x[rb][:, None, :] - x[None, :, :], box, periodic)
            rsq = torch.clamp(torch.sum(dx * dx, dim=-1), min=1e-10)
            mask = (rsq < cutsq) & (rb[:, None] != cols[None, :])
            r = torch.sqrt(rsq)
            dudq = erfc_as(g_ewald * r) / r
            if eta != 0.0:
                nele = (is_ele[rb][:, None].to(torch.int32)
                        + is_ele[None, :].to(torch.int32))
                etarij = torch.where(nele == 2, r * (eta / math.sqrt(2.0)),
                                     r * eta)
                corr = torch.where((nele > 0) & (etarij < ERFC_MAX),
                                   erfc_as(etarij) / r, torch.zeros_like(r))
                dudq = dudq - corr
            parts.append(torch.sum(torch.where(mask, dudq,
                                               torch.zeros_like(dudq))
                                   * q[None, :], dim=1))
        if parts:
            pot = pot + torch.cat(parts)

    if kspaceflag:
        if pppm_grid is not None:
            # the spread takes the tiled route (K2b) above the dense bound
            rho = pppm_ops.spread(pppm_grid, x, q)
            u = pppm_ops.poisson_u(pppm_grid, rho)
            phik = pppm_ops.gather(pppm_grid, u, xg)
        else:
            sre, sim = ewald_ops.structure_factor(x, q, kvecs)
            phik = ewald_ops.kspace_potential_on_points(xg, kvecs, ug, sre,
                                                        sim)
        # the mesh / Ewald potential minus the Gaussian self term
        # (pppm_conp.cpp:452-488: u includes +2g/sqrt(pi) q; cpa subtracts it)
        pot = pot + phik - 2.0 * g_ewald / MY_PIS * qg
        if eta != 0.0:
            pot = pot + torch.where(is_ele[rows],
                                    eta * qg * math.sqrt(2.0) / MY_PIS,
                                    torch.zeros_like(qg))
        if slabflag:
            slabcorr = (4.0 * math.pi / volume) * torch.sum(q * x[:, 2])
            pot = pot + xg[:, 2] * slabcorr
            if qsumflag:
                pot = pot - (2.0 * math.pi / volume) * torch.sum(q) \
                    * xg[:, 2] ** 2

    # internal (e/A) -> volts: the compute's own scale is qqr2e/qe2f, the
    # inverse of the fix's evscale (compute_potential_atom.cpp:109 vs
    # fix_conp.cpp:412)
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_copy(0, rows, pot) / evscale


def nghosts(x, *, box, box_lo, cutoff, periodic) -> np.ndarray:
    """Ghost-image count per atom for one spatial domain (the one-rank
    LAMMPS value of compute nghosts, compute_nghosts.cpp:36-58)."""
    x = np.asarray(x)
    count = np.ones(len(x), np.int64)
    for ax in range(3):
        if not periodic[ax]:
            continue
        lo = box_lo[ax]
        hi = box_lo[ax] + box[ax]
        near = ((x[:, ax] - lo) < cutoff).astype(np.int64) + \
               ((hi - x[:, ax]) < cutoff).astype(np.int64)
        count *= 1 + near
    return count - 1


def group_potential(x, q, group_mask, **kw):
    """Average potential of a group in volts (compute_group_potential,
    pppm_conp.cpp:490-534; read per electrode)."""
    pot = potential_atom(x, q, group_mask=group_mask, **kw)
    return torch.sum(pot) / torch.sum(group_mask)


def engine_potential_kw(engine) -> dict:
    """``potential_atom``'s set-up keywords for an engine with a charge
    solve: its box, cutoff, Ewald splitting, evscale, the solver's eta and
    slab flag, and its k-space (the engine's mesh, else the solver's
    Ewald k-vectors) in the engine's dtype on its device."""
    conp = engine.conp
    ksp = conp.ksp
    dev, dt = engine.type_idx.device, engine.dtype
    kw = dict(elecheck=engine.elecheck, box=engine.system.box,
              periodic=engine.system.periodic, cutoff=engine.md.cutoff,
              g_ewald=ksp.g_ewald, evscale=engine.units.evscale,
              volume=ksp.volume, eta=conp.cfg.eta, slabflag=ksp.slabflag)
    if engine.pppm_grid is not None:
        kw["pppm_grid"] = engine.pppm_grid
    else:
        kw["kvecs"] = torch.as_tensor(ksp.kvecs, dtype=dt, device=dev)
        kw["ug"] = torch.as_tensor(ksp.ug, dtype=dt, device=dev)
    return kw
