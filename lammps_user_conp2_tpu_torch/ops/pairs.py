"""Dense real-space pair interactions (LJ + Coulomb/long + CONP corrections).

Plain PyTorch, swept in row blocks to bound memory at (block x N).  These
are the CPU path and the plain versions the CUDA pair kernels are held
against (``ops/kernels``).

Physics matches lj/cut/coul/long (LAMMPS pair_lj_cut_coul_long.cpp) with
special_bonds 0 0 0: excluded pairs keep the k-space compensation term
(-erf(g r)/r), i.e. forcecoul -= (1-factor)*prefactor.

The CONP Gaussian correction (blist_coul_cal_post_force,
fix_conp.cpp:1368-1444) subtracts the point-charge/Gaussian difference on
electrode<->electrolyte pairs, with the dimensionally correct force
delx*forcecoul/rsq and the ERFC_MAX^2 gate (the reference's typos are
documented in the JAX package's ops/pairs.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .erfc import EWALD_F, erfcr_sqrt, ferfcr_sqrt


def min_image(dx, box, periodic):
    """Minimum-image displacement for an orthogonal box.

    box: (3,) lengths (python floats); periodic: tuple of bools."""
    out = []
    for ax in range(3):
        d = dx[..., ax]
        if periodic[ax]:
            L = box[ax]
            d = d - L * torch.round(d / L)
        out.append(d)
    return torch.stack(out, dim=-1)


class PairTables(NamedTuple):
    """Per-type-pair LJ tables, (nt+1, nt+1) each."""
    lj1: torch.Tensor   # 48 eps sig^12 (force)
    lj2: torch.Tensor   # 24 eps sig^6
    lj3: torch.Tensor   # 4 eps sig^12 (energy)
    lj4: torch.Tensor   # 4 eps sig^6


def make_pair_tables(lj_eps: np.ndarray, lj_sigma: np.ndarray, *,
                     device=None, dtype=torch.float64) -> PairTables:
    s6 = lj_sigma ** 6
    s12 = s6 * s6
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return PairTables(lj1=mk(48.0 * lj_eps * s12), lj2=mk(24.0 * lj_eps * s6),
                      lj3=mk(4.0 * lj_eps * s12), lj4=mk(4.0 * lj_eps * s6))


def special_factors(exi, exv, cols, dtype):
    """Special-bond factors of (row, column) pairs from the rows' own
    exclusion lists ``exi``/``exv`` (..., m): 1 unless ``cols`` (broadcast
    against (..., 1)) is listed; the last listed match wins, as in the CUDA
    kernels.  The dense and list sweeps and K1's plain version use it."""
    si = torch.ones(torch.broadcast_shapes(exi.shape[:-1] + (1,), cols.shape),
                    dtype=dtype, device=cols.device)
    for k in range(exi.shape[-1]):
        si = torch.where(exi[..., k, None] == cols,
                         exv[..., k, None].to(dtype), si)
    return si


def pair_rowblock(xi, qi, ti, exi, exv, rowvalid, i0, x, q, type_idx,
                  tables: PairTables, *, box, periodic, cutoff, g_ewald,
                  qqr2e):
    """LJ + real-space Ewald Coulomb of one block of rows against all atoms
    (JAX ``ops/pairs.py`` ``pair_rowblock``): xi (B, 3), qi (B,), ti (B,)
    the rows' positions, charges and types, global ids i0 .. i0 + B - 1;
    ``exi``/``exv`` (B, m) their special-bond lists (or None), applied per
    pair through ``special_factors``; ``rowvalid`` (B,) bool, or None when
    every row is an atom.  Returns (f_rows (B, 3), evdwl, ecoul) with the
    energies halved for the double count."""
    n = x.shape[0]
    dtype = x.dtype
    cutsq = cutoff * cutoff
    cols = torch.arange(n, device=x.device)
    dx = min_image(xi[:, None, :] - x[None, :, :], box, periodic)
    rsq = torch.sum(dx * dx, dim=-1)
    rid = torch.arange(i0, i0 + xi.shape[0], device=x.device)
    inrange = (rsq < cutsq) & (rid[:, None] != cols[None, :])
    if rowvalid is not None:
        inrange = inrange & rowvalid[:, None]
    if exi is None:
        si = torch.ones_like(rsq)
    else:
        si = special_factors(exi, exv, cols[None, :], dtype)
    rsq_safe = torch.where(inrange, rsq, torch.ones_like(rsq))
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    lj_on = inrange & (si > 0.0)
    tij = (ti[:, None], type_idx[None, :])
    l1, l2 = tables.lj1[tij], tables.lj2[tij]
    l3, l4 = tables.lj3[tij], tables.lj4[tij]
    zero = torch.zeros_like(rsq)
    flj = torch.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv, zero)
    elj = torch.where(lj_on, si * r6inv * (l3 * r6inv - l4), zero)
    r = torch.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = torch.exp(-grij * grij)
    t = 1.0 / (1.0 + 0.3275911 * grij)
    erfc = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429)))) * expm2
    prefactor = qqr2e * qi[:, None] * q[None, :] / r
    fcoul = prefactor * (erfc + EWALD_F * grij * expm2)
    fcoul = fcoul - (1.0 - si) * prefactor
    ecoul_pair = prefactor * erfc - (1.0 - si) * prefactor
    fcoul = torch.where(inrange, fcoul, zero)
    ecoul_pair = torch.where(inrange, ecoul_pair, zero)
    fpair = flj + fcoul * r2inv             # F/r
    return (torch.einsum("bn,bnc->bc", fpair, dx), 0.5 * torch.sum(elj),
            0.5 * torch.sum(ecoul_pair))


def dense_pair_forces(x, q, type_idx, tables: PairTables, exclusions, *,
                      box, periodic, cutoff, g_ewald, qqr2e, block=512):
    """All-pairs LJ + real-space Ewald Coulomb over row blocks
    (``pair_rowblock`` per block).

    exclusions: (excl_idx, excl_val) tensors from
    models.system.exclusion_lists, or None when the system has none.
    Returns (forces (N,3), evdwl, ecoul)."""
    n = x.shape[0]
    fs = []
    ev = torch.zeros((), dtype=x.dtype, device=x.device)
    ec = torch.zeros((), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        ex = (None, None) if exclusions is None else (
            exclusions[0][i0:i1], exclusions[1][i0:i1])
        f_rows, ev_b, ec_b = pair_rowblock(
            x[i0:i1], q[i0:i1], type_idx[i0:i1], *ex, None, i0, x, q,
            type_idx, tables, box=box, periodic=periodic, cutoff=cutoff,
            g_ewald=g_ewald, qqr2e=qqr2e)
        fs.append(f_rows)
        ev = ev + ev_b
        ec = ec + ec_b
    return torch.cat(fs, dim=0), ev, ec


def conp_correction_forces(x, q, ele_idx, elyte_mask, pair_force_fn,
                           pair_potential_fn, type_idx, *, box, periodic,
                           cutoff, qqr2e, block=512):
    """Gaussian correction force on electrode<->electrolyte pairs.

    Only the (Ne x N) electrode-row block is swept; the electrolyte side
    comes from the same block's column sums (Newton's third law).  The
    plain version of K6 (``ops/kernels/ele_rows_kernel.conp_correction``).
    pair_force_fn/pair_potential_fn: (rsq, itype, jtype) -> kernel value
    (ETA: fix_conp.cpp:1472-1480).  Returns (forces (N,3), ecorr)."""
    n = x.shape[0]
    f = torch.zeros_like(x)
    ecorr = torch.zeros((), dtype=x.dtype, device=x.device)
    ne = ele_idx.shape[0]
    for e0 in range(0, ne, block):
        eb = ele_idx[e0:e0 + block]
        xi, qi, ti = x[eb], q[eb], type_idx[eb]
        dx = min_image(xi[:, None, :] - x[None, :, :], box, periodic)
        # ((dx^2 + dy^2) + dz^2), K6's order: both agree on the pair set
        rsq = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
               + dx[..., 2] * dx[..., 2])
        mask = elyte_mask[None, :] & (rsq < cutoff * cutoff)
        rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
        prefactor = qqr2e * qi[:, None] * q[None, :]
        fk = pair_force_fn(rsq_safe, ti[:, None], type_idx[None, :])
        ek = pair_potential_fn(rsq_safe, ti[:, None], type_idx[None, :])
        zero = torch.zeros_like(rsq)
        forcecoul = torch.where(mask, prefactor * fk, zero)
        epair = torch.where(mask, prefactor * ek, zero)
        fpair = forcecoul / rsq_safe
        f = f - torch.einsum("en,enc->nc", fpair, dx)
        f = f.index_add(0, eb, torch.einsum("en,enc->ec", fpair, dx))
        ecorr = ecorr + torch.sum(epair)
    return f, ecorr


def eta_pair_kernels(eta: float):
    """ETA-mode kernels (single Gaussian width).

    potential: -erfc(eta r)/r   force: -(erfc(eta r)/r + 2 eta/sqrt(pi) e^-..)
    (fix_conp.cpp:1472-1480).  The A-matrix variant uses eta/sqrt(2)
    (fix_conp.cpp:1467-1470)."""
    def potential(rsq, itype, jtype):
        return -erfcr_sqrt(eta * eta * rsq) * eta

    def force(rsq, itype, jtype):
        return -ferfcr_sqrt(eta * eta * rsq) * eta

    def potential_A(rsq, itype, jtype):
        e2 = eta * eta * rsq / 2.0
        return -erfcr_sqrt(e2) * eta / math.sqrt(2.0)

    return potential, force, potential_A


def gauss_table_kernels(eta_ij: torch.Tensor, fo_ij: torch.Tensor):
    """(potential, force) of the shared ETA/EHGO parameterization over
    per-type-pair width and overlap tables (fix_conp.cpp:1560-1573):

        potential(rsq) = fo * exp(-e2/2) - erfcr(e2) * eta     e2 = eta^2 rsq
        force(rsq)     = e2 * fo * exp(-e2/2) - ferfcr(e2) * eta

    ETA is uniform eta with fo = 0."""
    def potential(rsq, itype, jtype):
        et, fo = eta_ij[itype, jtype], fo_ij[itype, jtype]
        e2 = et * et * rsq
        return fo * torch.exp(-0.5 * e2) - erfcr_sqrt(e2) * et

    def force(rsq, itype, jtype):
        et, fo = eta_ij[itype, jtype], fo_ij[itype, jtype]
        e2 = et * et * rsq
        return e2 * fo * torch.exp(-0.5 * e2) - ferfcr_sqrt(e2) * et

    return potential, force


def ehgo_pair_kernels(eta_ij: torch.Tensor, fo_ij: torch.Tensor):
    """EHGO-mode kernels with per-type-pair widths and overlap term
    (fix_conp.cpp:1560-1573), (potential, force, potential_A): the table
    kernels of ``gauss_table_kernels``, whose lookups gather the (T+1,
    T+1) tables by type; the A matrix's off-diagonal uses the same
    potential."""
    potential, force = gauss_table_kernels(eta_ij, fo_ij)
    return potential, force, potential


def build_ehgo_tables(ntypes: int, kappa: float, coeffs, evscale: float):
    """eta_ij combination rules and fo_ij overlap prefactors
    (FixConp::ehgo_setup_tables, fix_conp.cpp:1517-1551), float64 on the
    host.  coeffs: iterable of (type, eta, u0_or_None); u0 None -> 'auto'
    = sqrt(2/pi)*eta/evscale, stored internally *evscale
    (fix_conp.cpp:1504-1506).  Returns (eta_i, u0_i, eta_ij, fo_ij) as
    numpy arrays indexed by type (ntypes+1)."""
    s2pis = math.sqrt(2.0) / math.sqrt(math.pi)
    eta_i = np.zeros(ntypes + 1)
    u0_i = np.zeros(ntypes + 1)
    for (t, eta_one, u0_one) in coeffs:
        eta_i[t] = eta_one
        u0 = s2pis * eta_one / evscale if u0_one is None else u0_one
        u0_i[t] = u0 * evscale
    if not (eta_i.any() or u0_i.any()):
        raise ValueError("no EHGO settings found")
    f_i = u0_i - s2pis * eta_i
    eta_ij = np.zeros((ntypes + 1, ntypes + 1))
    fo_ij = np.zeros((ntypes + 1, ntypes + 1))
    sq8 = math.sqrt(8.0)
    for i in range(1, ntypes + 1):
        for j in range(1, i + 1):
            if eta_i[i] and eta_i[j]:
                etasq = eta_i[i] ** 2 + eta_i[j] ** 2
                etaprod = eta_i[i] * eta_i[j]
                eta_ij[i, j] = etaprod / math.sqrt(etasq)
                o_ij = sq8 * eta_ij[i, j] ** 3 / (etaprod * math.sqrt(etaprod))
                fo_ij[i, j] = 0.5 * kappa * (f_i[i] + f_i[j]) * o_ij
            else:
                eta_ij[i, j] = eta_i[i] + eta_i[j]
            eta_ij[j, i] = eta_ij[i, j]
            fo_ij[j, i] = fo_ij[i, j]
    return eta_i, u0_i, eta_ij, fo_ij


def exclusions_tensors(excl, *, device=None, dtype=torch.float64
                       ) -> Optional[tuple]:
    """(excl_idx, excl_val) as tensors, or None when no pair is listed."""
    idx, val = excl
    if not (np.asarray(idx) < idx.shape[0]).any():
        return None
    return (torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(val, dtype=dtype, device=device))
