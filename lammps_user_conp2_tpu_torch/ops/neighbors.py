"""Verlet neighbor lists with skin: the large-N pair path.

A per-atom (N, K) list of the neighbours within cutoff + skin, compacted
from the 27-cell candidates with one sort of packed (id << 5 | type) keys
per row, and rebuilt when any atom has moved more than skin/2 (LAMMPS
``neigh_modify check yes``).  Rows come out in ascending neighbour id, so
the list is the JAX package's list element for element.

The block form groups B = 8 cell-sorted atoms whose rows share one
sorted-unique union of width U (int32 ids): the sweep over it
(``block_pair_forces``) reads each union member once for all B atoms.  On CUDA float32 that sweep is the
CUDA kernel ``csrc/block_pair.cu`` (``ops/kernels/block_pair.py``), with
the CONP Gaussian correction fused in; elsewhere the per-atom sweep
``nlist_pair_forces`` and the electrode-row correction run in plain
PyTorch, as in the JAX engine.  Both sweeps apply special-bond exclusions
per pair (the JAX package subtracts them after an s = 1 sweep, which
cancels catastrophically in float32 at bonded distances).

Capacity (K, U, cell cap) is sized from the positions at set-up; an
overflow NaN-poisons the forces and energies through the sticky
``overflow`` flag, and ``Engine.run`` regrows the capacity and re-runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .cells import (TYPE_BITS, CellGrid, bin_atoms, build_cell_grid,
                    candidate_columns, neighbor_cells)
from .erfc import A1, A2, A3, A4, A5, EWALD_F, EWALD_P, erfcr_sqrt
from .kernels.block_pair import block_pair
from .pairs import PairTables, min_image, special_factors

# the neighbour's atom type in the packed sort key (cells.TYPE_BITS bits)
TYPE_MASK = (1 << TYPE_BITS) - 1
# atom rows per chunk of the rebuild sweep: bounds the (chunk, 27 cap, 3)
# displacement transient
ROW_CHUNK = 8192


@dataclasses.dataclass
class NeighborList:
    """One list build.  The block fields are None unless
    ``NeighborConfig.block`` > 0."""
    idx: torch.Tensor                    # (N, K) neighbour ids, padded with N
    x_ref: torch.Tensor                  # (N, 3) positions at build time
    lj: Optional[torch.Tensor]           # (4, N, K) LJ coefficient planes
    overflow: torch.Tensor               # () bool: K, U or cell cap exceeded
    bun: Optional[torch.Tensor] = None   # (NB, U) int32 union ids, pad N
    brows: Optional[torch.Tensor] = None  # (NB, B) block atom ids, pad N
    binv: Optional[torch.Tensor] = None  # (N,) atom -> flat block slot


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static list parameters; grid cells have edge >= cutoff + skin."""
    grid: CellGrid
    k_max: int
    cutoff: float           # force cutoff (list radius = grid.cutoff)
    skin: float
    block: int = 0          # i-block size B (0 = no block list)
    u_max: int = 0          # union width U per block


def make_neighbor_config(box, box_lo, cutoff, natoms, *, periodic, skin=1.0,
                         k_max=None, density_safety=3.0, x0=None, block=0,
                         u_max=None, device=None) -> NeighborConfig:
    """Cell grid and capacities.  With ``x0`` (numpy), the cell capacity is
    1.3x and K 1.5x the exact maxima at x0 (lane-rounded), as in the JAX
    package; the maxima are counted on ``device``."""
    grid = build_cell_grid(box, box_lo, cutoff + skin, natoms,
                           periodic=periodic, density_safety=density_safety)
    if x0 is not None:
        occ = _max_cell_occupancy(grid, np.asarray(x0))
        cap = int(np.ceil(occ * 1.3 / 8.0) * 8) + 8
        grid = dataclasses.replace(grid, cap=min(cap, natoms))
    if k_max is None:
        if x0 is not None:
            xt = torch.as_tensor(np.asarray(x0), dtype=torch.float64,
                                 device=device)
            nmax = count_max_neighbors(grid, xt)
            k_max = int(np.ceil(nmax * 1.5 / 8.0) * 8) + 8
        else:
            rho = natoms / (box[0] * box[1] * box[2])
            nexp = rho * 4.0 / 3.0 * np.pi * (cutoff + skin) ** 3
            k_max = int(np.ceil(nexp * 1.6 / 8.0) * 8) + 8
    if block and u_max is None:
        u_max = int(np.ceil(2.4 * k_max * (block / 8.0) ** 0.585 / 8.0) * 8)
    return NeighborConfig(grid=grid, k_max=int(k_max), cutoff=float(cutoff),
                          skin=float(skin), block=int(block),
                          u_max=int(u_max or 0))


def _max_cell_occupancy(grid: CellGrid, x: np.ndarray) -> int:
    """Host max atoms per cell at positions x (the binning of bin_atoms)."""
    ids = []
    for ax, nc in enumerate(grid.ncells):
        u = (x[:, ax] - grid.box_lo[ax]) / grid.box[ax]
        if grid.periodic[ax]:
            u = u - np.floor(u)
        ids.append(np.clip((u * nc).astype(np.int64), 0, nc - 1))
    cx, cy, cz = grid.ncells
    cell = (ids[0] * cy + ids[1]) * cz + ids[2]
    return int(np.bincount(cell, minlength=grid.total).max())


def count_max_neighbors(grid: CellGrid, x, cell_chunk: int = 256) -> int:
    """Exact max per-atom neighbour count within grid.cutoff at x, swept
    over chunks of cells (the whole candidate cube is GBs at 100k atoms)."""
    n = x.shape[0]
    table, cols, _ = candidate_columns(grid, x)
    xp = torch.cat([x, torch.full((1, 3), 1e6, dtype=x.dtype,
                                  device=x.device)])
    best = 0
    for c0 in range(0, table.shape[0], cell_chunk):
        tb, cb = table[c0:c0 + cell_chunk], cols[c0:c0 + cell_chunk]
        d = min_image(xp[tb][:, :, None, :] - xp[cb][:, None, :, :],
                      grid.box, grid.periodic)
        rsq = torch.sum(d * d, dim=-1)
        inr = ((tb[:, :, None] != cb[:, None, :]) & (tb[:, :, None] < n)
               & (cb[:, None, :] < n) & (rsq < grid.cutoff ** 2))
        best = max(best, int(inr.sum(dim=2).max()))
    return best


def build_neighbor_list(ncfg: NeighborConfig, x, tables: PairTables,
                        type_idx) -> NeighborList:
    """Compact the 27-cell candidates into (N, K) rows with ONE sort per
    row of packed (id << TYPE_BITS | type) keys: in-range candidates sort
    to the front in ascending id; out-of-range ones carry the ``miss`` key
    (id N + 1) and decode to the pad id N.  Atom-major: each row chunk
    gathers its atoms' cell candidate rows."""
    prep = nlist_prep(ncfg, x, type_idx)
    keys, ovf = row_keys(ncfg, x, prep, 0, x.shape[0])
    return list_from_keys(ncfg, x, prep, keys, ovf, tables, type_idx)


def nlist_prep(ncfg: NeighborConfig, x, type_idx):
    """The replicated inputs of a rebuild (JAX ``_nlist_prep``): (cell of
    each atom, binning overflow, packed (id, type) candidate columns (C,
    27 cap) and their positions (C, 27 cap, 3))."""
    grid = ncfg.grid
    n = x.shape[0]
    dev = x.device
    table, cell, overflow = bin_atoms(grid, x)
    nb, uniq = neighbor_cells(grid, dev)
    tp = torch.cat([type_idx.to(torch.int64),
                    torch.zeros(1, dtype=torch.int64, device=dev)])
    ptab = (table << TYPE_BITS) | tp[table]              # packed (id, type)
    xp = torch.cat([x, torch.full((1, 3), 1e6, dtype=x.dtype, device=dev)])
    m = 27 * table.shape[1]
    pcols = torch.where(uniq[:, :, None], ptab[nb],
                        n << TYPE_BITS).reshape(-1, m)   # (C, m)
    xj = xp[table][nb].reshape(-1, m, 3)                 # (C, m, 3)
    return cell, overflow, pcols, xj


def row_keys(ncfg: NeighborConfig, x, prep, r0: int, r1: int):
    """The sorted packed keys of the atom rows [r0, r1), (r1 - r0, K), in
    ``ROW_CHUNK`` chunks, and their () bool K overflow.  A row's keys
    depend on that row alone, so ranks that split the rows and gather the
    keys get the one-rank list bit for bit (the sharded rebuild, in place
    of JAX ``_cell_block_keys``, ``_scatter_rows`` and the ``pmin``)."""
    grid = ncfg.grid
    n = x.shape[0]
    k = ncfg.k_max
    dev = x.device
    cell, _, pcols, xj = prep
    miss = (n + 1) << TYPE_BITS
    rlistsq = grid.cutoff ** 2
    keys = torch.full((r1 - r0, k), miss, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for c0 in range(r0, r1, ROW_CHUNK):
        c1 = min(r1, c0 + ROW_CHUNK)
        cb = cell[c0:c1]
        pc = pcols[cb]                                   # (chunk, m)
        d = min_image(x[c0:c1, None, :] - xj[cb], grid.box, grid.periodic)
        rsq = torch.sum(d * d, dim=-1)
        colsb = pc >> TYPE_BITS
        rb = torch.arange(c0, c1, device=dev)
        inr = (colsb != rb[:, None]) & (colsb < n) & (rsq < rlistsq)
        sk = torch.sort(torch.where(inr, pc, miss), dim=1).values[:, :k]
        keys[c0 - r0:c1 - r0, :sk.shape[1]] = sk
        ovf = ovf | (torch.max(torch.sum(inr, dim=1)) > k)
    return keys, ovf


def list_from_keys(ncfg: NeighborConfig, x, prep, keys, ovf,
                   tables: PairTables, type_idx) -> NeighborList:
    """The list from every row's keys: decoded, with the block form
    attached when ``ncfg.block``."""
    cell, overflow = prep[0], prep[1]
    nlist = _decode_list(ncfg, x, keys, overflow | ovf, type_idx, tables,
                         build_lj=not ncfg.block)
    if ncfg.block:
        nlist = _attach_block_list(ncfg, x, nlist, cell)
    return nlist


def _decode_list(ncfg, x, sk, overflow, type_idx, tables: PairTables,
                 build_lj=True) -> NeighborList:
    """(N, K) packed keys -> NeighborList.  ``build_lj=False`` skips the
    (4, N, K) coefficient planes, which the block sweep never reads."""
    n = x.shape[0]
    miss = (n + 1) << TYPE_BITS
    idx = torch.where(sk < miss, sk >> TYPE_BITS, n)
    if not build_lj:
        return NeighborList(idx=idx, x_ref=x, lj=None, overflow=overflow)
    nt1 = tables.lj1.shape[0]
    if nt1 > (1 << TYPE_BITS):
        raise ValueError(f"{nt1} atom types exceed the packed-key budget "
                         f"({1 << TYPE_BITS})")
    tj = sk & TYPE_MASK                                  # 0 on misses
    ti = type_idx.to(torch.int64)[:, None]
    lj = torch.stack([t[ti, tj] for t in tables]).to(x.dtype)
    return NeighborList(idx=idx, x_ref=x, lj=lj, overflow=overflow)


def _block_union_sorted(ncfg: NeighborConfig, x, idx, cell):
    """Cell-sorted block rows, the ascending sort of each block's
    concatenated (B*K) neighbour rows, its first-occurrence mask, and the
    per-block unique counts."""
    n = x.shape[0]
    B, k = ncfg.block, idx.shape[1]
    dev = x.device
    perm = torch.argsort(cell, stable=True)              # cell-sorted atoms
    nb_ = -(-n // B)
    rows = torch.cat([perm, torch.full((nb_ * B - n,), n, dtype=torch.int64,
                                       device=dev)]).reshape(nb_, B)
    idxp = torch.cat([idx, torch.full((1, k), n, dtype=idx.dtype,
                                      device=dev)])
    su = torch.sort(idxp[rows].reshape(nb_, B * k), dim=1).values
    first = torch.ones_like(su, dtype=torch.bool)
    first[:, 1:] = su[:, 1:] != su[:, :-1]
    first = first & (su < n)
    return perm, rows, su, first, torch.sum(first, dim=1)


def max_union_count(ncfg: NeighborConfig, x, nlist: NeighborList) -> int:
    """Exact max block-union width at positions x (sizes u_max)."""
    _, cell, _ = bin_atoms(ncfg.grid, x)
    return int(torch.max(_block_union_sorted(ncfg, x, nlist.idx, cell)[4]))


def _attach_block_list(ncfg: NeighborConfig, x, nlist: NeighborList,
                       cell) -> NeighborList:
    """Block form of the list: i-blocks of B consecutive cell-sorted atoms
    share the sorted-unique union of their rows (ascending ids, padded with
    N to width U).  A union wider than U sets the overflow flag."""
    n = x.shape[0]
    U = ncfg.u_max
    perm, rows, su, first, cnt = _block_union_sorted(ncfg, x, nlist.idx,
                                                     cell)
    ovf = torch.max(cnt) > U
    uvals = torch.sort(torch.where(first, su, n), dim=1).values
    if uvals.shape[1] < U:
        uvals = torch.nn.functional.pad(uvals, (0, U - uvals.shape[1]),
                                        value=n)
    # int32: half the bytes K1 reads per step
    un = torch.where(torch.arange(U, device=x.device)[None, :] < cnt[:, None],
                     uvals[:, :U], n).to(torch.int32)
    binv = torch.empty(n, dtype=torch.int64, device=x.device)
    binv[perm] = torch.arange(n, device=x.device)
    return dataclasses.replace(nlist, bun=un, brows=rows, binv=binv,
                               overflow=nlist.overflow | ovf)


def needs_rebuild(ncfg: NeighborConfig, nlist: NeighborList, x):
    """() bool: some atom moved more than skin/2 since the list was built."""
    disp = x - nlist.x_ref
    return torch.max(torch.sum(disp * disp, dim=1)) > (0.5 * ncfg.skin) ** 2


def nlist_pair_rows(ncfg: NeighborConfig, x, q, xi, qi, idx_rows, lj_rows, *,
                    g_ewald, qqr2e, excl_rows=None):
    """Verlet-list sweep over a block of rows: (f_rows (nrow, 3), ev, ec)
    with the 0.5 full-list energy factor applied.  ``excl_rows``: the rows'
    (excl_idx, excl_val), applied per pair (LJ scaled by s, the Coulomb
    term minus (1 - s) qq/r), or None."""
    n = x.shape[0]
    sent = torch.zeros((1, 4), dtype=x.dtype, device=x.device)
    sent[:, :3] = 1e6                                    # the pad row
    xqp = torch.cat([torch.cat([x, q[:, None].to(x.dtype)], dim=1), sent])
    xqj = xqp[idx_rows]
    d = min_image(xi[:, None, :] - xqj[..., :3], ncfg.grid.box,
                  ncfg.grid.periodic)
    rsq = torch.sum(d * d, dim=-1)
    mask = (idx_rows < n) & (rsq < ncfg.cutoff ** 2)
    zero = torch.zeros_like(rsq)
    rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv * r2inv * r2inv
    si = (torch.ones_like(rsq) if excl_rows is None
          else special_factors(*excl_rows, idx_rows, x.dtype))
    lj_on = mask & (si > 0.0)
    l1, l2, l3, l4 = lj_rows
    flj = torch.where(lj_on, si * r6inv * (l1 * r6inv - l2) * r2inv, zero)
    elj = torch.where(lj_on, si * r6inv * (l3 * r6inv - l4), zero)
    r = torch.sqrt(rsq_safe)
    grij = g_ewald * r
    expm2 = torch.exp(-grij * grij)
    tt = 1.0 / (1.0 + EWALD_P * grij)
    erfc = tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2
    pref = qqr2e * qi[:, None] * xqj[..., 3] / r
    dcoul = (1.0 - si) * pref
    fcoul = torch.where(mask, pref * (erfc + EWALD_F * grij * expm2) - dcoul,
                        zero)
    ecoul = torch.where(mask, pref * erfc - dcoul, zero)
    fpair = flj + fcoul * r2inv
    f_rows = torch.sum(fpair[:, :, None] * d, dim=1)
    return f_rows, 0.5 * torch.sum(elj), 0.5 * torch.sum(ecoul)


def _poison(nlist, x, f, ev, ec):
    """The overflow poison shared by the sweeps: (f, ev, ec, overflow)."""
    ov = nlist.overflow
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return (torch.where(ov, nan, f), torch.where(ov, nan, ev),
            torch.where(ov, nan, ec), ov)


def nlist_pair_forces(ncfg: NeighborConfig, nlist: NeighborList, x, q,
                      type_idx, tables: PairTables, exclusions, *, g_ewald,
                      qqr2e):
    """LJ + real-space Coulomb from the per-atom list: (f, evdwl, ecoul,
    overflow).  Each pair sits in both atoms' rows: energies carry 0.5.
    ``exclusions``: (excl_idx, excl_val) applied per pair, or None."""
    f, ev, ec = nlist_pair_rows(ncfg, x, q, x, q, nlist.idx, nlist.lj,
                                g_ewald=g_ewald, qqr2e=qqr2e,
                                excl_rows=exclusions)
    return _poison(nlist, x, f, ev, ec)


def block_pair_forces(ncfg: NeighborConfig, nlist: NeighborList, x, q,
                      type_idx, tables: PairTables, exclusions, *, g_ewald,
                      qqr2e, conp_fuse=None):
    """LJ + real-space Coulomb from the BLOCK form of the list, the same
    pair set as ``nlist_pair_forces``: (f, evdwl, ecoul[, ecorr],
    overflow).  ``conp_fuse`` = (ele_f, ely_f, eta_tab, fo_tab) folds the
    CONP Gaussian correction into the sweep; every (ele, elyte) pair then
    appears in both atoms' rows, so ecorr carries the 0.5 too."""
    out = _block_sweep(ncfg, x, q, nlist.bun, nlist.brows, type_idx, tables,
                       g_ewald=g_ewald, qqr2e=qqr2e, conp_fuse=conp_fuse,
                       exclusions=exclusions)
    res = _poison(nlist, x, out[0][nlist.binv], 0.5 * out[1], 0.5 * out[2])
    if conp_fuse is None:
        return res
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return res[:3] + (torch.where(res[3], nan, 0.5 * out[3]), res[3])


def _block_sweep(ncfg: NeighborConfig, x, q, un, rows, type_idx,
                 tables: PairTables, *, g_ewald, qqr2e, conp_fuse=None,
                 exclusions=None):
    """(f_slots (NB*B, 3) in slot order, sum_elj, sum_ecoul[, sum_ecorr]),
    raw sums over the ordered pairs with the exclusions applied per pair:
    the caller applies binv and the 0.5.  K1 on CUDA float32, its plain
    version on the CPU."""
    return block_pair(x, q, type_idx, un, rows, tables, box=ncfg.grid.box,
                      periodic=ncfg.grid.periodic, cutoff=ncfg.cutoff,
                      g_ewald=g_ewald, qqr2e=qqr2e, conp_fuse=conp_fuse,
                      exclusions=exclusions)


def ele_rows_from_list(nlist: NeighborList, ele_idx):
    """(Ne, K) neighbour ids of the electrode rows."""
    return nlist.idx[ele_idx]


def _ele_geometry(ncfg, nlist, x, ele_idx, elyte_mask, type_idx, cutsq):
    """Shared prologue of the electrode-row sweeps over the list."""
    n = x.shape[0]
    idx_e = ele_rows_from_list(nlist, ele_idx)           # (Ne, K)
    xp = torch.cat([x, torch.full((1, 3), 1e6, dtype=x.dtype,
                                  device=x.device)])
    elyp = torch.cat([elyte_mask, torch.zeros(1, dtype=torch.bool,
                                              device=x.device)])
    tp = torch.cat([type_idx, torch.zeros(1, dtype=type_idx.dtype,
                                          device=x.device)])
    d = min_image(x[ele_idx][:, None, :] - xp[idx_e], ncfg.grid.box,
                  ncfg.grid.periodic)
    rsq = torch.sum(d * d, dim=-1)
    mask = (idx_e < n) & elyp[idx_e] & (rsq < cutsq)
    rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
    return idx_e, d, mask, rsq_safe, type_idx[ele_idx][:, None], tp[idx_e]


def b_realspace_from_list(ncfg: NeighborConfig, nlist: NeighborList, x,
                          q_elyte, ele_idx, elyte_mask, type_idx,
                          pair_potential_fn, *, g_ewald, cut_coulsq):
    """b real-space rows from the electrode rows of the list:
    b_i = -sum_j (erfc(g r)/r + pot(r)) q_j over in-range electrolyte
    neighbours (fix_conp.cpp:1281-1365), O(Ne K)."""
    idx_e, _, mask, rsq_safe, te, tj = _ele_geometry(
        ncfg, nlist, x, ele_idx, elyte_mask, type_idx, cut_coulsq)
    qep = torch.cat([q_elyte, torch.zeros(1, dtype=q_elyte.dtype,
                                          device=x.device)])
    dudq = (erfcr_sqrt(g_ewald * g_ewald * rsq_safe) * g_ewald
            + pair_potential_fn(rsq_safe, te, tj))
    b = -torch.sum(torch.where(mask, dudq, torch.zeros_like(dudq))
                   * qep[idx_e], dim=1)
    return torch.where(nlist.overflow, torch.full_like(b, float("nan")), b)


def conp_correction_from_list(ncfg: NeighborConfig, nlist: NeighborList, x,
                              q, ele_idx, elyte_mask, type_idx, pair_force_fn,
                              pair_potential_fn, *, cutoff, qqr2e):
    """Gaussian correction from the electrode rows of the list
    (blist_coul_cal_post_force, fix_conp.cpp:1368-1444): forces on the
    electrode rows plus the Newton reactions on their electrolyte
    neighbours.  Returns (f (N, 3), ecorr).  The list is full, so each
    electrolyte atom sums its reactions over its own row, in the row's
    order: a scatter of them would add with atomics on the card, in an
    order that changes from run to run."""
    n = x.shape[0]
    idx_e, d, mask, rsq_safe, te, tj = _ele_geometry(
        ncfg, nlist, x, ele_idx, elyte_mask, type_idx, cutoff ** 2)
    qp = torch.cat([q, torch.zeros(1, dtype=q.dtype, device=x.device)])
    pref = qqr2e * q[ele_idx][:, None] * qp[idx_e]
    zero = torch.zeros_like(rsq_safe)
    forcecoul = torch.where(mask, pref * pair_force_fn(rsq_safe, te, tj), zero)
    epair = torch.where(mask, pref * pair_potential_fn(rsq_safe, te, tj), zero)
    f_ele = torch.sum((forcecoul / rsq_safe)[:, :, None] * d, dim=1)
    # the reactions: row j of the list holds the electrodes that hold j
    idx = nlist.idx
    is_ele = torch.zeros(n + 1, dtype=torch.bool,
                         device=x.device).index_fill_(0, ele_idx, True)
    xp = torch.cat([x, torch.full((1, 3), 1e6, dtype=x.dtype,
                                  device=x.device)])
    tp = torch.cat([type_idx, torch.zeros(1, dtype=type_idx.dtype,
                                          device=x.device)])
    dr = min_image(x[:, None, :] - xp[idx], ncfg.grid.box, ncfg.grid.periodic)
    rsq = torch.sum(dr * dr, dim=-1)
    mask_r = is_ele[idx] & elyte_mask[:, None] & (rsq < cutoff ** 2)
    rsq_r = torch.where(mask_r, rsq, torch.ones_like(rsq))
    fc_r = torch.where(mask_r, qqr2e * qp[idx] * q[:, None] * pair_force_fn(
        rsq_r, tp[idx], type_idx[:, None]), torch.zeros_like(rsq))
    f = torch.sum((fc_r / rsq_r)[:, :, None] * dr, dim=1)
    # one add per electrode row: the rows are distinct
    f = f.index_add(0, ele_idx, f_ele)
    return (torch.where(nlist.overflow, torch.full_like(f, float("nan")), f),
            torch.sum(epair))


# ---------------------------------------------------------------------------
# the sharded step's shares of the list sweeps (parallel/sharded.py)
# ---------------------------------------------------------------------------

def pad_block_list(nlist: NeighborList, n: int, d: int) -> NeighborList:
    """The block axis padded to a multiple of ``d`` with empty blocks (rows
    and union ids N), which add nothing to the sweep, so that each of d
    ranks takes an equal contiguous slice (JAX ``pad_block_list``)."""
    padb = (-nlist.bun.shape[0]) % d
    if padb == 0:
        return nlist
    pad = torch.nn.functional.pad
    return dataclasses.replace(
        nlist, bun=pad(nlist.bun, (0, 0, 0, padb), value=n),
        brows=pad(nlist.brows, (0, 0, 0, padb), value=n))


def block_pair_rows(ncfg: NeighborConfig, nlist: NeighborList, x, q, b0: int,
                    nb_l: int, type_idx, tables: PairTables, exclusions, *,
                    g_ewald, qqr2e, conp_fuse=None):
    """The block sweep over the block slice [b0, b0 + nb_l) of a padded
    list (``pad_block_list``), K1 on CUDA float32: (f_slots (nb_l B, 3),
    evdwl, ecoul[, ecorr]) with the full list's 0.5 applied.  The caller
    gathers the slot forces of every slice and applies ``binv``."""
    sl = slice(b0, b0 + nb_l)
    out = _block_sweep(ncfg, x, q, nlist.bun[sl], nlist.brows[sl], type_idx,
                       tables, g_ewald=g_ewald, qqr2e=qqr2e,
                       conp_fuse=conp_fuse, exclusions=exclusions)
    return (out[0],) + tuple(0.5 * e for e in out[1:])


def conp_correction_rows_from_list(ncfg: NeighborConfig, nlist: NeighborList,
                                   x, q, eidx_rows, evalid, eslot,
                                   elyte_mask, type_idx, pair_force_fn,
                                   pair_potential_fn, *, cutoff, qqr2e):
    """A rank's share of ``conp_correction_from_list``: the correction of
    its electrode rows ``eidx_rows`` (padded rows, ``evalid`` False, add
    nothing) with their Newton reactions.  ``eslot`` (N + 1,) int64 maps
    an atom to its place in ``eidx_rows``, len(eidx_rows) for every other
    atom and for the pad id N.  Each electrolyte atom sums its reactions
    over its own row of the full list, restricted to this rank's
    electrodes, in the row's order (no scatter).  Returns (f (N, 3),
    ecorr); the shares sum to the whole."""
    n = x.shape[0]
    nr = eidx_rows.shape[0]
    idx_e, d, mask, rsq_safe, te, tj = _ele_geometry(
        ncfg, nlist, x, eidx_rows, elyte_mask, type_idx, cutoff ** 2)
    mask = mask & evalid[:, None]
    qp = torch.cat([q, torch.zeros(1, dtype=q.dtype, device=x.device)])
    pref = qqr2e * q[eidx_rows][:, None] * qp[idx_e]
    zero = torch.zeros_like(rsq_safe)
    forcecoul = torch.where(mask, pref * pair_force_fn(rsq_safe, te, tj), zero)
    epair = torch.where(mask, pref * pair_potential_fn(rsq_safe, te, tj), zero)
    f_ele = torch.sum((forcecoul / rsq_safe)[:, :, None] * d, dim=1)
    idx = nlist.idx
    mine = eslot[idx] < nr
    xp = torch.cat([x, torch.full((1, 3), 1e6, dtype=x.dtype,
                                  device=x.device)])
    tp = torch.cat([type_idx, torch.zeros(1, dtype=type_idx.dtype,
                                          device=x.device)])
    dr = min_image(x[:, None, :] - xp[idx], ncfg.grid.box, ncfg.grid.periodic)
    rsq = torch.sum(dr * dr, dim=-1)
    mask_r = mine & elyte_mask[:, None] & (rsq < cutoff ** 2)
    rsq_r = torch.where(mask_r, rsq, torch.ones_like(rsq))
    fc_r = torch.where(mask_r, qqr2e * qp[idx] * q[:, None] * pair_force_fn(
        rsq_r, tp[idx], type_idx[:, None]), torch.zeros_like(rsq))
    f = torch.sum((fc_r / rsq_r)[:, :, None] * dr, dim=1)
    # each electrode row's own force, gathered by atom (no scatter)
    f_ele = torch.cat([f_ele, torch.zeros((1, 3), dtype=x.dtype,
                                          device=x.device)])
    f = f + f_ele[eslot[:n]]
    return (torch.where(nlist.overflow, torch.full_like(f, float("nan")), f),
            torch.sum(epair))
