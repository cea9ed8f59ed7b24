"""Cell binning and the cell-list pair sweep (JAX ``ops/cells.py``).

A static cell decomposition with edge >= the cutoff (or the list radius),
atoms binned and ranked per cell with one sort, the 27-cell neighbor map
and the per-cell candidate matrix, which the Verlet list builds on; and
the cell pair path (``pair_path="cell"``): every cell's ``cap`` slots
against the slots of its 27 neighbor cells as one dense masked tile, full
lists with the 0.5 energy factor, swept in chunks of cells sized so that
one temporary of the chunk holds about ``CELL_CHUNK_BYTES``.  The JAX
package computes the sweep outside any Pallas kernel, so it is plain
PyTorch on every device; it launches a fixed set of kernels per chunk, so
it runs inside the step's CUDA graph.

Special-bond exclusions are applied per pair inside the sweep (each slot
carries its atom's list), as the dense, list and tile sweeps apply them;
``exclusion_correction`` is the JAX package's after-sweep convention,
kept so that a test can hold the two against each other in float64.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .erfc import A1, A2, A3, A4, A5, EWALD_F, EWALD_P
from .pairs import PairTables, min_image, special_factors

# bits of the atom type in an id << TYPE_BITS | type key (the cell sweep's
# slots, the Verlet list's sort keys)
TYPE_BITS = 5
# bytes of one (cells, cap, 27 cap) temporary of the cell sweep per chunk
CELL_CHUNK_BYTES = 1 << 30
# the position of an empty slot: out of range of every atom
SENTINEL = 1e6


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static cell decomposition (host-derived)."""
    ncells: tuple          # (cx, cy, cz)
    cap: int               # max atoms per cell
    box: tuple
    box_lo: tuple
    periodic: tuple
    cutoff: float

    @property
    def total(self):
        cx, cy, cz = self.ncells
        return cx * cy * cz


def build_cell_grid(box, box_lo, cutoff, natoms, *, periodic,
                    density_safety=3.0, cap=None) -> CellGrid:
    ns = tuple(max(1, int(b // cutoff)) for b in box)
    vol_cell = (box[0] / ns[0]) * (box[1] / ns[1]) * (box[2] / ns[2])
    mean_per_cell = natoms * vol_cell / (box[0] * box[1] * box[2])
    if cap is None:
        cap = int(math.ceil(mean_per_cell * density_safety)) + 8
    return CellGrid(ncells=ns, cap=cap, box=tuple(float(b) for b in box),
                    box_lo=tuple(float(b) for b in box_lo),
                    periodic=tuple(bool(p) for p in periodic),
                    cutoff=float(cutoff))


def bin_atoms(grid: CellGrid, x):
    """Returns (cell_table (C, cap) atom ids padded with N, cell (N,),
    overflow () bool).  Periodic axes wrap; the others clip (an atom past
    a slab wall bins at the boundary cell).  Past ``cap`` the atoms of a
    cell share its last slot and ``overflow`` is set."""
    n = x.shape[0]
    cx, cy, cz = grid.ncells
    ids = []
    for ax, nc in enumerate(grid.ncells):
        u = (x[:, ax] - grid.box_lo[ax]) / grid.box[ax]
        if grid.periodic[ax]:
            u = u - torch.floor(u)
        ids.append(torch.clamp((u * nc).to(torch.int64), 0, nc - 1))
    cell = (ids[0] * cy + ids[1]) * cz + ids[2]
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    # rank within the cell: position minus the cell's first position
    iota = torch.arange(n, device=x.device)
    changed = torch.ones(n, dtype=torch.bool, device=x.device)
    changed[1:] = cell_sorted[1:] != cell_sorted[:-1]
    rank = iota - torch.cummax(torch.where(changed, iota, 0), dim=0).values
    overflow = torch.max(rank) >= grid.cap
    table = torch.full((grid.total * grid.cap,), n, dtype=torch.int64,
                       device=x.device)
    slot = cell_sorted * grid.cap + torch.clamp(rank, max=grid.cap - 1)
    table[slot] = order
    return table.reshape(grid.total, grid.cap), cell, overflow


@functools.lru_cache(maxsize=8)
def _neighbor_cells(grid: CellGrid):
    """(C, 27) neighbor cell ids and the (C, 27) mask of first occurrences
    (host numpy): an axis with fewer than 3 cells repeats a neighbor, which
    must not be counted twice."""
    cx, cy, cz = grid.ncells
    idx = np.arange(cx * cy * cz)
    ix, iy, iz = idx // (cy * cz), (idx // cz) % cy, idx % cz
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                out.append((((ix + dx) % cx) * cy + (iy + dy) % cy) * cz
                           + (iz + dz) % cz)
    nb = np.stack(out, axis=1)
    uniq = np.ones_like(nb, dtype=bool)
    for k in range(1, 27):
        uniq[:, k] = ~(nb[:, :k] == nb[:, k:k + 1]).any(axis=1)
    return nb, uniq


def neighbor_cells(grid: CellGrid, device):
    """``_neighbor_cells`` as int64 / bool tensors on ``device``, copied
    once per grid and device: the list rebuild runs inside a CUDA graph,
    which cannot hold a copy from the host."""
    return _neighbor_cells_on(grid, str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _neighbor_cells_on(grid: CellGrid, device: str):
    nb, uniq = _neighbor_cells(grid)
    return (torch.as_tensor(nb, dtype=torch.int64, device=device),
            torch.as_tensor(uniq, device=device))


def candidate_columns(grid: CellGrid, x):
    """Bin atoms and build the per-cell candidate matrix.

    Returns (table (C, cap), cols (C, 27*cap) candidate atom ids with
    duplicate-cell slots masked to N, overflow)."""
    n = x.shape[0]
    table, _, overflow = bin_atoms(grid, x)
    nb, uniq = neighbor_cells(grid, x.device)
    cols = torch.where(uniq[:, :, None], table[nb], n)
    return table, cols.reshape(grid.total, 27 * grid.cap), overflow


def cell_slab_tables(grid: CellGrid, x, q, type_idx):
    """Slot-ordered per-cell tables for the slab sweep: (table (C, cap),
    xq (C, cap, 4) positions and charge, pt (C, cap) int64 (id <<
    TYPE_BITS) | type, overflow).  Empty slots hold id N, type 0, charge
    0 and the sentinel position."""
    n = x.shape[0]
    table, _, overflow = bin_atoms(grid, x)
    sentinel = torch.cat([x.new_full((1, 3), SENTINEL), x.new_zeros(1, 1)],
                         1)
    xqp = torch.cat([torch.cat([x, q[:, None].to(x.dtype)], 1), sentinel])
    tp = torch.cat([type_idx.to(torch.int64),
                    type_idx.new_zeros(1, dtype=torch.int64)])
    return table, xqp[table], (table << TYPE_BITS) | tp[table], overflow


def pad_slab_tables(grid: CellGrid, xq, pt, padc: int, n: int):
    """The slab tables and the neighbor map with ``padc`` empty cells
    appended (ids n, type 0, sentinel positions, no unique neighbor), so a
    pad cell contributes exactly nothing: (xq, pt, nb, uq)."""
    nb, uq = neighbor_cells(grid, xq.device)
    if padc:
        cap = xq.shape[1]
        xq = torch.cat([xq, xq.new_full((padc, cap, 4), SENTINEL)])
        pt = torch.cat([pt, pt.new_full((padc, cap), n << TYPE_BITS)])
        nb = torch.cat([nb, nb.new_zeros((padc, 27))])
        uq = torch.cat([uq, uq.new_zeros((padc, 27))])
    return xq, pt, nb, uq


def chunk_cells(cap: int, dtype) -> int:
    """Cells per chunk of the sweep: one (cells, cap, 27 cap) temporary of
    ``dtype`` within CELL_CHUNK_BYTES."""
    per = cap * 27 * cap * torch.finfo(dtype).bits // 8
    return max(1, CELL_CHUNK_BYTES // per)


def slot_exclusions(table, exclusions, n: int):
    """Each slot's special-bond list (ids (C, cap, m) padded with n,
    factors (C, cap, m)), from the atoms' (N, m) lists; None without."""
    if exclusions is None:
        return None
    exi, exv = exclusions
    m = exi.shape[1]
    exi = torch.cat([exi, exi.new_full((1, m), n)])
    exv = torch.cat([exv, exv.new_ones((1, m))])
    return exi[table], exv[table]


def sweep_cell_slabs(grid: CellGrid, tables: PairTables, xq, pt, nb, uq,
                     c0: int, ncells: int, *, g_ewald, qqr2e, n: int,
                     excl=None, chunk=None):
    """The cell-tile pair sweep over the row cells [c0, c0 + ncells) of the
    (padded) slab tables: each row cell's cap slots against the 27
    neighbor cells' slots, duplicate neighbor cells (an axis with fewer
    than 3 cells) masked through ``uq``.  ``excl``: the slots' special-bond
    lists (``slot_exclusions``) or None.  ``chunk``: row cells per chunk
    (default ``chunk_cells``).

    Returns (evdwl, ecoul, fslots (ncells, cap, 3)) with the 0.5 full-list
    energy factor applied.  Empty and duplicate candidate slots carry id
    n, self pairs are masked by id, sentinel rows by id < n."""
    dtype = xq.dtype
    cap = xq.shape[1]
    m = 27 * cap
    cutsq = grid.cutoff ** 2
    nt1 = tables.lj1.shape[0]
    tmask = (1 << TYPE_BITS) - 1
    chunk = chunk or chunk_cells(cap, dtype)
    # (T, 4, T): each row type's four LJ rows, read by a one-hot product
    # over the column type (exact: one nonzero term)
    tab4 = torch.stack(tuple(tables), dim=1).to(dtype)
    types = torch.arange(nt1, device=xq.device)
    ev = torch.zeros((), dtype=dtype, device=xq.device)
    ec = torch.zeros((), dtype=dtype, device=xq.device)
    frows = []
    for a in range(c0, c0 + ncells, chunk):
        b = min(a + chunk, c0 + ncells)
        B = b - a
        xqi, pti = xq[a:b], pt[a:b]
        nbc = nb[a:b]
        xqj = xq[nbc].reshape(B, m, 4)
        ptj = torch.where(uq[a:b, :, None], pt[nbc],
                          n << TYPE_BITS).reshape(B, m)
        idi, idj = pti >> TYPE_BITS, ptj >> TYPE_BITS
        d = []
        for ax in range(3):
            da = xqi[:, :, None, ax] - xqj[:, None, :, ax]
            if grid.periodic[ax]:
                L = grid.box[ax]
                da = da - L * torch.round(da / L)
            d.append(da)
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = ((rsq < cutsq) & (idi[:, :, None] != idj[:, None, :])
                & (idi[:, :, None] < n) & (idj[:, None, :] < n))
        rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
        del rsq
        r2inv = 1.0 / rsq_safe
        r6inv = r2inv * r2inv * r2inv
        ohj = ((ptj & tmask)[:, :, None] == types).to(dtype)     # (B, m, T)
        rows = tab4[pti & tmask].reshape(B, cap * 4, nt1)
        lj = torch.bmm(rows, ohj.transpose(1, 2)).reshape(B, cap, 4, m)
        del ohj, rows
        zero = torch.zeros((), dtype=dtype, device=xq.device)
        if excl is None:
            si = None
            lj_on = mask
            flj = torch.where(lj_on, r6inv * (lj[:, :, 0] * r6inv
                                              - lj[:, :, 1]) * r2inv, zero)
            elj = torch.where(lj_on, r6inv * (lj[:, :, 2] * r6inv
                                              - lj[:, :, 3]), zero)
        else:
            si = special_factors(excl[0][a:b], excl[1][a:b],
                                 idj[:, None, :], dtype)
            lj_on = mask & (si > 0.0)
            flj = torch.where(lj_on, si * r6inv * (lj[:, :, 0] * r6inv
                                                   - lj[:, :, 1]) * r2inv,
                              zero)
            elj = torch.where(lj_on, si * r6inv * (lj[:, :, 2] * r6inv
                                                   - lj[:, :, 3]), zero)
        del lj, r6inv, lj_on
        ev = ev + 0.5 * torch.sum(elj)
        del elj
        r = torch.sqrt(rsq_safe)
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        t = 1.0 / (1.0 + EWALD_P * grij)
        erfc = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2
        del t
        pref = qqr2e * xqi[:, :, None, 3] * xqj[:, None, :, 3] / r
        del r
        fcoul = pref * (erfc + EWALD_F * grij * expm2)
        ecoul = pref * erfc
        del grij, expm2, erfc
        if si is not None:
            fcoul = fcoul - (1.0 - si) * pref
            ecoul = ecoul - (1.0 - si) * pref
        del pref, si
        ec = ec + 0.5 * torch.sum(torch.where(mask, ecoul, zero))
        del ecoul
        fpair = flj + torch.where(mask, fcoul, zero) * r2inv
        del flj, fcoul, r2inv, mask
        frows.append(torch.stack([torch.sum(fpair * d[k], dim=2)
                                  for k in range(3)], dim=2))
        del fpair, d
    return ev, ec, torch.cat(frows)


def slot_forces_to_atoms(table, fslots, n: int):
    """The (N, 3) forces of the atoms from their slots' forces (C, cap, 3):
    a gather by each atom's own slot (no scatter-add); an atom left out
    of an overflowed table gets 0."""
    ns = table.numel()
    inv = torch.full((n + 1,), ns, dtype=torch.int64, device=table.device)
    inv[table.reshape(-1)] = torch.arange(ns, device=table.device)
    fz = torch.cat([fslots.reshape(ns, 3), fslots.new_zeros(1, 3)])
    return fz[inv[:n]]


def cell_pair_forces(grid: CellGrid, x, q, type_idx, tables: PairTables,
                     exclusions, *, g_ewald, qqr2e, chunk=None):
    """Cell-list LJ + real-space Coulomb, exclusions per pair: (f (N, 3),
    evdwl, ecoul, overflow), the returns of ``dense_pair_forces`` plus the
    cell overflow flag (the physics is wrong when it is set: the engine
    poisons the energy)."""
    n = x.shape[0]
    table, xq, pt, overflow = cell_slab_tables(grid, x, q, type_idx)
    nb, uq = neighbor_cells(grid, x.device)
    ev, ec, fslots = sweep_cell_slabs(
        grid, tables, xq, pt, nb, uq, 0, table.shape[0], g_ewald=g_ewald,
        qqr2e=qqr2e, n=n, excl=slot_exclusions(table, exclusions, n),
        chunk=chunk)
    return slot_forces_to_atoms(table, fslots, n), ev, ec, overflow


def exclusion_correction(x, q, type_idx, tables: PairTables, exclusions, *,
                         box, periodic, cutsq, qqr2e):
    """The JAX package's special-bond convention: (df (N, 3), devdwl,
    decoul) to add to a sweep that treated listed pairs as s = 1 (the
    Coulomb part keeps the k-space compensation, -erf(g r)/r).  Kept for
    the tests, which hold it against the per-pair factors in float64."""
    n = x.shape[0]
    exi, exv = exclusions
    me = exi.shape[1]
    rows = torch.arange(n, device=x.device).repeat_interleave(me)
    cols = exi.reshape(-1)
    sval = exv.reshape(-1).to(x.dtype)
    valid = cols < n
    cols_safe = torch.where(valid, cols, torch.zeros_like(cols))
    dx = min_image(x[rows] - x[cols_safe], box, periodic)
    rsq = torch.sum(dx * dx, dim=1)
    valid = valid & (rsq < cutsq)
    rsq_safe = torch.where(valid, rsq, torch.ones_like(rsq))
    r2inv = 1.0 / rsq_safe
    r6inv = r2inv ** 3
    ti, tj = type_idx[rows], type_idx[cols_safe]
    ds = sval - 1.0
    dflj = ds * r6inv * (tables.lj1[ti, tj] * r6inv
                         - tables.lj2[ti, tj]) * r2inv
    delj = ds * r6inv * (tables.lj3[ti, tj] * r6inv - tables.lj4[ti, tj])
    pref = qqr2e * q[rows] * q[cols_safe] / torch.sqrt(rsq_safe)
    zero = torch.zeros_like(rsq)
    dfpair = torch.where(valid, dflj + ds * pref * r2inv, zero)
    df = (dfpair[:, None] * dx).reshape(n, me, 3).sum(dim=1)
    return (df, 0.5 * torch.sum(torch.where(valid, delj, zero)),
            0.5 * torch.sum(torch.where(valid, ds * pref, zero)))
