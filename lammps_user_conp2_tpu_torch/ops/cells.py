"""Cell binning for the Verlet neighbor list.

The part of the JAX package's ``ops/cells.py`` the list needs: a static
cell decomposition with edge >= list radius, atoms binned and ranked per
cell with one sort, the 27-cell neighbor map, and the per-cell candidate
matrix.  The cell pair sweep itself (``cell_pair_forces``) is not
ported: the port's large-N pair path is the Verlet list.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


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
    a slab wall bins at the boundary cell)."""
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
