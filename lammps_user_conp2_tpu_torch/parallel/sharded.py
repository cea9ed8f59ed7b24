"""The sharded MD step over d ranks of a ``torch.distributed`` group (JAX
``parallel/sharded.py``, a ``shard_map`` step over a 1-D mesh).

What is split, as in the JAX step:

* x, v and q are replicated: every rank holds them whole and equal bit
  for bit (``comm.Comm.psum`` adds the ranks' parts in rank order);
* the factored-Ewald kxy rows: each rank owns a contiguous share, padded
  with ``ug = 0`` rows (``ewald_factored.kxy_shard``): its structure
  factor, electrode potentials and forces are summed over the ranks;
* the pair rows: the dense rows (``pairs.pair_rowblock``; the tile
  path's engine takes them too, as the JAX step sweeps dense rows for it,
  JAX ``sharded.py:387-401``), the per-atom list rows or the block list's
  blocks (``neighbors.block_pair_rows``, K1 on CUDA float32), gathered
  back; on the cell path a contiguous slice
  of the cells, padded to d slices, whose slot forces go back to atom
  order and are summed over the ranks (JAX ``sharded.py:258-270``,
  ``:352-386``);
* the solve's matrix rows: A^-1 (INV), A (CG: a distributed A p per
  iteration) or the real-space block (CG_MATFREE, beside the k-shard
  operator; rebuilt from the live positions for mobile electrodes);
* the electrode rows of b and of the CONP correction (on the dense path
  K5 and K6 on CUDA float32, over this rank's rows);
* the PPPM spread and gather of each rank's own atom rows, with a tile
  slot capacity sized from the ranks' occupancy at x0 plus 25% and, under
  a Verlet skin, a persistent per-rank tile assignment (K2a and K3 on CUDA
  float32; elsewhere, the tile path included, the ranks bin their rows
  every step, JAX ``sharded.py:253-256``); the
  Poisson solve and the electrode re-spread (K2b) are replicated;
* the list rebuild's row sweep: each rank sorts the candidate keys of its
  atom rows, the keys are gathered (``neighbors.row_keys``; a row's keys
  depend on that row alone, so the list is the one-rank list bit for bit).

The rest is replicated: the integrator, SHAKE/RATTLE (K7, K8), zmirror,
bonded forces, the slab term, the fields, the charge update of CONP, CONQ
and COND.  ``ShardedEngine`` is an ``Engine`` (it shares the engine's
buffers) whose pair, k-space, correction, rebuild and solve are these
shares, so the step order, ``nevery`` and the CG blocks are the engine's.
The CG convergence flag and the list's skin flag are read from replicated
values, so every rank takes the same branch.  ``run`` is eager: a loop of
``step`` with one host read of the skin flag per step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.conp import SolvePending, cg_start, realspace_block
from ..models.md import Engine, _check_supported, stack_thermo
from ..models.system import MDState
from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.cells import (cell_slab_tables, pad_slab_tables, slot_exclusions,
                         slot_forces_to_atoms, sweep_cell_slabs)
from ..ops.kernels import build
from ..ops.kernels.ele_rows_kernel import b_realspace, conp_correction
from ..ops.neighbors import (TYPE_BITS, _poison, b_realspace_from_list,
                             block_pair_rows, conp_correction_rows_from_list,
                             list_from_keys, nlist_pair_rows, nlist_prep,
                             pad_block_list, row_keys)
from ..ops.pairs import pair_rowblock
from ..utils.config import Solver
from .comm import Comm, default_comm, digest

# rows per block of the dense pair sweep
ROW_BLOCK = 512


class RankTileAssign(pppm_ops.TileAssign):
    """A rank's persistent mesh-tile assignment of its own atom rows (the
    engine's assignment covers every atom)."""


def _pad_rows(t, n: int, fill):
    """``t`` with its first axis padded to ``n`` rows of ``fill``."""
    pad = n - t.shape[0]
    if pad <= 0:
        return t
    tail = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, tail])


@dataclasses.dataclass
class ShardLayout:
    """How the step splits over ``d`` ranks, with no communication: atom
    rows [r nrow, (r + 1) nrow) and electrode rows [r nele, (r + 1) nele)
    per rank r, the last ones padded; pad electrode rows point at a real
    electrode (the first) and are masked.  ``rank_grid`` is the mesh with
    the per-rank tile slot capacity (None without a tiled mesh)."""
    d: int
    n: int
    nrow: int
    ne: int
    nele: int
    rank_grid: object = None

    def atom_rows(self, rank: int):
        """(i0, i1): rank's atom rows, [i0, i1) of them real."""
        i0 = rank * self.nrow
        return i0, min(max(i0, self.n), i0 + self.nrow)

    def my_rows(self, t, rank: int, fill=None):
        """Rank's nrow rows of ``t``: pad rows repeat the last atom's row
        (``fill`` None: positions stay inside the box) or hold ``fill``."""
        i0, i1 = self.atom_rows(rank)
        out = t[i0:i1]
        if i1 - i0 == self.nrow:
            return out
        pad = self.nrow - (i1 - i0)
        if fill is None:
            tail = t[-1:].expand((pad,) + tuple(t.shape[1:]))
        else:
            tail = torch.full((pad,) + tuple(t.shape[1:]), fill,
                              dtype=t.dtype, device=t.device)
        return torch.cat([out, tail])

    def ele_rows(self, rank: int, device):
        """(erow (nele,) int64 indices into the electrode list, evalid
        (nele,) bool) of the rank's electrode rows."""
        e0 = rank * self.nele
        gid = torch.arange(e0, e0 + self.nele, device=device)
        valid = gid < self.ne
        return torch.where(valid, gid, torch.zeros_like(gid)), valid


def make_layout(engine: Engine, d: int, x0=None) -> ShardLayout:
    """The layout of ``engine`` over ``d`` ranks; the per-rank tile cap is
    the ranks' largest tile occupancy at ``x0`` (numpy; default the
    system's) plus 25%, rounded up to 8 (JAX ``sharded.py:227-256``)."""
    sys = engine.system
    n = sys.natoms
    ne = 0 if engine.conp is None else engine.conp.ne
    lay = ShardLayout(d=d, n=n, nrow=-(-n // d), ne=ne,
                      nele=max(-(-ne // d), 1))
    grid = engine.pppm_grid
    if grid is not None and not pppm_ops._use_dense(grid, n):
        x0 = torch.as_tensor(np.asarray(sys.x0 if x0 is None else x0),
                             dtype=torch.float64)
        free = dataclasses.replace(grid, tile_cap=None)
        occ = max(pppm_ops.tile_occupancy(free, lay.my_rows(x0, r))
                  for r in range(d))
        cap = int(math.ceil(max(occ, 8) * 1.25 / 8.0) * 8)
        cap = min(cap, grid.tile_cap or cap, lay.nrow + 1)
        lay.rank_grid = pppm_ops.with_shared_cache(grid, tile_cap=cap)
    return lay


class ShardOperator:
    """p -> A p over the ranks: this rank's rows of A (CG) or of the
    real-space block (CG_MATFREE), gathered; with CG_MATFREE also the
    k-space operator over this rank's kxy shard, summed over the ranks,
    the diagonal and the slab term (``models/conp.MatfreeOperator``'s
    order)."""

    def __init__(self, comm: Comm, ne: int, rows, phi=None, diag_extra=None,
                 z=None, slab: float = 0.0):
        self.comm, self.ne, self.rows = comm, ne, rows
        self.phi, self.diag_extra, self.z, self.slab = phi, diag_extra, z, slab

    def __call__(self, p):
        real = self.comm.all_gather_rows(self.rows @ p, self.ne)
        if self.phi is None:
            return real
        out = self.comm.psum(self.phi(p))
        out = out + real
        out = out + self.diag_extra * p
        if self.slab:
            out = out + self.slab * self.z * torch.sum(self.z * p)
        return out


class ShardedEngine(Engine):
    """An ``Engine`` whose step runs as one rank of ``comm``'s group (see
    the module docstring).  Built by ``build_sharded_engine``; it shares
    the engine's buffers and configuration."""

    def __init__(self, engine: Engine, comm: Comm, layout: ShardLayout):
        state = dict(engine.__dict__)
        for k in ("_buffers", "_modules", "_parameters", "_step_graphs"):
            state[k] = type(state[k])(state[k])
        self.__dict__.update(state)
        self.comm = comm
        self.layout = layout
        self.rank_grid = layout.rank_grid
        self.tiled = layout.rank_grid is not None
        # the persistent assignment is kept under the Verlet skin's trigger
        # alone (JAX sharded.py:253-256): the tile path's engine bins the
        # ranks' rows every step, with no drift flag to read
        self.mesh_persist = bool(engine.mesh_persist
                                 and engine.ncfg is not None)
        dev = self.type_idx.device
        rank = comm.rank
        n = layout.n
        i0, i1 = layout.atom_rows(rank)
        self.rowvalid = torch.arange(i0, i0 + layout.nrow, device=dev) < i1
        self.rtypes = layout.my_rows(self.type_idx, rank, 0)
        self.rexcl = None
        if self.has_excl:
            self.rexcl = (layout.my_rows(self.excl_idx, rank, n),
                          layout.my_rows(self.excl_val, rank, 1.0))
        fk = self.fksp
        if fk is None and self.conp is not None:
            fk = self.conp.fksp
        self.kshard = (None if fk is None
                       else ewf.kxy_shard(fk, layout.d, rank))
        self.kfk = fk
        conp = self.conp
        if conp is not None:
            erow, evalid = layout.ele_rows(rank, dev)
            self.erow, self.evalid = erow, evalid
            self.eidx = conp.ele_idx_t[erow]
            # atom -> its place among this rank's electrode rows, nele for
            # every other atom and for the pad id n
            eslot = torch.full((n + 1,), layout.nele, dtype=torch.int64,
                               device=dev)
            eslot[self.eidx[evalid]] = torch.arange(
                layout.nele, device=dev)[evalid]
            self.eslot = eslot
            # K5's tables of this rank's rows; K6 takes the real rows alone
            # (a pad row would add its electrode's force and energy again)
            # and the flags of this rank's electrodes, whose z order its
            # electrolyte rows search for their reactions
            self.eta_erows = conp.eta_rows[erow]
            self.fo_erows = conp.fo_rows[erow]
            self.eidx_real = self.eidx[evalid]
            self.rank_ele_flag = torch.zeros_like(self.ele_flag)
            self.rank_ele_flag[self.eidx_real] = 1.0
            solver = conp.cfg.solver
            mat = {Solver.INV: conp.ainv, Solver.CG: conp.amat,
                   Solver.CG_MATFREE: conp.real_block}[solver]
            rows = mat[erow]
            self.solve_rows = torch.where(evalid[:, None], rows,
                                          torch.zeros_like(rows))

    # ------------------------------------------------------------ state
    def prep_state(self, state: MDState) -> MDState:
        """``state`` with the engine's mesh-tile assignment replaced by this
        rank's (built at the same reference positions), or dropped where
        this engine keeps none; a state of this engine passes through."""
        t = state.tasg
        if t is None or isinstance(t, RankTileAssign):
            return state
        if not self.mesh_persist:
            return dataclasses.replace(state, tasg=None)
        return dataclasses.replace(state, tasg=self._rank_assign(t.x_ref))

    def _rank_assign(self, x):
        xi = self.layout.my_rows(x, self.comm.rank)
        a = pppm_ops.tile_assign(self.rank_grid, xi)
        return RankTileAssign(a.slot, a.table, a.overflow, a.x_ref)

    def step(self, state: MDState) -> MDState:
        return super().step(self.prep_state(state))

    def run(self, state: MDState, nsteps: int, *, thermo_every: int = 1):
        """``nsteps`` eager steps; returns (final_state, thermo) as
        ``Engine.run`` does (thermo None when thermo_every is 0)."""
        rows = []
        for i in range(nsteps):
            state = self.step(state)
            if thermo_every and (i + 1) % thermo_every == 0:
                rows.append(self.thermo(state))
        return state, (stack_thermo(rows) if thermo_every else None)

    def _solve_full(self, x, q, nbr, tasg, step):
        pend = self._solve_head(x, q, nbr, tasg, step=step, scalar_prev=None)
        while self.conp.cg_active(pend):
            pend.cg = self.conp.cg_block(pend)
        return self.conp.solve_end(pend, x, q, step=step)

    # ---------------------------------------------------------- rebuild
    def derived_state(self, x):
        """The Verlet list (each rank sorts the keys of its atom rows, the
        keys are gathered: the one-rank list bit for bit) and this rank's
        mesh-tile assignment."""
        nbr = tasg = None
        lay, comm = self.layout, self.comm
        if self.ncfg is not None:
            prep = nlist_prep(self.ncfg, x, self.type_idx)
            i0, i1 = lay.atom_rows(comm.rank)
            keys, ovf = row_keys(self.ncfg, x, prep, i0, i1)
            keys = comm.all_gather_rows(
                _pad_rows(keys, lay.nrow, (lay.n + 1) << TYPE_BITS), lay.n)
            nbr = list_from_keys(self.ncfg, x, prep, keys, comm.pmax(ovf),
                                 self.tables, self.type_idx)
        if self.mesh_persist:
            tasg = self._rank_assign(x)
        return nbr, tasg

    # ------------------------------------------------------------ pairs
    def _pair(self, x, q, kcache, nbr):
        u = self.units
        g = self.ksp_force.g_ewald
        lay, comm = self.layout, self.comm
        rank = comm.rank
        if self.cell_grid is not None:
            return self._cell_pair(x, q)
        if self.ncfg is not None and nbr is not None and self.ncfg.block:
            fuse = None
            if self.conp is not None and build.kernel_route("block_pair", x):
                fuse = (self.ele_flag, self.elyte_flag, self.eta_tab,
                        self.fo_tab)
            nbp = pad_block_list(nbr, lay.n, lay.d)
            nb_l = nbp.bun.shape[0] // lay.d
            out = block_pair_rows(
                self.ncfg, nbp, x, q, rank * nb_l, nb_l, self.type_idx,
                self.tables, self.exclusions, g_ewald=g, qqr2e=u.qqr2e,
                conp_fuse=fuse)
            f_slots = comm.all_gather_rows(out[0], nbr.brows.numel())
            sums = comm.psum(torch.stack(out[1:]))      # one collective
            f, ev, ec, ov = _poison(nbr, x, f_slots[nbr.binv], sums[0],
                                    sums[1])
            ecorr = None
            if fuse is not None:
                ecorr = torch.where(ov, torch.full_like(ev, float("nan")),
                                    sums[2])
            return f, ev, ec, ecorr
        xi = lay.my_rows(x, rank)
        qi = lay.my_rows(q, rank, 0.0)
        if self.ncfg is not None and nbr is not None:
            idx = lay.my_rows(nbr.idx, rank, lay.n)
            lj = lay.my_rows(nbr.lj.transpose(0, 1), rank, 0.0)
            f_rows, ev, ec = nlist_pair_rows(
                self.ncfg, x, q, xi, qi, idx, lj.transpose(0, 1),
                g_ewald=g, qqr2e=u.qqr2e, excl_rows=self.rexcl)
            sums = comm.psum(torch.stack([ev, ec]))
            f, ev, ec, _ = _poison(nbr, x, comm.all_gather_rows(f_rows, lay.n),
                                   sums[0], sums[1])
            return f, ev, ec, None
        i0 = lay.atom_rows(rank)[0]
        fs, ev, ec = [], 0.0, 0.0
        for b0 in range(0, lay.nrow, ROW_BLOCK):
            sl = slice(b0, b0 + ROW_BLOCK)
            ex = ((None, None) if self.rexcl is None
                  else (self.rexcl[0][sl], self.rexcl[1][sl]))
            f_b, ev_b, ec_b = pair_rowblock(
                xi[sl], qi[sl], self.rtypes[sl], *ex, self.rowvalid[sl],
                i0 + b0, x, q, self.type_idx, self.tables,
                box=self.ksp_force.box, periodic=self.system.periodic,
                cutoff=self.md.cutoff, g_ewald=g, qqr2e=u.qqr2e)
            fs.append(f_b)
            ev = ev + ev_b
            ec = ec + ec_b
        sums = comm.psum(torch.stack([ev, ec]))
        return comm.all_gather_rows(torch.cat(fs), lay.n), sums[0], sums[1], \
            None

    def _cell_pair(self, x, q):
        """The cell sweep of this rank's slice of the cells (the cells
        padded with empty ones to d equal slices), its slot forces in atom
        order (0 for the atoms of other slices) and its energies, summed
        over the ranks in one collective; at d = 1 the one-rank sweep bit
        for bit."""
        grid, lay = self.cell_grid, self.layout
        n = lay.n
        table, xq, pt, overflow = cell_slab_tables(grid, x, q, self.type_idx)
        ncell, cap = table.shape
        cl = -(-ncell // lay.d)
        padc = cl * lay.d - ncell
        xq, pt, nb, uq = pad_slab_tables(grid, xq, pt, padc, n)
        table = torch.cat([table, table.new_full((padc, cap), n)])
        c0 = self.comm.rank * cl
        ev, ec, fslots = sweep_cell_slabs(
            grid, self.tables, xq, pt, nb, uq, c0, cl,
            g_ewald=self.ksp_force.g_ewald, qqr2e=self.units.qqr2e, n=n,
            excl=slot_exclusions(table, self.exclusions, n))
        f = slot_forces_to_atoms(table[c0:c0 + cl], fslots, n)
        out = self.comm.psum(torch.cat([f.reshape(-1), torch.stack([ev, ec])]))
        nan = torch.full_like(ev, float("nan"))
        return (out[:3 * n].view(n, 3), torch.where(overflow, nan, out[-2]),
                torch.where(overflow, nan, out[-1]), None)

    # ---------------------------------------------------------- k-space
    def _kspace(self, x, q, kcache, tasg):
        if self.pppm_grid is not None:
            return self._pppm(x, q, kcache, tasg)
        kx, ky, ug = self.kshard
        ek, fk = ewf.energy_forces_fkv(x, q, kx, ky, self.kfk.kz_t,
                                       self.kfk.unitk, ug)
        # the energy rides the forces' collective as a fourth column
        out = self.comm.psum(torch.cat([fk, ek.expand(fk.shape[0], 1)], 1))
        return out[0, 3], out[:, :3]

    def _rank_slots(self, xi, qi, tasg):
        if tasg is not None:
            return pppm_ops.refresh_tile_slots(self.rank_grid, tasg, xi, qi)
        return pppm_ops.tile_slots(self.rank_grid, xi, qi)

    def _rank_rhok(self, x, q, tasg):
        """(rhok of every rank's rows summed, this rank's tile slots or
        None on a dense mesh)."""
        lay = self.layout
        xi = lay.my_rows(x, self.comm.rank)
        qi = lay.my_rows(q, self.comm.rank, 0.0)
        slots = None
        if self.tiled:
            slots = self._rank_slots(xi, qi, tasg)
            rhok = pppm_ops._spread_rhok_tiled(self.rank_grid, xi, qi, slots)
        else:
            rhok = pppm_ops.spread_rhok(self.pppm_grid, xi, qi)
        return self.comm.psum(rhok), slots

    def _elyte_kcache(self, x, q, tasg):
        """(rhok of the electrolyte, this rank's slots) under PPPM, None
        under Ewald (the forces then sum their own kxy shard)."""
        if self.conp.pppm_grid is None:
            return None
        q_elyte = torch.where(self.conp.elyte_t, q, torch.zeros_like(q))
        return self._rank_rhok(x, q_elyte, tasg)

    def _pppm(self, x, q, kcache, tasg):
        grid, lay = self.pppm_grid, self.layout
        conp = self.conp
        if conp is not None:
            if kcache is None:
                kcache = self._elyte_kcache(x, q, tasg)
            rhok_elyte, slots = kcache
            xe, qe = conp.ele_rows(x), conp.ele_rows(q)
            if conp.ele_zplanes is not None:
                rho_ep = pppm_ops.spread_zplanes(grid, xe, qe, conp.ele_zpinv)
                rhok = rhok_elyte + pppm_ops.rhok_from_zplanes(
                    grid, rho_ep, conp.ele_zplanes)
            else:
                # replicated: the Ne rows alone, tiled (K2b) above the
                # dense bound
                rhok = rhok_elyte + pppm_ops.rfft3(
                    grid, pppm_ops.spread(grid, xe, qe))
        else:
            rhok, slots = self._rank_rhok(x, q, tasg)
        xi = lay.my_rows(x, self.comm.rank)
        qi = lay.my_rows(q, self.comm.rank, 0.0)
        diff = self.md.pppm_diff
        if diff == "ad" or (diff == "auto" and self.tiled):
            if self.tiled:
                ek, uz = pppm_ops.pppm_energy_u_zbin(self.rank_grid, rhok,
                                                     lay.nrow)
                e3 = pppm_ops.gather3_ad_zbin(self.rank_grid, uz, xi, slots)
            else:
                ek, umesh = pppm_ops.pppm_energy_u_from_k(grid, rhok)
                e3 = pppm_ops.gather3_ad(grid, umesh, xi)
        else:
            ek, efield = pppm_ops.pppm_energy_efield_from_k(grid, rhok)
            e3 = pppm_ops.gather3(self.rank_grid if self.tiled else grid,
                                  efield, xi, slots=slots)
        return ek, self.comm.all_gather_rows(qi[:, None] * e3, lay.n)

    # ------------------------------------------------------- correction
    def _correction(self, x, q, kcache, nbr):
        conp = self.conp
        kw = dict(cutoff=self.md.cutoff, qqr2e=self.units.qqr2e)
        if self.ncfg is not None and nbr is not None:
            pot, frc = conp.step_kernels
            f, e = conp_correction_rows_from_list(
                self.ncfg, nbr, x, q, self.eidx, self.evalid, self.eslot,
                conp.elyte_t, self.type_idx, frc, pot, **kw)
        elif self.eidx_real.numel() == 0:
            f, e = torch.zeros_like(x), torch.zeros((), dtype=x.dtype,
                                                    device=x.device)
        else:
            # K6 over this rank's electrode rows and their reactions
            f, e = conp_correction(
                x, q, self.type_idx, self.eidx_real, self.rank_ele_flag,
                self.elyte_flag, self.eta_tab, self.fo_tab,
                box=self.ksp_force.box, periodic=self.system.periodic,
                r_corr=self.r_corr, gtab=self.corr_gtab, **kw)
        out = self.comm.psum(torch.cat([f, e.expand(f.shape[0], 1)], 1))
        return out[:, :3], out[0, 3]

    # ------------------------------------------------------------ solve
    def _solve_begin(self, state: MDState, x, nbr, tasg, solve: bool):
        if self.conp is None:
            return None
        if not solve:
            return SolvePending(b=None,
                                kcache=self._elyte_kcache(x, state.q, tasg))
        return self._solve_head(x, state.q, nbr, tasg, step=state.step_t + 1,
                                scalar_prev=state.scalar_out)

    def _b_real_rows(self, x, q_elyte, nbr):
        """The real-space b of this rank's electrode rows: from the list,
        or K5 (the dense rows); padded rows give 0."""
        conp = self.conp
        kw = dict(g_ewald=conp.ksp.g_ewald, cut_coulsq=conp.cut_coulsq)
        if self.ncfg is not None and nbr is not None:
            b = b_realspace_from_list(
                self.ncfg, nbr, x, q_elyte, self.eidx, conp.elyte_t,
                self.type_idx, conp.step_kernels[0], **kw)
        else:
            b = b_realspace(x, q_elyte, self.eidx, conp.elyte_f,
                            self.eta_erows, self.fo_erows, conp.type_t,
                            box=conp.box, periodic=conp.periodic, **kw)
        return torch.where(self.evalid, b, torch.zeros_like(b))

    def _solve_head(self, x, q, nbr, tasg, step, scalar_prev):
        """``ConpSolver.solve_begin`` over the ranks: b from this rank's
        kxy shard (summed) or mesh rows and electrode rows (gathered), then
        A^-1 b from this rank's rows (INV), or the distributed operator and
        the warm-started CG carry."""
        conp, comm = self.conp, self.comm
        ne = conp.ne
        q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
        kcache = self._elyte_kcache(x, q, tasg)
        xe = conp.ele_rows(x)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if conp.pppm_grid is not None:
            grid = conp.pppm_grid
            xe_l = x[self.eidx]
            if conp.ele_zplanes is not None:
                up = pppm_ops.u_on_zplanes(grid, kcache[0], conp.ele_zplanes)
                b_l = -pppm_ops.gather_zplanes(grid, up, xe_l, conp.ele_zpinv)
            else:
                u = pppm_ops.poisson_u_from_k(grid, kcache[0])
                b_l = -pppm_ops.gather(grid, u, xe_l)
            b = comm.all_gather_rows(torch.where(self.evalid, b_l, zero), ne)
        else:
            kx, ky, ug = self.kshard
            fk = self.kfk
            sr, si = ewf.structure_factor_fkv(x, q_elyte, kx, ky, fk.kz_t,
                                              fk.unitk)
            b = comm.psum(-ewf.potential_on_points_fkv(
                xe, sr, si, kx, ky, fk.kz_t, fk.unitk, ug))
        b = b + comm.all_gather_rows(self._b_real_rows(x, q_elyte, nbr), ne)
        if conp.ksp.slabflag:
            slabcorr = (4.0 * math.pi / conp.ksp.volume) * torch.sum(
                q_elyte * x[:, 2])
            b = b - xe[:, 2] * slabcorr
        cfg = conp.cfg
        if cfg.solver is Solver.INV:
            el = (self.solve_rows @ b.to(self.solve_rows.dtype)).to(b.dtype)
            return SolvePending(b=b, kcache=kcache,
                                eleallq=comm.all_gather_rows(el, ne))
        op = ShardOperator(comm, ne, self.solve_rows)
        if cfg.solver is Solver.CG_MATFREE:
            rows = self.solve_rows
            if cfg.mobile_electrodes:
                rows = realspace_block(
                    xe, conp.ele_rows(conp.type_t), conp.a_kernel,
                    g=conp.ksp.g_ewald, box=conp.box, periodic=conp.periodic,
                    cut_coulsq=conp.cut_coulsq, rows=self.erow,
                    valid=self.evalid)
            kx, ky, ug = self.kshard
            fk = self.kfk
            op = ShardOperator(
                comm, ne, rows, phi=ewf.make_phi_operator_kv(
                    xe, kx, ky, fk.kz_t, fk.unitk, ug),
                diag_extra=conp.diag_extra, z=xe[:, 2],
                slab=(4.0 * math.pi / conp.ksp.volume) if conp.ksp.slabflag
                else 0.0)
        pend = SolvePending(b=b, kcache=kcache, op=op)
        pend.cg = cg_start(op, b, cfg.cg_tolerance, cfg.cg_maxiter,
                           x0=conp._cg_warm_start(q, step, scalar_prev))
        return pend


def build_sharded_engine(engine: Engine, group: Comm = None, *,
                         x0=None) -> ShardedEngine:
    """The sharded engine of ``engine`` for this rank of ``group`` (None:
    the default process group, on the engine's device), mirroring JAX
    ``build_sharded_engine``.  Every rank builds its engine itself; the
    set-up must be bit-identical on every rank, which a digest of the
    engine's tensors checks (``pmin == pmax``).  ``x0``: the positions to
    size the per-rank tile cap from (default: the system's).  Raises
    NotImplementedError for a solve in another dtype than the engine's
    (the JAX step runs in the engine's dtype only) and for what
    ``build_engine`` refuses."""
    _check_supported(engine.system, engine.md)
    if engine.conp is not None and engine.conp.solve_dtype != engine.dtype:
        raise NotImplementedError(
            "not ported: the sharded step with a solve in another dtype "
            "than the engine's")
    comm = group if group is not None else default_comm(
        engine.type_idx.device)
    dev = engine.type_idx.device
    h = digest([t for _, t in sorted(engine.named_buffers())])
    key = torch.tensor(int(h[:15], 16), dtype=torch.int64, device=dev)
    if not torch.equal(comm.pmin(key), comm.pmax(key)):
        raise RuntimeError("build_sharded_engine: the engine's set-up "
                           "differs between ranks")
    return ShardedEngine(engine, comm, make_layout(engine, comm.size, x0))
