"""The MD engine: velocity Verlet with the charge solve in pre-force position.

Step order (LAMMPS Verlet::run, FixConp::pre_force fix_conp.cpp:543-573):
  NHC half -> kick half -> drift -> [SHAKE] -> [Verlet skin check, list
  and mesh-tile rebuild] -> charge solve -> forces -> post-force CONP
  correction -> kick half -> [RATTLE] -> NHC half

``step`` is a plain function of tensors, in three segments (``_pre``,
``_rebuild``, ``_post``); ``run`` is a Python loop of steps on the CPU and
replays the segments as CUDA graphs on the card (``models/graphs.py``).
Two paths, chosen by ``build_engine`` as the JAX engine chooses them:

* mid-size (N <= 8192 or a box under 4 cutoffs): the dense pair sweep (K4)
  with the CONP Gaussian correction fused in (with
  ``MDConfig.use_pallas_pair=False``: the unfused plain sweep and the
  correction on its own, K6), the electrode b rows (K5), and the factored
  Ewald (or the PPPM mesh) for k-space;
* large N: a Verlet list with skin, in block form with the block sweep (K1,
  correction fused) where that CUDA kernel runs (CUDA float32), per-atom
  rows elsewhere; the tiled z-binned PPPM mesh with the spread (K2a) and
  the ad gather (K3); the electrode transforms on their z planes.

Two more pair paths on request, as in the JAX engine: ``pair_path="cell"``,
the cell-list sweep (plain PyTorch, ``ops/cells.py``) with the CONP
correction on its own (K6), a one-graph step like the dense paths; and
``pair_path="tile"``, which on the card in float32 is K4 over the live
tile pairs of the atoms in k-d bricks (``pair_cap`` items, no Verlet
list; the persistent mesh tiles rebuilt by their own drift test, one flag
read per step) and elsewhere the Verlet list (big N) or the dense sweep,
as the JAX engine falls back off its accelerator.

Both paths run SHAKE (K7) and RATTLE (K8) when the configuration
constrains bonds and angles (the ionic-liquid decks), then zmirror when
the deck asks for it; the forces take the external or the feedback
electric field (FFIELD decks) after the CONP post-force terms.  The
integrator's thermostat half, kick and drift are one K10 launch per half
step on the card (``ops/kernels/integrate_kernel``; around RATTLE, a kick
launch and a thermostat launch).

The charge solve runs every ``nevery``-th step (``Engine.solves``, decided
from the host step number); a step that skips it keeps the charges and the
fix scalar and still hands the force path the electrolyte's k-space cache.
With the CG solvers ``_post`` is ``_solve_begin``, the CG blocks while the
carry's device flag says so (a host read per block), and ``_post_tail``.
The solve may run in another dtype than the engine (mixed precision: a
float64 solve under a float32 engine): the force path then drops the
solve's cache (``_own_cache``) and builds its own factored tables or mesh
in the engine's dtype, as the JAX engine does.
``build_engine`` runs on the card unless the caller passes
``device="cpu"``; every kernel wrapper launches its CUDA kernel in float32
on the card and takes its plain version on the CPU and in float64 on the
card (``ops/kernels/build.kernel_route``), and ``build_engine`` makes the
same choices in float64 on either device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import ewald as ewald_ops
from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.bonded import bonded_forces, term_table
from ..ops.cells import build_cell_grid, cell_pair_forces
from ..ops.kernels import build
from ..ops.kernels.ele_rows_kernel import conp_correction, correction_range
from ..ops.kernels.integrate_kernel import integrate_half
from ..ops.kernels.pair_kernel import pair_forces, pair_tile_count
from ..ops.kernels.shake_kernel import rattle_velocities, shake_positions
from ..ops.neighbors import (block_pair_forces, build_neighbor_list,
                             conp_correction_from_list, make_neighbor_config,
                             max_union_count, needs_rebuild,
                             nlist_pair_forces)
from ..ops.pairs import (PairTables, dense_pair_forces, exclusions_tensors,
                         make_pair_tables)
from ..utils import timers
from ..utils.config import KSpaceStyle, MDConfig, PairMode
from ..utils.device import DEFAULT_DTYPE, resolve_device
from . import graphs
from .conp import ConpSolver, SolvePending
from .electrodes import MY_PIS
from .integrate import Integrator, group_temperature, make_nhc_params
from .shake import ShakeConstraints, build_constraints
from .system import MDState, System, exclusion_lists
from .zmirror import ZMirror, build_zmirror

# the JAX engine switches to a Verlet neighbor list above this atom count
# when the box is at least 4 cutoffs wide (models/md.py build_engine)
DENSE_MAX_ATOMS = 8192


class Engine(nn.Module):
    """One MD engine; constant tensors are buffers (``.to(device)`` moves
    them), the configuration is plain attributes."""

    def __init__(self, *, system: System, md: MDConfig,
                 conp: Optional[ConpSolver], integrator: Integrator,
                 cons: Optional[ShakeConstraints],
                 ksp_force: ewald_ops.EwaldKSpace,
                 fksp: Optional[ewf.FactoredKSpace], pppm_grid, ncfg,
                 mesh_persist: bool, dtype, device,
                 zmirror: Optional[ZMirror] = None, cell_grid=None,
                 pair_order: str = "z", pair_cap: Optional[int] = None):
        super().__init__()
        self.system = system
        self.md = md
        self.conp = conp
        self.integrator = integrator
        self.cons = cons                 # SHAKE/RATTLE cluster tables, or None
        self.zmirror = zmirror           # the zmirror pairing, or None
        self.ksp_force = ksp_force
        self.fksp = fksp                 # factored Ewald, or None under PPPM
        self.pppm_grid = pppm_grid       # PPPMGrid, or None under EWALD
        self.ncfg = ncfg                 # NeighborConfig, or None (dense)
        self.cell_grid = cell_grid       # CellGrid of pair_path="cell", or None
        # the tile path (pair_path="tile" on the card): K4's atom order and
        # its live tile-pair capacity (None: the z schedule, no cap)
        self.pair_order = pair_order
        self.pair_cap = pair_cap
        # persistent mesh-tile binning rebuilt with the Verlet list: only on
        # the tiled mesh, and only while skin/2 fits the tile drift margin
        self.mesh_persist = mesh_persist
        self.rebuilds = 0                # list or mesh-tile rebuilds in step()
        self.cg_blocks = 0               # CG blocks run by the steps
        # graphs.StepGraphs by graphs.graph_key: the step's CUDA graphs at
        # each set of capacities run() has met
        self._step_graphs = {}
        self.dtype = dtype
        self.units = system.units()
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                        device=device)
        tabs = make_pair_tables(system.lj_eps, system.lj_sigma, device=device,
                                dtype=dtype)
        self.register_buffer("lj_tab", torch.stack(tuple(tabs)))
        self.register_buffer("type_idx", i64(system.type))
        self.register_buffer("elecheck", torch.as_tensor(system.elecheck,
                                                         device=device))
        excl = exclusions_tensors(exclusion_lists(system), device=device,
                                  dtype=dtype)
        self.has_excl = excl is not None
        if self.has_excl:
            self.register_buffer("excl_idx", excl[0])
            self.register_buffer("excl_val", excl[1])
        self.has_bonded = len(system.bonds) > 0 or len(system.angles) > 0
        if self.has_bonded:
            self.register_buffer("bonds", i64(system.bonds))
            self.register_buffer("angles", i64(system.angles))
            self.register_buffer("bond_coeffs", f(system.bond_coeffs))
            self.register_buffer("angle_coeffs", f(system.angle_coeffs))
            # the fixed-order sum of the bonded terms (no atomic scatter)
            self.register_buffer("bonded_tab", term_table(
                system.bonds, system.angles, system.natoms).to(device))
        if conp is not None:
            kern = conp.kernels
            self.register_buffer("ele_flag", f(system.elecheck != 0))
            self.register_buffer("elyte_flag", f(conp.elyte_mask))
            self.register_buffer("eta_tab", f(kern.eta_ij))
            self.register_buffer("fo_tab", f(kern.fo_ij))
            self.register_buffer("corr_gtab", torch.stack(
                [self.eta_tab, self.fo_tab]).contiguous())
            self.register_buffer("self_diag", f(kern.self_diag))
            # the self energy qqr2e fac sum(self_diag q^2): ETA's
            # eta sum q^2 / (sqrt2 sqrt(pi)) is fac = 1/2, EHGO's
            # sum u0_i q^2 fac = 1
            self.self_fac = 0.5 if conp.cfg.pairmode is PairMode.ETA else 1.0
            # the range of the CONP correction's terms (K6 searches it)
            self.r_corr = correction_range(
                kern.eta_ij, kern.fo_ij, np.unique(system.type[conp.ele_idx]),
                np.unique(system.type[conp.elyte_mask]), md.cutoff)
        # thermo groups: the solvent (or the first thermostat's group) and
        # the two electrodes
        sol = system.groups.get("sol")
        if sol is None and md.thermostats:
            sol = system.groups[md.thermostats[0].group]
        self.nsol = None if sol is None else int(np.sum(sol))
        self.ncons_sol = (0 if cons is None or sol is None
                          else cons.n_in_group(sol))
        if sol is not None:
            self.register_buffer("sol_mask", torch.as_tensor(sol, device=device))
        self.register_buffer("left_mask", torch.as_tensor(
            system.ele_left_mask, device=device))
        self.register_buffer("right_mask", torch.as_tensor(
            system.ele_right_mask, device=device))
        if md.efield is not None:
            self.register_buffer("efield", f(md.efield))

    @property
    def tables(self) -> PairTables:
        return PairTables(*self.lj_tab)

    @property
    def exclusions(self):
        return (self.excl_idx, self.excl_val) if self.has_excl else None

    # ------------------------------------------------------------- forces
    def _pair(self, x, q, kcache, nbr):
        """(f, evdwl, ecoul, fused_ecorr): the pair sweep; fused_ecorr is
        the CONP correction energy when the sweep folded the correction
        into f, else None."""
        u = self.units
        g = self.ksp_force.g_ewald
        fuse = None
        if self.conp is not None:
            fuse = (self.ele_flag, self.elyte_flag, self.eta_tab, self.fo_tab)
        if self.ncfg is not None and nbr is not None:
            if self.ncfg.block:
                # the correction rides the block sweep only where K1 runs
                kfuse = fuse if build.kernel_route("block_pair", x) else None
                out = block_pair_forces(
                    self.ncfg, nbr, x, q, self.type_idx, self.tables,
                    self.exclusions, g_ewald=g, qqr2e=u.qqr2e,
                    conp_fuse=kfuse)
                return out[0], out[1], out[2], (out[3] if kfuse else None)
            f, ev, ec, _ = nlist_pair_forces(
                self.ncfg, nbr, x, q, self.type_idx, self.tables,
                self.exclusions, g_ewald=g, qqr2e=u.qqr2e)
            return f, ev, ec, None
        if self.cell_grid is not None:
            # the cell list; the correction runs on its own (K6), as the
            # JAX engine's cell branch leaves it to its unfused sweep
            f, ev, ec, overflow = cell_pair_forces(
                self.cell_grid, x, q, self.type_idx, self.tables,
                self.exclusions, g_ewald=g, qqr2e=u.qqr2e)
            nan = torch.full_like(ev, float("nan"))
            return (f, torch.where(overflow, nan, ev),
                    torch.where(overflow, nan, ec), None)
        if self.pair_cap is None and self.md.use_pallas_pair is False:
            # the unfused dense sweep, as the JAX engine runs it with
            # use_pallas_pair=False: no TPU kernel computes it there, so it
            # is plain PyTorch here on every device; compute_forces then
            # sweeps the CONP correction on its own (K6)
            f, ev, ec = dense_pair_forces(
                x, q, self.type_idx, self.tables, self.exclusions,
                box=self.ksp_force.box, periodic=self.system.periodic,
                cutoff=self.md.cutoff, g_ewald=g, qqr2e=u.qqr2e)
            return f, ev, ec, None
        out = pair_forces(
            x, q, self.type_idx, self.tables, self.exclusions,
            box=self.ksp_force.box, periodic=self.system.periodic,
            cutoff=self.md.cutoff, g_ewald=g, qqr2e=u.qqr2e,
            zsort=self._zsort(kcache) if self.pair_order == "z" else None,
            order=self.pair_order, pair_cap=self.pair_cap, conp_fuse=fuse,
            ele_idx=None if fuse is None else self.conp.ele_idx_t)
        return out[0], out[1], out[2], (out[3] if fuse is not None else None)

    def _zsort(self, kcache):
        """The z ordering the charge solve computed at these positions (the
        factored-Ewald cache carries it), or None."""
        if kcache is not None and self.pppm_grid is None:
            return kcache[3]
        return None

    def _own_cache(self, kcache, x):
        """The charge solve's k-space cache where it is in x's dtype, else
        None: a solve in another dtype (mixed precision) leaves the force
        path to build its own tables or mesh (JAX md.py:99-104,
        :179-183)."""
        if kcache is None:
            return None
        if self.pppm_grid is not None:
            ok = kcache[0].dtype == x.dtype.to_complex()
        else:
            ok = kcache[0][0][0].dtype == x.dtype
        return kcache if ok else None

    def _slots(self, x, q, tasg):
        grid = self.pppm_grid
        if pppm_ops._use_dense(grid, x.shape[0]):
            return None
        if tasg is not None:
            return pppm_ops.refresh_tile_slots(grid, tasg, x, q)
        return pppm_ops.tile_slots(grid, x, q)

    def _pppm(self, x, q, kcache, tasg):
        """(ek, fk) of the mesh, without the qqr2e prefactor: the
        electrolyte density comes from the charge solve's cache, the
        electrodes are added in k-space from their z planes, or re-spread
        onto the full mesh where they have none (pppm_conp.cpp:385-450),
        then the ad (or, on a dense mesh by default, ik) force readout."""
        grid = self.pppm_grid
        n = x.shape[0]
        tiled = not pppm_ops._use_dense(grid, n)
        if self.conp is not None:
            rhok_elyte, slots = kcache if kcache is not None else (None, None)
            if rhok_elyte is None:
                q_elyte = torch.where(self.elecheck != 0, torch.zeros_like(q),
                                      q)
                slots = self._slots(x, q_elyte, tasg)
                rhok_elyte = pppm_ops.spread_rhok(grid, x, q_elyte, slots)
            xe, qe = self.conp.ele_rows(x), self.conp.ele_rows(q)
            if self.conp.ele_zplanes is not None:
                rho_ep = pppm_ops.spread_zplanes(grid, xe, qe,
                                                 self.conp.ele_zpinv)
                rhok = rhok_elyte + pppm_ops.rhok_from_zplanes(
                    grid, rho_ep, self.conp.ele_zplanes)
            else:
                # the Ne rows alone, tiled (K2b) above the dense bound
                rhok = rhok_elyte + pppm_ops.rfft3(
                    grid, pppm_ops.spread(grid, xe, qe))
        else:
            slots = self._slots(x, q, tasg)
            rhok = pppm_ops.spread_rhok(grid, x, q, slots)
        diff = self.md.pppm_diff
        if diff == "ad" or (diff == "auto" and tiled):
            if tiled:
                ek, uz = pppm_ops.pppm_energy_u_zbin(grid, rhok, n)
                e3 = pppm_ops.gather3_ad_zbin(grid, uz, x, slots)
            else:
                ek, umesh = pppm_ops.pppm_energy_u_from_k(grid, rhok)
                e3 = pppm_ops.gather3_ad(grid, umesh, x)
            return ek, q[:, None] * e3
        ek, efield = pppm_ops.pppm_energy_efield_from_k(grid, rhok)
        return ek, pppm_ops.gather3(grid, efield, x, slots=slots, scale=q)

    def _kspace(self, x, q, kcache, tasg):
        """(ek, fk) of k-space without the qqr2e prefactor: the mesh, or
        the factored Ewald sum from the solve's cache where there is one."""
        if self.pppm_grid is not None:
            return self._pppm(x, q, kcache, tasg)
        if kcache is not None:
            tabs, sre, sie, _ = kcache
            return ewf.energy_forces_cached(self.fksp, q, tabs, sre, sie,
                                            self.conp.ele_rows)
        # no cache: no solve, a solve in another dtype, or above KXY_CHUNK
        # (the chunked sums)
        return ewf.energy_forces_f(self.fksp, x, q)

    def _correction(self, x, q, kcache, nbr):
        """(f, ecorr) of the CONP Gaussian correction where no sweep fused
        it: from the electrode rows of the list, or K6 on the dense path."""
        u = self.units
        if self.ncfg is not None and nbr is not None:
            pot, frc = self.conp.step_kernels
            return conp_correction_from_list(
                self.ncfg, nbr, x, q, self.conp.ele_idx_t,
                self.conp.elyte_t, self.type_idx, frc, pot,
                cutoff=self.md.cutoff, qqr2e=u.qqr2e)
        # the unfused dense branch: K6 on the card at every size (the JAX
        # engine's 8M-pair threshold, PALLAS_ROWS_MIN_PAIRS, is its TPU
        # crossover; the port's K5 runs at every size too)
        return conp_correction(
            x, q, self.type_idx, self.conp.ele_idx_t, self.ele_flag,
            self.elyte_flag, self.eta_tab, self.fo_tab,
            box=self.ksp_force.box, periodic=self.system.periodic,
            cutoff=self.md.cutoff, qqr2e=u.qqr2e, zsort=self._zsort(kcache),
            r_corr=self.r_corr, gtab=self.corr_gtab)

    def compute_forces(self, x, q, kcache=None, nbr=None, tasg=None,
                       scalar=None):
        """Returns (f, pe) for the current configuration.  ``kcache`` is the
        charge solve's k-space cache at the same positions (see
        ``ConpSolver.elyte_kcache``) or None; ``nbr`` the Verlet list and
        ``tasg`` the persistent mesh-tile assignment, when the engine keeps
        them; ``scalar`` the fix scalar of this step's solve, which the
        feedback field reads."""
        with timers.layer("forces"):
            return self._forces(x, q, self._own_cache(kcache, x), nbr, tasg,
                                scalar)

    def _forces(self, x, q, kcache, nbr, tasg, scalar):
        """``compute_forces`` with the solve's cache in x's dtype, or None."""
        sys = self.system
        u = self.units
        box = self.ksp_force.box
        with timers.layer("forces.pair"):
            f, evdwl, ecoul, fused_ecorr = self._pair(x, q, kcache, nbr)
        pe = evdwl + ecoul
        if self.has_bonded:
            fba, eba = bonded_forces(
                x, self.bonds, self.bond_coeffs, self.angles,
                self.angle_coeffs, box=box, periodic=sys.periodic,
                table=self.bonded_tab)
            f = f + fba
            pe = pe + eba
        with timers.layer("forces.kspace"):
            ek, fk = self._kspace(x, q, kcache, tasg)
        g = self.ksp_force.g_ewald
        eself = -u.qqr2e * g / MY_PIS * torch.sum(q * q)
        qsum = torch.sum(q)
        ebg = (-u.qqr2e * math.pi / (2 * g * g * self.ksp_force.volume)
               * qsum * qsum)
        f = f + u.qqr2e * fk
        pe = pe + u.qqr2e * ek + eself + ebg

        if self.ksp_force.slabflag:
            es, fs = ewald_ops.slab_correction_energy_forces(
                x, q, self.ksp_force.volume)
            f = f + u.qqr2e * fs
            pe = pe + u.qqr2e * es

        if self.conp is not None:
            # CONP post-force: the correction forces (folded into f by a
            # fused sweep, else from the electrode rows of the list or the
            # electrode-row sweep K6), the correction energy and the
            # Gaussian self energy qqr2e * self_fac * sum(self_diag q^2)
            ecorr = fused_ecorr
            if ecorr is None:
                fc, ecorr = self._correction(x, q, kcache, nbr)
                f = f + fc
            qsq_ele = torch.sum(torch.where(
                self.elecheck != 0, self.self_diag * q * q,
                torch.zeros_like(q)))
            pe = pe + u.qqr2e * self.self_fac * qsq_ele + ecorr

        # the external and the feedback uniform fields (V/Angstrom):
        # F = qe2f q E
        if self.md.efield is not None:
            f = f + u.qe2f * q[:, None] * self.efield[None, :]
        if self.md.efield_feedback:
            if scalar is None:
                raise ValueError("the feedback field needs the fix scalar")
            ez = -scalar / self.system.box[2]
            f = torch.stack([f[:, 0], f[:, 1], f[:, 2] + u.qe2f * q * ez],
                            dim=1)
        return f, pe

    # --------------------------------------------------------------- step
    @property
    def split_step(self) -> bool:
        """Whether the step reads a rebuild flag between ``_pre`` and
        ``_post``: the Verlet skin check, or on the tile path the mesh
        tiles' drift test."""
        return self.ncfg is not None or self.mesh_persist

    def derived_state(self, x):
        """(nbr, tasg) built at positions x: the Verlet list and the
        persistent mesh-tile assignment, each None when the engine keeps
        none."""
        nbr = tasg = None
        if self.ncfg is not None:
            nbr = build_neighbor_list(self.ncfg, x, self.tables, self.type_idx)
        if self.mesh_persist:
            tasg = pppm_ops.tile_assign(self.pppm_grid, x)
        return nbr, tasg

    def _pre(self, state: MDState):
        """The step up to the charge solve: thermostat half, kick, drift,
        SHAKE, zmirror and the rebuild check.  Returns (x, v, xi, vxi,
        flag): ``flag`` is the () bool device tensor of the Verlet skin check
        (LAMMPS Neighbor::check_distance), or on the tile path of the mesh
        tiles' drift test (JAX md.py:367-375); None when the step has
        neither."""
        with timers.layer("integrate.pre"):
            x, v, xi, vxi = self._half_pre(state)
            flag = None
            if self.ncfg is not None:
                flag = needs_rebuild(self.ncfg, state.nbr, x)
            elif self.mesh_persist:
                flag = pppm_ops.tile_drift_exceeded(self.pppm_grid,
                                                    state.tasg, x)
            return x, v, xi, vxi, flag

    def _half_pre(self, state: MDState):
        """The integrator's part of the step's first half: thermostat half,
        kick and drift (one K10 launch on the card), SHAKE, zmirror.
        Returns (x, v, xi, vxi)."""
        itg = self.integrator
        v, x, xi, vxi = integrate_half(itg, state.v, state.f, state.x,
                                       state.nhc_xi, state.nhc_vxi,
                                       ("nhc", "kick", "drift"))
        if self.cons is not None:
            x, dv = shake_positions(self.cons, x, state.x, itg.dt,
                                    box=self.ksp_force.box,
                                    periodic=self.system.periodic)
            v = v + dv
        if self.zmirror is not None:
            x = self.zmirror.apply(x, state.step_t + 1)
        return x, v, xi, vxi

    def _half_post(self, x, v, f, xi, vxi):
        """The integrator's part of the step's second half: kick, RATTLE,
        thermostat half (one K10 launch on the card without SHAKE; with it,
        K10's kick, K8, K10's thermostat half).  Returns (v, xi, vxi)."""
        itg = self.integrator
        if self.cons is None:
            v, _, xi, vxi = integrate_half(itg, v, f, x, xi, vxi,
                                           ("kick", "nhc"))
            return v, xi, vxi
        v = integrate_half(itg, v, f, x, xi, vxi, ("kick",))[0]
        v = rattle_velocities(self.cons, x, v, box=self.ksp_force.box,
                              periodic=self.system.periodic)
        v, _, xi, vxi = integrate_half(itg, v, f, x, xi, vxi, ("nhc",))
        return v, xi, vxi

    def _rebuild(self, x, nbr_old):
        """``derived_state`` at x, with the list's overflow flag kept sticky:
        a rebuild from NaN-poisoned positions must not clear it, so run()
        can see the cause.  The mesh-tile assignment shares the trigger."""
        nbr, tasg = self.derived_state(x)
        if nbr is not None:
            nbr.overflow = nbr.overflow | nbr_old.overflow
        return nbr, tasg

    def solves(self, step: int) -> bool:
        """Whether the step after the host step ``step`` takes the solve's
        branch: every ``nevery``-th step (fix_conp's Nevery; JAX
        md.py:380-407), every step without a solver."""
        return self.conp is None or (step + 1) % self.conp.cfg.nevery == 0

    def _solve_begin(self, state: MDState, x, nbr, tasg, solve: bool):
        """The step's charge solve up to its CG iterations
        (``ConpSolver.solve_begin``), or, on a step that skips the solve, a
        ``SolvePending`` without b that carries the electrolyte's k-space
        cache where the solve and the engine share a dtype (the force
        path's reuse holds on every step); None without a solver."""
        if self.conp is None:
            return None
        with timers.layer("solve"):
            if not solve:
                kcache = None
                if self.conp.solve_dtype == self.dtype:
                    kcache = self.conp.elyte_kcache(x, state.q, tasg)
                return SolvePending(b=None, kcache=kcache)
            return self.conp.solve_begin(x, state.q, nbr, self.ncfg, tasg,
                                         step=state.step_t + 1,
                                         scalar_prev=state.scalar_out)

    def _post_tail(self, state: MDState, x, v, xi, vxi, nbr, tasg,
                   pend) -> MDState:
        """The step from the end of the charge solve on: the charges and
        the fix scalar, forces, kick, RATTLE, thermostat half."""
        step_t = state.step_t + 1
        q, scalar, kcache = state.q, state.scalar_out, None
        if pend is not None and pend.b is None:
            kcache = pend.kcache
        elif pend is not None:
            with timers.layer("solve"):
                q, scalar, kcache = self.conp.solve_end(pend, x, q,
                                                        step=step_t)
        f, pe = self.compute_forces(x, q, kcache, nbr, tasg, scalar)
        with timers.layer("integrate.post"):
            v, xi, vxi = self._half_post(x, v, f, xi, vxi)
        return MDState(x=x, v=v, q=q, f=f, step=state.step + 1, nhc_xi=xi,
                       nhc_vxi=vxi, scalar_out=scalar, energy=pe, nbr=nbr,
                       tasg=tasg, step_t=step_t)

    def _post(self, state: MDState, x, v, xi, vxi, nbr, tasg,
              solve: Optional[bool] = None) -> MDState:
        """The step from the charge solve on: solve (``_solve_begin``, the CG
        blocks while their flag says so, one host read per block),
        forces, kick, RATTLE, thermostat half.  ``solve``: whether this
        step solves (None: ``solves(state.step)``)."""
        if solve is None:
            solve = self.solves(state.step)
        pend = self._solve_begin(state, x, nbr, tasg, solve)
        while pend is not None and self.conp.cg_active(pend):
            pend.cg = self.conp.cg_block(pend)
            self.cg_blocks += 1
        return self._post_tail(state, x, v, xi, vxi, nbr, tasg, pend)

    def step(self, state: MDState) -> MDState:
        """One eager step: ``_pre``, the host test of its skin flag (one
        host sync per step on the list paths) and ``_rebuild`` when it is
        set, then ``_post`` (with CG, one more host read per CG block).
        ``run`` replays the same segments as CUDA graphs on the card."""
        x, v, xi, vxi, flag = self._pre(state)
        nbr, tasg = state.nbr, state.tasg
        if flag is not None:
            timers.host_read("rebuild_flag")
        if flag is not None and bool(flag):
            nbr, tasg = self._rebuild(x, state.nbr)
            self.rebuilds += 1
        return self._post(state, x, v, xi, vxi, nbr, tasg)

    # -------------------------------------------------------------- setup
    @timers.span("setup.init_state")
    def init_state(self, x0=None, v0=None, q0=None) -> MDState:
        """Zero the velocities of atoms no integrator moves, build the list
        and mesh tiles, solve the initial charges, compute the first
        forces."""
        sys = self.system
        dev = self.type_idx.device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=dev)
        x = t(sys.x0 if x0 is None else x0)
        v = t(sys.v0 if v0 is None else v0)
        q = t(sys.q0 if q0 is None else q0)
        mobile = self.integrator.mobile_mask[:, None]
        v = torch.where(mobile, v, torch.zeros_like(v))
        ths = self.integrator.thermostats
        nt = max(len(ths), 1)
        tch = ths[0].tchain if len(ths) else 3
        zeros = torch.zeros((nt, tch), dtype=self.dtype, device=dev)
        st = MDState(x=x, v=v, q=q, f=torch.zeros_like(x), step=0,
                     nhc_xi=zeros, nhc_vxi=zeros.clone(),
                     scalar_out=torch.zeros((), dtype=(
                         self.dtype if self.conp is None
                         else self.conp.solve_dtype), device=dev),
                     energy=torch.zeros((), dtype=self.dtype, device=dev),
                     step_t=torch.zeros((), dtype=torch.int64, device=dev))
        return self._heal_state(st)

    def _solve_full(self, x, q, nbr, tasg, step):
        """A whole charge solve at x with no previous fix scalar (the
        set-up's and a heal's): (q, scalar, kcache)."""
        return self.conp.solve_full(x, q, nbr, self.ncfg, tasg, step=step)

    def _heal_state(self, state: MDState) -> MDState:
        """Rebuild the derived state (list, mesh tiles, electrode charges,
        forces) from x with the current capacities; positions, velocities
        and thermostat state pass through.  The solve is a step's solve
        (CG warm-started from the charges for CONP, cold for CONQ and
        COND, as the JAX package's init)."""
        nbr, tasg = self.derived_state(state.x)
        q, scalar, kcache = state.q, state.scalar_out, None
        if self.conp is not None:
            q, scalar, kcache = self._solve_full(state.x, state.q, nbr, tasg,
                                                 state.step_t)
        f, pe = self.compute_forces(state.x, q, kcache, nbr, tasg, scalar)
        return dataclasses.replace(state, q=q, f=f, scalar_out=scalar,
                                   energy=pe, nbr=nbr, tasg=tasg)

    # ---------------------------------------------------------------- run
    def thermo(self, state: MDState) -> dict:
        """One row of thermo scalars as in the reference decks'
        ``thermo_style custom step temp c_tempsl c_qleft c_qright c_dipole
        f_e`` (tests/cond/input:74), plus the potential energy; ``f_e`` is
        the fix scalar: the CONP induced charge, the CONQ or the COND
        potential difference."""
        u = self.units
        itg = self.integrator
        nall = self.system.natoms
        ncons = 0 if self.cons is None else self.cons.ncons
        t_all = group_temperature(state.v, itg.mass,
                                  torch.ones_like(itg.mobile_mask),
                                  float(3 * nall - 3 - ncons), u)
        if self.nsol is not None:
            sol = self.sol_mask
            t_sl = group_temperature(state.v, itg.mass, sol,
                                     float(3 * self.nsol - 3
                                           - self.ncons_sol), u)
            dipole = torch.sum(torch.where(sol, state.q * state.x[:, 2],
                                           torch.zeros_like(state.q)))
        else:
            t_sl = t_all
            dipole = torch.sum(state.q * state.x[:, 2])
        zq = torch.zeros_like(state.q)
        return dict(step=state.step, temp=t_all, tempsl=t_sl,
                    qleft=torch.sum(torch.where(self.left_mask, state.q, zq)),
                    qright=torch.sum(torch.where(self.right_mask, state.q, zq)),
                    dipole=dipole, f_e=state.scalar_out.to(state.energy.dtype),
                    pe=state.energy)

    def _grow_neighbor_capacity(self) -> None:
        """Double the cell capacity, K and U after a list overflow, or the
        cell list's capacity (JAX md.py:544-558)."""
        if self.ncfg is not None:
            g = self.ncfg.grid
            self.ncfg = dataclasses.replace(
                self.ncfg, grid=dataclasses.replace(g, cap=2 * g.cap),
                k_max=2 * self.ncfg.k_max, u_max=2 * self.ncfg.u_max)
        elif self.cell_grid is not None:
            self.cell_grid = dataclasses.replace(self.cell_grid,
                                                 cap=2 * self.cell_grid.cap)

    def _grow_pair_cap(self) -> None:
        """Double the tile path's live tile-pair capacity after K4 came
        back NaN (JAX md.py:566-571); ``pair_forces`` clamps it to every
        tile pair."""
        self.pair_cap = 2 * int(self.pair_cap)

    def graph_caps(self) -> tuple:
        """The capacities a set of step graphs is captured at
        (``graphs.graph_key``): the list's K, U and cell cap, the mesh tile
        cap, the cell list's cap and the tile path's pair cap."""
        ncfg, grid, cells = self.ncfg, self.pppm_grid, self.cell_grid
        return (None if ncfg is None
                else (ncfg.k_max, ncfg.u_max, ncfg.grid.cap),
                None if grid is None else grid.tile_cap,
                None if cells is None else cells.cap, self.pair_cap)

    def _mesh_tiled(self) -> bool:
        return (self.pppm_grid is not None
                and not pppm_ops._use_dense(self.pppm_grid,
                                            self.system.natoms))

    def _grow_tile_capacity(self) -> None:
        """Double the mesh tile slot capacity after an occupancy overflow
        (the tiled spread/gather NaN-poison; no sticky flag reaches the
        state, so run() retries a bounded number of times)."""
        geom = pppm_ops._tile_geometry(self.pppm_grid, self.system.natoms)
        self.pppm_grid = dataclasses.replace(
            self.pppm_grid,
            tile_cap=min(2 * geom.cap, self.system.natoms + 1))
        if self.conp is not None and self.conp.pppm_grid is not None:
            self.conp.pppm_grid = self.pppm_grid

    def run(self, state: MDState, nsteps: int, *, thermo_every: int = 1):
        """``nsteps`` steps; returns (final_state, thermo) where thermo maps
        each thermo key to a tensor of the rows taken every
        ``thermo_every`` steps (None when thermo_every is 0).

        On the CPU a Python loop of ``step``.  On CUDA the step's segments
        are replayed as CUDA graphs (``models/graphs.py``), captured once
        per set of capacities; a capture or replay error raises.

        If the run ends NaN-poisoned through a list overflow (sticky
        ``nbr.overflow``), or with no such flag on the tiled mesh, the cell
        list or the tile path, every capacity in play is grown, the derived
        state rebuilt from the entry state, and the whole run repeated (at
        most 3 times), as the JAX engine does (md.py:606-628)."""
        def execute(st):
            if graphs.replayed(st):
                return graphs.step_graphs(self, st).run(st, nsteps,
                                                        thermo_every)
            rows = []
            for i in range(nsteps):
                st = self.step(st)
                if thermo_every and (i + 1) % thermo_every == 0:
                    rows.append(self.thermo(st))
            return st, stack_thermo(rows)

        final, th = execute(state)
        for _ in range(3):
            timers.host_read("energy")
            if math.isfinite(float(final.energy)):
                break
            if self.ncfg is not None and state.nbr is not None:
                timers.host_read("overflow_flag")
            if (self.ncfg is not None and state.nbr is not None
                    and bool(final.nbr.overflow)):
                self._grow_neighbor_capacity()
            elif (self._mesh_tiled() or self.cell_grid is not None
                  or self.pair_cap is not None):
                # no sticky flag tells these overflows (or a physics NaN)
                # apart: grow each capacity in play, a bounded number of
                # times
                if self._mesh_tiled():
                    self._grow_tile_capacity()
                if self.cell_grid is not None:
                    self._grow_neighbor_capacity()
                if self.pair_cap is not None:
                    self._grow_pair_cap()
            else:
                break
            state = self._heal_state(state)
            final, th = execute(state)
        return final, (th if thermo_every else None)


def stack_thermo(rows) -> dict:
    """The thermo rows of a run as one tensor per key (the steps on the
    host); {} when the run took none."""
    th = {}
    for k in (rows[0] if rows else {}):
        if k == "step":
            th[k] = torch.tensor([r[k] for r in rows])
        else:
            th[k] = torch.stack([r[k] for r in rows])
    return th


def kernels_run(device, dtype) -> bool:
    """Whether the hand kernels run for an engine on ``device`` in
    ``dtype`` (CUDA float32): the condition under which ``build_engine``
    takes the paths the JAX engine takes on its accelerator (the block
    list for "auto", K4 over k-d bricks for "tile")."""
    return device.type == "cuda" and dtype == torch.float32


# the pair paths of the JAX engine (MDConfig.pair_path)
PAIR_PATHS = ("auto", "dense", "nlist", "block", "cell", "tile")


def _check_supported(system: System, md: MDConfig) -> None:
    """Raise NotImplementedError, naming the feature, for every setting the
    port does not cover: a pair path the JAX engine does not name."""
    if md.pair_path not in PAIR_PATHS:
        raise NotImplementedError(f"not ported: pair_path={md.pair_path!r}")


@timers.span("setup.engine")
def build_engine(system: System, md: MDConfig,
                 conp: Optional[ConpSolver] = None, *,
                 dtype=DEFAULT_DTYPE, device=None) -> Engine:
    """The engine for ``md`` on ``device`` (None: the card; raises when no
    CUDA device is visible): the pair path, the k-space and the capacities
    chosen as the JAX package chooses them, the SHAKE cluster tables built
    once as device buffers.  Raises NotImplementedError for configurations
    that need a part that is not ported yet."""
    _check_supported(system, md)
    device = resolve_device(device)
    u = system.units()
    on_card = kernels_run(device, dtype)
    pppm_grid = fksp = None
    if conp is not None:
        # the forces take the charge solve's k-space, as in the JAX
        # package: a PPPM solve gives PPPM forces (the decks' PPPM trials
        # set the fix's kspace only); an Ewald solve under PPPM forces is
        # refused (the JAX engine cannot run it either)
        if conp.pppm_grid is None and md.kspace_style is KSpaceStyle.PPPM:
            raise NotImplementedError(
                "not ported yet: an Ewald charge solve with PPPM forces")
        ksp = conp.ksp
        pppm_grid = conp.pppm_grid
        # the engine's own factored tables in its own dtype (a mixed
        # precision solve keeps its own); none under PPPM, where a
        # CG_MATFREE solver keeps them for its operator only
        if pppm_grid is None:
            fksp = (conp.fksp if conp.solve_dtype == dtype
                    else ewf.factorize(ksp, device=device, dtype=dtype))
    else:
        q2 = float((system.q0 ** 2).sum()) * u.qqr2e
        acc_abs = md.kspace_accuracy * u.qqr2e
        slabflag = md.slab is not None
        g = md.g_ewald or ewald_ops.determine_g_ewald_box(
            acc_abs, md.cutoff, system.natoms, max(q2, 1e-10), *system.box)
        ksp = ewald_ops.setup_ewald(
            box=system.box, accuracy_abs=acc_abs, g_ewald=g,
            natoms=system.natoms, q2=max(q2, 1e-10),
            slabflag=slabflag, slab_volfactor=md.slab if slabflag else 1.0)
        if md.kspace_style is KSpaceStyle.PPPM:
            pppm_grid = pppm_ops.with_tile_cap(pppm_ops.setup_pppm(
                box=system.box, box_lo=tuple(system.box_lo),
                accuracy_abs=acc_abs, natoms=system.natoms, q2=max(q2, 1e-10),
                cutoff=md.cutoff, slabflag=slabflag,
                slab_volfactor=md.slab if slabflag else 1.0,
                g_ewald=ksp.g_ewald, device=device), system.x0)
        else:
            fksp = ewf.factorize(ksp, device=device, dtype=dtype)

    # pair path: "auto" takes the Verlet list for big N in a box at least 4
    # cutoffs wide, in block form exactly where the block CUDA kernel runs;
    # "tile" is K4 over k-d bricks on the card in float32 and, as in the
    # JAX engine off its accelerator, the list (big N) or dense elsewhere
    big_n = (system.natoms > DENSE_MAX_ATOMS
             and all(b >= 4.0 * md.cutoff for b in system.box))
    want_tile = md.pair_path == "tile" and on_card
    want_block = md.pair_path == "block" or (md.pair_path == "auto" and big_n
                                             and on_card)
    want_nlist = (want_block or md.pair_path == "nlist"
                  or (md.pair_path in ("auto", "tile") and big_n
                      and not want_tile))
    cell_grid = None
    if md.pair_path == "cell":
        cell_grid = build_cell_grid(system.box, tuple(system.box_lo),
                                    md.cutoff, system.natoms,
                                    periodic=system.periodic)
    pair_order, pair_cap = "z", None
    if want_tile:
        # k-d bricks of TILE atoms, the 3-D culled live tile pairs; the cap
        # from x0 with headroom, regrown by run() (JAX md.py:785-795)
        pair_order = "kd"
        cnt = pair_tile_count(torch.as_tensor(system.x0, dtype=dtype,
                                              device=device),
                              box=system.box, periodic=system.periodic,
                              cutoff=md.cutoff, order=pair_order)
        pair_cap = int(math.ceil(cnt * 1.5)) + 8
    ncfg = None
    if want_nlist:
        ncfg = make_neighbor_config(
            system.box, tuple(system.box_lo), md.cutoff, system.natoms,
            periodic=system.periodic, skin=md.neighbor_skin,
            k_max=md.neighbor_kmax, x0=system.x0,
            block=8 if want_block else 0, device=device)
        if ncfg.block:
            # U from the exact max union width at x0 (1.3x, lane-rounded)
            base = dataclasses.replace(ncfg, block=0, u_max=0)
            x0t = torch.as_tensor(system.x0, dtype=dtype, device=device)
            nl0 = build_neighbor_list(
                base, x0t, make_pair_tables(system.lj_eps, system.lj_sigma,
                                            device=device, dtype=dtype),
                torch.as_tensor(system.type, device=device))
            ucnt = max_union_count(ncfg, x0t, nl0)
            ncfg = dataclasses.replace(
                ncfg, u_max=int(np.ceil(ucnt * 1.3 / 8.0) * 8) + 8)

    # the persistent mesh-tile assignment stays exact iff skin/2 fits the
    # tile drift margin on every axis (else per-step binning)
    mesh_persist = False
    tiled = (pppm_grid is not None
             and not pppm_ops._use_dense(pppm_grid, system.natoms))
    if tiled and ncfg is not None:
        g = pppm_grid
        min_cell = min(g.box[0] / g.nx, g.box[1] / g.ny, g.zprd_grid / g.nz)
        mesh_persist = 0.5 * ncfg.skin <= pppm_ops.TILE_DM * min_cell
    elif tiled and want_tile:
        # the tile path has no skin bound: the assignment carries its own
        # drift reference (tile_drift_exceeded; JAX md.py:820-824)
        mesh_persist = True

    cons = build_constraints(system, md.shake, dtype=dtype, device=device)
    thermos = [make_nhc_params(
        system.groups[tc.group], tc.t_start, tc.t_stop, tc.damp,
        nconstraints=(0 if cons is None
                      else cons.n_in_group(system.groups[tc.group])),
        tchain=tc.tchain, device=device) for tc in md.thermostats]
    # LAMMPS semantics: only atoms in some integrator fix move
    if md.thermostats:
        mobile = np.zeros(system.natoms, bool)
        for tc in md.thermostats:
            mobile |= system.groups[tc.group]
    else:
        mobile = system.mobile_mask
    integrator = Integrator(
        dt=md.dt, units=u,
        mass=torch.as_tensor(system.mass, dtype=dtype, device=device),
        mobile_mask=torch.as_tensor(mobile, device=device),
        thermostats=thermos)
    zmirror = None
    if md.zmirror is not None:
        zm = md.zmirror
        zmirror = build_zmirror(system, zm.group1, zm.group2, zm.every,
                                device=device)
    return Engine(system=system, md=md, conp=conp, integrator=integrator,
                  cons=cons, ksp_force=ksp, fksp=fksp, pppm_grid=pppm_grid, ncfg=ncfg,
                  mesh_persist=mesh_persist, dtype=dtype, device=device,
                  zmirror=zmirror, cell_grid=cell_grid, pair_order=pair_order,
                  pair_cap=pair_cap)
