"""The MD engine: velocity Verlet with the charge solve in pre-force position.

Step order (LAMMPS Verlet::run, FixConp::pre_force fix_conp.cpp:543-573):
  NHC half -> kick half -> drift -> charge solve -> forces
  -> post-force CONP correction -> kick half -> NHC half

``step`` is a plain function of tensors and ``run`` a Python loop of steps.
The path is the JAX engine's mid-size path: factored Ewald with the
per-step tables shared between the charge solve and the forces, the pair
sweep (``ops/kernels/pair_kernel``) with the CONP Gaussian correction fused
in, and the electrode b rows (``ops/kernels/ele_rows_kernel``).  On CUDA
float32 both sweeps are CUDA kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import ewald as ewald_ops
from ..ops import ewald_factored as ewf
from ..ops.bonded import bonded_forces
from ..ops.kernels.pair_kernel import pair_forces
from ..ops.pairs import PairTables, exclusions_tensors, make_pair_tables
from ..utils.config import KSpaceStyle, MDConfig
from .conp import ConpSolver
from .electrodes import MY_PIS
from .integrate import Integrator, group_temperature, make_nhc_params
from .system import MDState, System, exclusion_lists

# the JAX engine switches to a Verlet neighbor list above this atom count
# when the box is at least 4 cutoffs wide (models/md.py build_engine)
DENSE_MAX_ATOMS = 8192


class Engine(nn.Module):
    """One MD engine; constant tensors are buffers (``.to(device)`` moves
    them), the configuration is plain attributes."""

    def __init__(self, *, system: System, md: MDConfig,
                 conp: Optional[ConpSolver], integrator: Integrator,
                 ksp_force: ewald_ops.EwaldKSpace, fksp: ewf.FactoredKSpace,
                 dtype, device):
        super().__init__()
        self.system = system
        self.md = md
        self.conp = conp
        self.integrator = integrator
        self.ksp_force = ksp_force
        self.fksp = fksp
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
        if conp is not None:
            kern = conp.kernels
            self.register_buffer("ele_flag", f(system.elecheck != 0))
            self.register_buffer("elyte_flag", f(conp.elyte_mask))
            self.register_buffer("eta_tab", f(kern.eta_ij))
            self.register_buffer("fo_tab", f(kern.fo_ij))
            self.register_buffer("self_diag", f(kern.self_diag))
        # thermo groups: the solvent (or the first thermostat's group) and
        # the two electrodes
        sol = system.groups.get("sol")
        if sol is None and md.thermostats:
            sol = system.groups[md.thermostats[0].group]
        self.nsol = None if sol is None else int(np.sum(sol))
        if sol is not None:
            self.register_buffer("sol_mask", torch.as_tensor(sol, device=device))
        self.register_buffer("left_mask", torch.as_tensor(
            system.ele_left_mask, device=device))
        self.register_buffer("right_mask", torch.as_tensor(
            system.ele_right_mask, device=device))

    @property
    def tables(self) -> PairTables:
        return PairTables(*self.lj_tab)

    @property
    def exclusions(self):
        return (self.excl_idx, self.excl_val) if self.has_excl else None

    # ------------------------------------------------------------- forces
    def compute_forces(self, x, q, kcache=None):
        """Returns (f, pe) for the current configuration.  ``kcache`` is the
        charge solve's (axis_tables, Sr_elyte, Si_elyte, zsort) at the same
        positions, or None."""
        sys = self.system
        u = self.units
        box = self.ksp_force.box
        zsort = kcache[3] if kcache is not None else None
        fuse = None
        if self.conp is not None:
            fuse = (self.ele_flag, self.elyte_flag, self.eta_tab, self.fo_tab)
        out = pair_forces(
            x, q, self.type_idx, self.tables, self.exclusions, box=box,
            periodic=sys.periodic, cutoff=self.md.cutoff,
            g_ewald=self.ksp_force.g_ewald, qqr2e=u.qqr2e, zsort=zsort,
            conp_fuse=fuse)
        f, evdwl, ecoul = out[:3]
        pe = evdwl + ecoul
        if self.has_bonded:
            fba, eba = bonded_forces(
                x, self.bonds, self.bond_coeffs, self.angles,
                self.angle_coeffs, box=box, periodic=sys.periodic)
            f = f + fba
            pe = pe + eba
        if kcache is not None:
            tabs, sre, sie, _ = kcache
            ek, fk = ewf.energy_forces_cached(self.fksp, q, tabs, sre, sie,
                                              self.conp.ne)
        else:
            ek, fk = ewf.energy_forces_f(self.fksp, x, q)
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
            # CONP post-force: the pair sweep already folded the Gaussian
            # correction forces into f; add the correction energy and the
            # ETA self energy qqr2e*eta*sum q^2/(sqrt2*sqrt(pi))
            # == qqr2e/2 * sum(self_diag q^2)
            qsq_ele = torch.sum(torch.where(
                self.elecheck != 0, self.self_diag * q * q,
                torch.zeros_like(q)))
            pe = pe + u.qqr2e * 0.5 * qsq_ele + out[3]
        return f, pe

    # --------------------------------------------------------------- step
    def step(self, state: MDState) -> MDState:
        itg = self.integrator
        v, xi, vxi = itg.thermostat_half(state.v, state.nhc_xi, state.nhc_vxi)
        v = itg.kick(v, state.f)
        x = itg.drift(state.x, v)
        q, scalar, kcache = state.q, state.scalar_out, None
        if self.conp is not None:
            q, scalar, kcache = self.conp.solve_full(x, q)
        f, pe = self.compute_forces(x, q, kcache)
        v = itg.kick(v, f)
        v, xi, vxi = itg.thermostat_half(v, xi, vxi)
        return MDState(x=x, v=v, q=q, f=f, step=state.step + 1, nhc_xi=xi,
                       nhc_vxi=vxi, scalar_out=scalar, energy=pe)

    # -------------------------------------------------------------- setup
    def init_state(self, x0=None, v0=None, q0=None) -> MDState:
        """Zero the velocities of atoms no integrator moves, solve the
        initial charges, compute the first forces."""
        sys = self.system
        dev = self.type_idx.device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=dev)
        x = t(sys.x0 if x0 is None else x0)
        v = t(sys.v0 if v0 is None else v0)
        q = t(sys.q0 if q0 is None else q0)
        mobile = self.integrator.mobile_mask[:, None]
        v = torch.where(mobile, v, torch.zeros_like(v))
        scalar = torch.zeros((), dtype=self.dtype, device=dev)
        kcache = None
        if self.conp is not None:
            q, scalar, kcache = self.conp.solve_full(x, q)
        f, pe = self.compute_forces(x, q, kcache)
        ths = self.integrator.thermostats
        nt = max(len(ths), 1)
        tch = ths[0].tchain if len(ths) else 3
        zeros = torch.zeros((nt, tch), dtype=self.dtype, device=dev)
        return MDState(x=x, v=v, q=q, f=f, step=0, nhc_xi=zeros,
                       nhc_vxi=zeros.clone(), scalar_out=scalar, energy=pe)

    # ---------------------------------------------------------------- run
    def thermo(self, state: MDState) -> dict:
        """One row of thermo scalars as in the reference decks'
        ``thermo_style custom step temp c_tempsl c_qleft c_qright c_dipole
        f_e`` (tests/cond/input:74), plus the potential energy."""
        u = self.units
        itg = self.integrator
        nall = self.system.natoms
        t_all = group_temperature(state.v, itg.mass,
                                  torch.ones_like(itg.mobile_mask),
                                  float(3 * nall - 3), u)
        if self.nsol is not None:
            sol = self.sol_mask
            t_sl = group_temperature(state.v, itg.mass, sol,
                                     float(3 * self.nsol - 3), u)
            dipole = torch.sum(torch.where(sol, state.q * state.x[:, 2],
                                           torch.zeros_like(state.q)))
        else:
            t_sl = t_all
            dipole = torch.sum(state.q * state.x[:, 2])
        zq = torch.zeros_like(state.q)
        return dict(step=state.step, temp=t_all, tempsl=t_sl,
                    qleft=torch.sum(torch.where(self.left_mask, state.q, zq)),
                    qright=torch.sum(torch.where(self.right_mask, state.q, zq)),
                    dipole=dipole, f_e=state.scalar_out, pe=state.energy)

    def run(self, state: MDState, nsteps: int, *, thermo_every: int = 1):
        """``nsteps`` steps; returns (final_state, thermo) where thermo maps
        each thermo key to a tensor of the rows taken every
        ``thermo_every`` steps (None when thermo_every is 0)."""
        rows = []
        for i in range(nsteps):
            state = self.step(state)
            if thermo_every and (i + 1) % thermo_every == 0:
                rows.append(self.thermo(state))
        if not thermo_every:
            return state, None
        th = {}
        for k in (rows[0] if rows else {}):
            if k == "step":
                th[k] = torch.tensor([r[k] for r in rows])
            else:
                th[k] = torch.stack([r[k] for r in rows])
        return state, th


def _check_supported(system: System, md: MDConfig) -> None:
    """Raise NotImplementedError, naming the feature, for every setting the
    port does not cover yet."""
    missing = []
    if md.shake is not None:
        missing.append("SHAKE/RATTLE")
    if md.zmirror is not None:
        missing.append("zmirror")
    if md.efield is not None or md.efield_feedback:
        missing.append("external / feedback efield")
    if md.kspace_style is not KSpaceStyle.EWALD:
        missing.append(f"{md.kspace_style.name} k-space")
    if md.pair_path not in ("auto", "dense"):
        missing.append(f"pair_path={md.pair_path!r}")
    big_n = (system.natoms > DENSE_MAX_ATOMS
             and all(b >= 4.0 * md.cutoff for b in system.box))
    if md.pair_path == "auto" and big_n:
        missing.append(f"Verlet neighbor list (N = {system.natoms} > "
                       f"{DENSE_MAX_ATOMS} in a box >= 4 cutoffs wide)")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def build_engine(system: System, md: MDConfig,
                 conp: Optional[ConpSolver] = None, *,
                 dtype=torch.float64, device=None) -> Engine:
    """The engine for the mid-size path (dense pair sweep, factored Ewald,
    INV solve); raises NotImplementedError for configurations that need a
    part that is not ported yet."""
    _check_supported(system, md)
    u = system.units()
    if conp is not None:
        if conp.solve_dtype != dtype:
            raise NotImplementedError(
                "not ported yet: mixed precision (solve dtype "
                f"{conp.solve_dtype} != engine dtype {dtype})")
        ksp = conp.ksp
        fksp = conp.fksp
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
        fksp = ewf.factorize(ksp, device=device, dtype=dtype)
        if fksp.nxy > ewf.KXY_CHUNK:
            raise NotImplementedError(
                f"not ported yet: chunked factored Ewald ({fksp.nxy} xy "
                f"vectors > KXY_CHUNK={ewf.KXY_CHUNK})")

    thermos = [make_nhc_params(system.groups[tc.group], tc.t_start,
                               tc.t_stop, tc.damp, tchain=tc.tchain,
                               device=device)
               for tc in md.thermostats]
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
    return Engine(system=system, md=md, conp=conp, integrator=integrator,
                  ksp_force=ksp, fksp=fksp, dtype=dtype, device=device)
