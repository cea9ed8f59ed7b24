"""The constant-potential / constant-charge / constant-displacement charge
solve (CONP, CONQ and COND modes, INV solver).

Per-step math (fix_conp.cpp:543-573 pre_force; 1120-1161 update_charge;
fix_conq.cpp:41-90; fix_cond.cpp:46-126):

    b_i = -phi_i(electrolyte)        [k-space + real-space erfc + slab]
    q_ele = A^-1 b + dV * A^-1 d  (+ q_init)

with dV the applied potential (CONP), the feedback value
-(Q_R - sum_R A^-1 b)/totsetq (CONQ), or the finite-field gain
vmult*(Q_R - dipole/Lz - <setzvec, A^-1 b>) (COND).

The setup (A, its inverse and projection, d, elesetq) runs once in float64
on the CPU; the context is then cast to the run dtype and moved to the run
device.  The k-space part of b is the factored Ewald sum (EWALD) or the
mesh (PPPM: electrolyte spread, Poisson solve, readout on the electrodes'
z planes, or through the full inverse FFT and the stencil readout where the
electrodes are not confined to a few planes); A is assembled from the
exact Ewald sum in both, as the reference does (pppm_conp.cpp:91-101).  The real-space rows come from the
Verlet list when the engine keeps one, else from the K5 sweep.  The CG
solvers are still to come: ``setup_conp`` raises NotImplementedError for
them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import ewald as ewald_ops
from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.erfc import ERFC_MAX
from ..ops.kernels.ele_rows_kernel import b_realspace
from ..ops.kernels.zorder import z_perm
from ..ops.neighbors import b_realspace_from_list
from ..ops.pairs import gauss_table_kernels
from ..utils.config import (ConpConfig, FFMode, KSpaceStyle, MDConfig, Mode,
                            PairMode, Solver)
from ..utils.device import DEFAULT_DTYPE, resolve_device
from .electrodes import (ConpContext, ElectrodeKernels, assemble_amatrix,
                         build_d_vector, make_kernels, project_inverse)
from .system import System


# the context's tensors the solver keeps as buffers
CTX_TENSORS = ("ainv", "d", "elesetq", "totsetq", "eleinitq", "elecheck_ele",
               "setzvec", "vmult")


class ConpSolver(nn.Module):
    """Static configuration plus the device context of the charge solve.
    Every tensor is a buffer, so ``.to(device)`` moves the whole solver."""

    def __init__(self, *, cfg: ConpConfig, ksp: ewald_ops.EwaldKSpace,
                 kernels: ElectrodeKernels,
                 fksp: Optional[ewf.FactoredKSpace], ctx: ConpContext,
                 ele_idx: np.ndarray, elyte_mask: np.ndarray,
                 type_idx: np.ndarray, box, periodic, cut_coulsq: float,
                 ee_diag: float, solve_dtype, pppm_grid=None,
                 ele_zplanes=None, ele_zpinv=None,
                 one_electrode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ksp = ksp
        self.kernels = kernels
        self.fksp = fksp                       # factored Ewald (EWALD) or None
        self.pppm_grid = pppm_grid             # PPPMGrid (PPPM) or None
        # (P,) z nodes of the electrodes and the (nz,) node -> plane map (-1
        # off the set), or None: the electrodes are read through the full
        # mesh
        self.ele_zplanes = ele_zplanes
        self.ele_zpinv = ele_zpinv
        self.ele_idx = ele_idx                 # (Ne,) host copy
        self.elyte_mask = elyte_mask           # (N,) host copy, bool
        self.type_idx = type_idx               # (N,) host copy
        self.box = box
        self.periodic = periodic
        self.cut_coulsq = cut_coulsq           # min(coul cut^2, ERFC_MAX^2/g^2)
        self.ee_diag = ee_diag                 # <e,e> diagnostic
        self.solve_dtype = solve_dtype
        self.one_electrode = one_electrode     # group1 == group2
        dev = ctx.ainv.device
        te = type_idx[ele_idx]
        f = lambda a: torch.as_tensor(a, dtype=solve_dtype, device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                        device=dev)
        self.register_buffer("ele_idx_t", i64(ele_idx))
        self.register_buffer("type_t", i64(type_idx))
        self.register_buffer("elyte_t", torch.as_tensor(elyte_mask, device=dev))
        self.register_buffer("elyte_f", f(elyte_mask))
        self.register_buffer("eta_rows", f(kernels.eta_ij[te]))
        self.register_buffer("fo_rows", f(kernels.fo_ij[te]))
        # the (T+1, T+1) width and overlap tables the per-step EHGO
        # kernels gather (``step_kernels``)
        self.register_buffer("eta_tab", f(kernels.eta_ij))
        self.register_buffer("fo_tab", f(kernels.fo_ij))
        for name in CTX_TENSORS:
            self.register_buffer(name, getattr(ctx, name))

    @property
    def ne(self) -> int:
        return len(self.ele_idx)

    @property
    def ctx(self) -> ConpContext:
        return ConpContext(ele_idx=self.ele_idx_t, **{
            name: getattr(self, name) for name in CTX_TENSORS})

    @property
    def step_kernels(self):
        """(potential, force) of the per-step list sweeps on the solver's
        device and dtype: ETA's closures over its one width, or EHGO's
        kernels over the type tables ``eta_tab`` and ``fo_tab``."""
        if self.cfg.pairmode is PairMode.ETA:
            return self.kernels.potential, self.kernels.force
        return gauss_table_kernels(self.eta_tab, self.fo_tab)

    def load_context(self, ctx: ConpContext) -> None:
        """Replace the solve context (e.g. one built by ``interop``)."""
        for name in CTX_TENSORS:
            buf = getattr(self, name)
            setattr(self, name, getattr(ctx, name).to(buf.device, buf.dtype))

    # ----------------------------------------------------------------- b
    def elyte_kcache(self, x, q, tasg=None):
        """The electrolyte's k-space cache at these positions, shared with
        the force path.  EWALD: (axis_tables, Sr_elyte, Si_elyte, zsort),
        the per-step phase tables, the electrolyte structure factor and the
        z ordering shared by both CUDA sweeps.  PPPM: (rhok_elyte, slots),
        the electrolyte's half-spectrum density and the tile binning (slots
        None on the dense mesh), refreshed under the persistent assignment
        ``tasg`` when there is one (pppm_conp.cpp:428-450 reuse)."""
        q_elyte = torch.where(self.elyte_t, q, torch.zeros_like(q))
        if self.pppm_grid is not None:
            grid = self.pppm_grid
            slots = None
            if tasg is not None:
                slots = pppm_ops.refresh_tile_slots(grid, tasg, x, q_elyte)
            elif not pppm_ops._use_dense(grid, x.shape[0]):
                slots = pppm_ops.tile_slots(grid, x, q_elyte)
            return (pppm_ops.spread_rhok(grid, x, q_elyte, slots=slots),
                    slots)
        tabs = ewf.axis_tables(self.fksp, x)
        sr, si = ewf.structure_factor_tab(tabs, q_elyte)
        return (tabs, sr, si, z_perm(x, self.box, self.periodic))

    def b_vector_full(self, x, q, nbr=None, ncfg=None, tasg=None):
        """Assemble b for the current electrolyte configuration.

        k-space: b_i -= sum_k 2 ug_k (c_i ReS + s_i ImS)   [km_ewald.cpp:789-825]
                 or the mesh potential at the electrodes    [pppm_conp.cpp:269-316]
        real:    b_i -= sum_(elyte j in range) q_j (erfc(g r)/r + pot(r))
                                                            [fix_conp.cpp:1281-1365]
        slab:    b_i -= z_i * (4 pi / V) sum_elyte q_j z_j  [km_ewald.cpp:827-847]
        ``nbr``/``ncfg``: the engine's Verlet list, whose electrode rows
        then give the real-space part.  Returns (b, kcache)."""
        ne = self.ne
        q_elyte = torch.where(self.elyte_t, q, torch.zeros_like(q))
        kcache = self.elyte_kcache(x, q, tasg)
        zsort = None
        if self.pppm_grid is not None and self.ele_zplanes is not None:
            # the electrodes sit on a few z planes: read u there with a
            # small z-DFT matmul and P plane FFTs, no full inverse FFT
            grid = self.pppm_grid
            up = pppm_ops.u_on_zplanes(grid, kcache[0], self.ele_zplanes)
            b = -pppm_ops.gather_zplanes(grid, up, x[:ne], self.ele_zpinv)
        elif self.pppm_grid is not None:
            # rough, z-extended or mobile electrodes: the full potential
            # mesh and the stencil readout (tiled above the dense bound)
            u = pppm_ops.poisson_u_from_k(self.pppm_grid, kcache[0])
            b = -pppm_ops.gather(self.pppm_grid, u, x[:ne])
        else:
            tabs, sr, si, zsort = kcache
            (pr, pi), (zr, zi) = tabs
            tabs_e = ((pr[:ne], pi[:ne]), (zr[:ne], zi[:ne]))
            b = -ewf.potential_on_points_tab(tabs_e, sr, si, self.fksp.ug_t)
        if nbr is not None and ncfg is not None:
            b = b + b_realspace_from_list(
                ncfg, nbr, x, q_elyte, self.ele_idx_t, self.elyte_t,
                self.type_t, self.step_kernels[0], g_ewald=self.ksp.g_ewald,
                cut_coulsq=self.cut_coulsq)
        else:
            b = b + b_realspace(
                x, q_elyte, self.ele_idx_t, self.elyte_f, self.eta_rows,
                self.fo_rows, self.type_t, box=self.box,
                periodic=self.periodic, cut_coulsq=self.cut_coulsq,
                g_ewald=self.ksp.g_ewald, zsort=zsort)
        if self.ksp.slabflag:
            slabcorr = (4.0 * math.pi / self.ksp.volume) * torch.sum(
                q_elyte * x[:, 2])
            b = b - x[:ne, 2] * slabcorr
        return b, kcache

    # ------------------------------------------------------------- solve
    def apply_ainv(self, b):
        """A^-1 b in b's dtype.  A^-1 stays float64 on the device in every
        solve dtype and the product accumulates in float64: the projected
        inverse's rows cancel, and a float32 sum over Ne terms loses what
        the charges need (cuBLAS's float32 matvec: 3e-4 of A^-1 b at Ne =
        4,992, the doubled il cell; PERF.md)."""
        return (self.ainv @ b.to(self.ainv.dtype)).to(b.dtype)

    def target(self, step):
        """The fix's target at ``step`` (the step being computed, a () int64
        tensor): a constant as a Python float; a callable target gets the
        step as a () tensor of the solve dtype (integral values), and a
        Python number it returns becomes a () tensor on the device."""
        tgt = self.cfg.target
        if not callable(tgt):
            return float(tgt)
        if step is None:
            raise ValueError("a callable target needs the step counter")
        out = tgt(step.to(self.solve_dtype))
        if isinstance(out, torch.Tensor):
            return out.to(self.solve_dtype)
        return torch.full((), float(out), dtype=self.solve_dtype,
                          device=step.device)

    def solve_full(self, x, q, nbr=None, ncfg=None, tasg=None, step=None):
        """One charge update at the step ``step`` (a () int64 device
        tensor; read by callable targets only).  Returns (q_new, scalar,
        kcache); scalar is the fix's output: the CONP induced charge
        dV*totsetq + sum_left(A^-1 b) (fix_conp.cpp:1159), the CONQ
        potential difference (fix_conq.cpp:78) or the COND one
        (fix_cond.cpp:115)."""
        b, kcache = self.b_vector_full(x, q, nbr, ncfg, tasg)
        eleallq = self.apply_ainv(b)
        target = self.target(step)
        zero = torch.zeros_like(eleallq)
        left_sum = torch.sum(torch.where(self.elecheck_ele == 1, eleallq,
                                         zero))
        mode = self.cfg.mode
        if mode is Mode.CONP:
            potdiff = target
            scalar = potdiff * self.totsetq + left_sum
        elif mode is Mode.CONQ:
            scalar = -(target + left_sum) / self.totsetq
            if self.one_electrode:
                scalar = scalar + 2.0 * target / self.totsetq  # fix_conq.cpp:79
            potdiff = scalar
        else:   # COND: the electrolyte's dipole from these coordinates
            dipole = -torch.sum(torch.where(self.elyte_t, q,
                                            torch.zeros_like(q)) * x[:, 2])
            potdiff = self.vmult * (target - dipole / self.box[2]
                                    - torch.sum(self.setzvec * eleallq))
            scalar = potdiff
        q_ele = eleallq + potdiff * self.elesetq + self.eleinitq
        return torch.cat([q_ele.to(q.dtype), q[self.ne:]]), scalar, kcache


def _check_supported(cfg: ConpConfig, ele_idx: np.ndarray) -> None:
    """Raise NotImplementedError, naming the feature, for every setting the
    port does not cover yet (it never quietly runs something else)."""
    missing = []
    if cfg.solver is not Solver.INV:
        missing.append(f"{cfg.solver.name} solver")
    if cfg.nevery != 1:
        missing.append("nevery > 1 gating")
    if cfg.a_file or cfg.ainv_file or cfg.matout:
        missing.append("matrix file I/O")
    if cfg.mobile_electrodes and cfg.solver is not Solver.INV:
        missing.append("mobile electrodes with the CG solvers")
    ne = len(ele_idx)
    if ne and not (ele_idx[0] == 0 and ele_idx[-1] == ne - 1):
        missing.append("non-contiguous electrode rows (apply "
                       "models.system.electrodes_first)")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def setup_conp(system: System, md: MDConfig, cfg: ConpConfig, *,
               x0: Optional[np.ndarray] = None,
               q0: Optional[np.ndarray] = None,
               g_ewald: Optional[float] = None,
               solve_dtype=DEFAULT_DTYPE, device=None) -> ConpSolver:
    """One-time setup: k-space tables, A assembly, inverse + projection,
    d vector, elesetq (linalg_init/linalg_setup, fix_conp.cpp:393-464).

    The linear algebra runs in float64 on the CPU; the context is then cast
    to ``solve_dtype`` (A^-1 stays float64, ``ConpSolver.apply_ainv``) and
    placed on ``device`` (None: the card; raises when no CUDA device is
    visible)."""
    device = resolve_device(device)
    units = system.units()
    x0 = system.x0 if x0 is None else np.asarray(x0)
    q0 = system.q0 if q0 is None else np.asarray(q0)
    ele_idx = np.nonzero(system.ele_mask)[0]
    if len(ele_idx) == 0:
        raise ValueError("no electrode atoms")
    _check_supported(cfg, ele_idx)
    one_electrode = not system.ele_right_mask.any()

    # --- k-space setup (accuracy from the host kspace style, km_ewald.cpp:63-132)
    natoms = system.natoms
    q2 = float((q0 ** 2).sum()) * units.qqr2e
    acc_abs = md.kspace_accuracy * units.qqr2e  # two-charge force = qqr2e/1A^2
    box = system.box
    # the slab correction belongs to the NORMAL field mode: FFIELD and
    # NOSLAB run with z periodic
    slabflag = md.slab is not None and cfg.ff is FFMode.NORMAL
    if g_ewald is None:
        g_ewald = md.g_ewald
    if g_ewald is None:
        # the reference decks use a pppm host kspace style and the fix takes
        # g_ewald from it (km_ewald.cpp:66): the LAMMPS pppm pipeline
        g_ewald, _, _ = pppm_ops.set_grid_and_gewald(
            box=box, accuracy_abs=acc_abs, natoms=natoms, q2=max(q2, 1e-10),
            cutoff=md.cutoff,
            slab_volfactor=md.slab if md.slab is not None else 1.0)
    ksp = ewald_ops.setup_ewald(
        box=box, accuracy_abs=acc_abs, g_ewald=g_ewald, natoms=natoms,
        q2=max(q2, 1e-10), slabflag=slabflag,
        slab_volfactor=md.slab if slabflag else 1.0)
    # the per-step k-space: the factored Ewald tables outside PPPM only
    # (A is assembled from the exact Ewald sum either way)
    fksp = pppm_grid = zp = zpinv = None
    if cfg.kspace is KSpaceStyle.PPPM:
        pppm_grid = pppm_ops.setup_pppm(
            box=box, box_lo=tuple(system.box_lo), accuracy_abs=acc_abs,
            natoms=natoms, q2=max(q2, 1e-10), cutoff=md.cutoff,
            slabflag=slabflag, slab_volfactor=md.slab if slabflag else 1.0,
            g_ewald=g_ewald, device=device)
        pppm_grid = pppm_ops.with_tile_cap(pppm_grid, x0)
        # the z-plane transforms pay P plane FFTs and a (nzh, P) z-DFT: for
        # electrodes on many planes (rough or z-extended) the full inverse
        # FFT is cheaper, and mobile electrodes leave their planes
        if not cfg.mobile_electrodes:
            zp = pppm_ops.electrode_zplanes(pppm_grid, x0[ele_idx])
            if len(zp) <= max(pppm_grid.nz // 4, 16):
                zpinv = pppm_ops.zplane_inverse(pppm_grid, zp)
            else:
                zp = None
    else:
        fksp = ewf.factorize(ksp, device=device, dtype=solve_dtype)
        if fksp.nxy > ewf.KXY_CHUNK:
            raise NotImplementedError(
                f"not ported yet: chunked factored Ewald ({fksp.nxy} xy "
                f"vectors > KXY_CHUNK={ewf.KXY_CHUNK})")

    kernels = make_kernels(cfg, system)
    cut_coulsq = min(md.cutoff ** 2, (ERFC_MAX / g_ewald) ** 2)
    xe = np.asarray(x0[ele_idx], np.float64)

    # --- A matrix, inverse, projection (float64, CPU)
    a = assemble_amatrix(xe, system.type[ele_idx], kernels.self_diag[ele_idx],
                         ksp, kernels, box=box, periodic=system.periodic,
                         cut_coulsq=cut_coulsq)
    ainv = torch.linalg.inv(a)
    zhalf = system.box_lo[2] + box[2] / 2
    z_e = torch.from_numpy(xe[:, 2])
    proj = dict(nullneutral=not cfg.nonneutral, zneutr=cfg.zneutr, z_e=z_e,
                zhalf=zhalf)
    if not one_electrode:
        ainv, ee = project_inverse(ainv, **proj)
        ee = float(ee)
    else:
        ee = float(torch.sum(ainv))

    # --- d vector and elesetq (b_setq_cal + get_setq)
    d = torch.from_numpy(build_d_vector(system, cfg, xe))
    elesetq = ainv @ d
    elecheck_ele = torch.from_numpy(system.elecheck[ele_idx])
    totsetq = torch.sum(torch.where(elecheck_ele == 1, elesetq,
                                    torch.zeros_like(elesetq)))
    if one_electrode:
        # projection deferred until after setq (fix_conp.cpp:958, 1115)
        ainv, ee = project_inverse(ainv, **proj)
        ee = float(ee)
    eleinitq = (torch.from_numpy(np.asarray(q0[ele_idx], np.float64))
                if cfg.qinit else torch.zeros(len(ele_idx), dtype=torch.float64))

    # --- the COND feedback gain (fix_cond.cpp:46-68)
    setzvec = torch.zeros(len(ele_idx), dtype=torch.float64)
    vmult = torch.zeros((), dtype=torch.float64)
    if cfg.mode is Mode.COND:
        if cfg.ff is not FFMode.FFIELD:
            raise ValueError("cond requires ffield mode")
        setzvec = d / units.evscale
        zoaz = torch.sum(elesetq * setzvec)
        vmult = 4.0 * math.pi * zoaz * box[2] / (units.evscale * box[0]
                                                 * box[1])
        vmult = vmult / (1.0 + vmult)
        vmult = vmult / zoaz

    f = lambda t: t.to(device=device, dtype=solve_dtype)
    ctx = ConpContext(
        ainv=ainv.to(device), d=f(d), elesetq=f(elesetq), totsetq=f(totsetq),
        eleinitq=f(eleinitq), elecheck_ele=elecheck_ele.to(device),
        ele_idx=torch.as_tensor(ele_idx, device=device),
        setzvec=f(setzvec), vmult=f(vmult))
    return ConpSolver(
        cfg=cfg, ksp=ksp, kernels=kernels, fksp=fksp, ctx=ctx,
        ele_idx=ele_idx, elyte_mask=~system.ele_mask, type_idx=system.type,
        box=box, periodic=system.periodic, cut_coulsq=cut_coulsq,
        ee_diag=ee, solve_dtype=solve_dtype, pppm_grid=pppm_grid,
        ele_zplanes=zp, ele_zpinv=zpinv, one_electrode=one_electrode)
