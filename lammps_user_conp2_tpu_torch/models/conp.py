"""The constant-potential charge solve (CONP mode, INV solver).

Per-step math (fix_conp.cpp:543-573 pre_force; 1120-1161 update_charge):

    b_i = -phi_i(electrolyte)        [k-space + real-space erfc + slab]
    q_ele = A^-1 b + dV * A^-1 d  (+ q_init)

The setup (A, its inverse and projection, d, elesetq) runs once in float64
on the CPU; the context is then cast to the run dtype and moved to the run
device.  The CONQ/COND modes, the CG solvers and the PPPM b-vector are
still to come: ``setup_conp`` raises NotImplementedError for them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import ewald as ewald_ops
from ..ops import ewald_factored as ewf
from ..ops.erfc import ERFC_MAX
from ..ops.kernels.ele_rows_kernel import b_realspace
from ..ops.kernels.zorder import z_perm
from ..ops.pppm import set_grid_and_gewald
from ..utils.config import (ConpConfig, FFMode, KSpaceStyle, MDConfig, Mode,
                            Solver)
from .electrodes import (ConpContext, ElectrodeKernels, assemble_amatrix,
                         build_d_vector, make_kernels, project_inverse)
from .system import System


class ConpSolver(nn.Module):
    """Static configuration plus the device context of the charge solve.
    Every tensor is a buffer, so ``.to(device)`` moves the whole solver."""

    def __init__(self, *, cfg: ConpConfig, ksp: ewald_ops.EwaldKSpace,
                 kernels: ElectrodeKernels, fksp: ewf.FactoredKSpace,
                 ctx: ConpContext, ele_idx: np.ndarray, elyte_mask: np.ndarray,
                 type_idx: np.ndarray, box, periodic, cut_coulsq: float,
                 ee_diag: float, solve_dtype):
        super().__init__()
        self.cfg = cfg
        self.ksp = ksp
        self.kernels = kernels
        self.fksp = fksp
        self.ele_idx = ele_idx                 # (Ne,) host copy
        self.elyte_mask = elyte_mask           # (N,) host copy, bool
        self.type_idx = type_idx               # (N,) host copy
        self.box = box
        self.periodic = periodic
        self.cut_coulsq = cut_coulsq           # min(coul cut^2, ERFC_MAX^2/g^2)
        self.ee_diag = ee_diag                 # <e,e> diagnostic
        self.solve_dtype = solve_dtype
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
        for name in ("ainv", "d", "elesetq", "totsetq", "eleinitq",
                     "elecheck_ele"):
            self.register_buffer(name, getattr(ctx, name))

    @property
    def ne(self) -> int:
        return len(self.ele_idx)

    @property
    def ctx(self) -> ConpContext:
        return ConpContext(ainv=self.ainv, d=self.d, elesetq=self.elesetq,
                           totsetq=self.totsetq, eleinitq=self.eleinitq,
                           elecheck_ele=self.elecheck_ele,
                           ele_idx=self.ele_idx_t)

    def load_context(self, ctx: ConpContext) -> None:
        """Replace the solve context (e.g. one built by ``interop``)."""
        for name in ("ainv", "d", "elesetq", "totsetq", "eleinitq",
                     "elecheck_ele"):
            buf = getattr(self, name)
            setattr(self, name, getattr(ctx, name).to(buf.device, buf.dtype))

    # ----------------------------------------------------------------- b
    def elyte_kcache(self, x, q):
        """(axis_tables, Sr_elyte, Si_elyte, zsort) at these positions: the
        per-step phase tables and electrolyte structure factor, shared with
        the force path, and the z ordering shared by both CUDA sweeps."""
        q_elyte = torch.where(self.elyte_t, q, torch.zeros_like(q))
        tabs = ewf.axis_tables(self.fksp, x)
        sr, si = ewf.structure_factor_tab(tabs, q_elyte)
        return (tabs, sr, si, z_perm(x, self.box, self.periodic))

    def b_vector_full(self, x, q):
        """Assemble b for the current electrolyte configuration.

        k-space: b_i -= sum_k 2 ug_k (c_i ReS + s_i ImS)   [km_ewald.cpp:789-825]
        real:    b_i -= sum_(elyte j in range) q_j (erfc(g r)/r + pot(r))
                                                            [fix_conp.cpp:1281-1365]
        slab:    b_i -= z_i * (4 pi / V) sum_elyte q_j z_j  [km_ewald.cpp:827-847]
        Returns (b, kcache)."""
        ne = self.ne
        q_elyte = torch.where(self.elyte_t, q, torch.zeros_like(q))
        kcache = self.elyte_kcache(x, q)
        tabs, sr, si, zsort = kcache
        (pr, pi), (zr, zi) = tabs
        tabs_e = ((pr[:ne], pi[:ne]), (zr[:ne], zi[:ne]))
        b = -ewf.potential_on_points_tab(tabs_e, sr, si, self.fksp.ug_t)
        b = b + b_realspace(
            x, q_elyte, self.ele_idx_t, self.elyte_f, self.eta_rows,
            self.fo_rows, self.type_t, box=self.box, periodic=self.periodic,
            cut_coulsq=self.cut_coulsq, g_ewald=self.ksp.g_ewald, zsort=zsort)
        if self.ksp.slabflag:
            slabcorr = (4.0 * math.pi / self.ksp.volume) * torch.sum(
                q_elyte * x[:, 2])
            b = b - x[:ne, 2] * slabcorr
        return b, kcache

    # ------------------------------------------------------------- solve
    def solve_full(self, x, q):
        """One charge update.  Returns (q_new, scalar, kcache): scalar is the
        CONP induced charge dV*totsetq + sum_left(A^-1 b)
        (fix_conp.cpp:1159)."""
        b, kcache = self.b_vector_full(x, q)
        eleallq = self.ainv @ b
        potdiff = float(self.cfg.target)
        left = self.elecheck_ele == 1
        scalar = potdiff * self.totsetq + torch.sum(
            torch.where(left, eleallq, torch.zeros_like(eleallq)))
        q_ele = eleallq + potdiff * self.elesetq + self.eleinitq
        return torch.cat([q_ele.to(q.dtype), q[self.ne:]]), scalar, kcache


def _check_supported(cfg: ConpConfig, ele_idx: np.ndarray) -> None:
    """Raise NotImplementedError, naming the feature, for every setting the
    port does not cover yet (it never quietly runs something else)."""
    missing = []
    if cfg.mode is not Mode.CONP:
        missing.append(f"{cfg.mode.name} mode")
    if cfg.solver is not Solver.INV:
        missing.append(f"{cfg.solver.name} solver")
    if cfg.ff is not FFMode.NORMAL:
        missing.append(f"{cfg.ff.name} field mode")
    if cfg.kspace is not KSpaceStyle.EWALD:
        missing.append(f"{cfg.kspace.name} k-space for the charge solve")
    if cfg.nevery != 1:
        missing.append("nevery > 1 gating")
    if callable(cfg.target):
        missing.append("callable targets")
    if cfg.a_file or cfg.ainv_file or cfg.matout:
        missing.append("matrix file I/O")
    if cfg.mobile_electrodes:
        missing.append("mobile electrodes")
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
               solve_dtype=torch.float64, device=None) -> ConpSolver:
    """One-time setup: k-space tables, A assembly, inverse + projection,
    d vector, elesetq (linalg_init/linalg_setup, fix_conp.cpp:393-464).

    The linear algebra runs in float64 on the CPU; the context is then cast
    to ``solve_dtype`` and placed on ``device``."""
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
    slabflag = md.slab is not None
    if g_ewald is None:
        g_ewald = md.g_ewald
    if g_ewald is None:
        # the reference decks use a pppm host kspace style and the fix takes
        # g_ewald from it (km_ewald.cpp:66): the LAMMPS pppm pipeline
        g_ewald, _, _ = set_grid_and_gewald(
            box=box, accuracy_abs=acc_abs, natoms=natoms, q2=max(q2, 1e-10),
            cutoff=md.cutoff,
            slab_volfactor=md.slab if md.slab is not None else 1.0)
    ksp = ewald_ops.setup_ewald(
        box=box, accuracy_abs=acc_abs, g_ewald=g_ewald, natoms=natoms,
        q2=max(q2, 1e-10), slabflag=slabflag,
        slab_volfactor=md.slab if slabflag else 1.0)
    fksp = ewf.factorize(ksp, device=device, dtype=solve_dtype)
    if fksp.nxy > ewf.KXY_CHUNK:
        raise NotImplementedError(
            f"not ported yet: chunked factored Ewald ({fksp.nxy} xy vectors "
            f"> KXY_CHUNK={ewf.KXY_CHUNK})")

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

    f = lambda t: t.to(device=device, dtype=solve_dtype)
    ctx = ConpContext(
        ainv=f(ainv), d=f(d), elesetq=f(elesetq), totsetq=f(totsetq),
        eleinitq=f(eleinitq), elecheck_ele=elecheck_ele.to(device),
        ele_idx=torch.as_tensor(ele_idx, device=device))
    return ConpSolver(
        cfg=cfg, ksp=ksp, kernels=kernels, fksp=fksp, ctx=ctx,
        ele_idx=ele_idx, elyte_mask=~system.ele_mask, type_idx=system.type,
        box=box, periodic=system.periodic, cut_coulsq=cut_coulsq,
        ee_diag=ee, solve_dtype=solve_dtype)
