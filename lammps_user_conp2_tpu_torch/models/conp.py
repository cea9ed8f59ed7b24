"""The constant-potential / constant-charge / constant-displacement charge
solve (CONP, CONQ and COND modes; INV, CG and matrix-free CG solvers).

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
Verlet list when the engine keeps one, else from the K5 sweep.

INV applies the projected A^-1.  CG solves A x = b with the
neutrality-projected conjugate gradient (FixConp::cg, fix_conp.cpp:864-930)
on the stored A; CG_MATFREE never forms A: its operator is the factored
Ewald sum over the electrode positions, the real-space block, the diagonal
and the slab term (rebuilt from the live positions each step with
``mobile_electrodes``).  Both start from the previous step's solution.  The
CG iterations run in blocks of ``CG_BLOCK``: inside a block an iteration
after convergence keeps the carry unchanged (``torch.where`` on a device
flag), and the host reads the flag once per block, so the iterations and
the iterate are the JAX ``lax.while_loop``'s, and a block is one CUDA graph
replayed as often as the data asks (``models/graphs.py``).  A solve is
``solve_begin`` (b, the operator, the warm start), ``cg_block`` as often
as ``cg_active`` says and ``solve_end`` (the charges and the fix scalar);
``solve_full`` composes them.  The solve runs in ``solve_dtype``, which may
differ from the engine's (mixed precision): x and q are cast to it and the
charges written back in q's dtype.
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
from ..ops.erfc import ERFC_MAX
from ..ops.kernels.ele_rows_kernel import b_realspace
from ..ops.kernels.zorder import z_perm
from ..ops.erfc import erfcr_sqrt
from ..ops.neighbors import b_realspace_from_list
from ..ops.pairs import gauss_table_kernels, min_image
from ..utils.config import (ConpConfig, FFMode, KSpaceStyle, MDConfig, Mode,
                            PairMode, Solver)
from ..utils import matio
from ..utils.device import DEFAULT_DTYPE, resolve_device
from .electrodes import (ConpContext, ElectrodeKernels, assemble_amatrix,
                         build_d_vector, make_kernels, project_inverse)
from .system import System


# the context's tensors the solver keeps as buffers
CTX_TENSORS = ("ainv", "amat", "real_block", "diag_extra", "d", "elesetq",
               "totsetq", "eleinitq", "elecheck_ele", "setzvec", "vmult")

# CG iterations per block: the host reads the convergence flag once per
# block (models/graphs.py replays a block as one CUDA graph)
CG_BLOCK = 4


@dataclasses.dataclass
class CGState:
    """The carry of the neutrality-projected CG (tensors on the solve's
    device)."""
    it: torch.Tensor         # () int32 iterations done
    x: torch.Tensor          # (Ne,) iterate
    res: torch.Tensor        # (Ne,) residual b - A x
    p: torch.Tensor          # (Ne,) search direction
    lresnorm: torch.Tensor   # () <res, p>
    lgamma: torch.Tensor     # () |demeaned res|^2 of the last update
    active: torch.Tensor     # () bool: another iteration is due


@dataclasses.dataclass
class DenseOperator:
    """p -> A p with A stored (the CG solver)."""
    amat: torch.Tensor

    def __call__(self, p):
        return self.amat @ p


@dataclasses.dataclass
class MatfreeOperator:
    """p -> A p without A (the CG_MATFREE solver): the factored Ewald sum
    over the electrode positions (its ug_tot diagonal included), the
    real-space block, the non-k-space diagonal (self - 2g/sqrt(pi)) and the
    slab rank-one term (4 pi / V) z z^T."""
    phi: ewf.PhiOperator
    real_block: torch.Tensor   # (Ne, Ne)
    diag_extra: torch.Tensor   # (Ne,)
    z: torch.Tensor            # (Ne,) electrode z
    slab: float                # 4 pi / V with the slab correction, else 0

    def __call__(self, p):
        out = self.phi(p)
        out = out + self.real_block @ p
        out = out + self.diag_extra * p
        if self.slab:
            out = out + self.slab * self.z * torch.sum(self.z * p)
        return out


@dataclasses.dataclass
class SolvePending:
    """A charge solve between ``solve_begin`` and ``solve_end``: b, the
    k-space cache, and the CG carry with the matrix-free operator (None
    for INV, where ``eleallq`` = A^-1 b is already known)."""
    b: torch.Tensor
    kcache: object
    eleallq: Optional[torch.Tensor] = None
    cg: Optional[CGState] = None
    op: Optional[MatfreeOperator] = None


def _demeaned(res, ne):
    netr = torch.sum(res)
    return res - netr / ne, torch.sum(res * res) - netr * (netr / ne)


def _cg_active(lresnorm, it, ne, tol, maxiter):
    return (lresnorm / ne >= tol) & (it < maxiter)


def cg_start(apply_a, b, tol: float, maxiter: int, x0=None) -> CGState:
    """The CG carry before the first iteration: from 0, or from the
    warm-start iterate ``x0`` (one more apply for its residual)."""
    ne = b.shape[0]
    if x0 is None:
        x0 = torch.zeros_like(b)
        res0 = b
    else:
        res0 = b - apply_a(x0)
    p0, lresnorm0 = _demeaned(res0, ne)
    # note: the reference keeps res un-demeaned; p = res - avenetr
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    return CGState(it=it, x=x0, res=res0, p=p0, lresnorm=lresnorm0,
                   lgamma=lresnorm0,
                   active=_cg_active(lresnorm0, it, ne, tol, maxiter))


def cg_block(apply_a, cg: CGState, tol: float, maxiter: int,
             nblock: int = CG_BLOCK) -> CGState:
    """``nblock`` CG iterations in the JAX update order; an iteration that
    is not due (converged or at ``maxiter``) leaves the carry as it is,
    so a 0/0 ``alpha`` after convergence never reaches it."""
    ne = cg.x.shape[0]
    it, x, res, p = cg.it, cg.x, cg.res, cg.p
    lresnorm, lgamma, act = cg.lresnorm, cg.lgamma, cg.active
    for _ in range(nblock):
        ap = apply_a(p)
        alpha = lresnorm / torch.sum(p * ap)
        x_n = x + alpha * p
        res_n = res - alpha * ap
        dm, lgamma_n = _demeaned(res_n, ne)
        beta = lgamma_n / lgamma
        p_n = beta * p + dm
        lresnorm_n = torch.sum(res_n * p_n)
        x = torch.where(act, x_n, x)
        res = torch.where(act, res_n, res)
        p = torch.where(act, p_n, p)
        lresnorm = torch.where(act, lresnorm_n, lresnorm)
        lgamma = torch.where(act, lgamma_n, lgamma)
        it = it + act.to(it.dtype)
        act = _cg_active(lresnorm, it, ne, tol, maxiter)
    return CGState(it=it, x=x, res=res, p=p, lresnorm=lresnorm,
                   lgamma=lgamma, active=act)


def cg_solve(amat, b, tol: float, maxiter: int, x0=None):
    """Neutrality-projected conjugate gradient (FixConp::cg,
    fix_conp.cpp:864-930): residuals and search directions are de-meaned
    every iteration to stay on the charge-neutral subspace; converged when
    <r, p>/Ne < tol.  ``amat``: an (Ne, Ne) matrix or a callable p -> A p;
    ``x0``: a warm-start iterate (one more apply).  Runs ``cg_block`` while
    the flag says so (one host read per block).  Returns (x, iterations as
    a () int32 tensor)."""
    apply_a = amat if callable(amat) else DenseOperator(amat)
    cg = cg_start(apply_a, b, tol, maxiter, x0)
    while bool(cg.active):
        cg = cg_block(apply_a, cg, tol, maxiter)
    return cg.x, cg.it


def realspace_block(xe, type_e, potential_a, *, g, box, periodic,
                    cut_coulsq, rows=None, valid=None):
    """The (Ne, Ne) real-space erfc + Gaussian block of A, off the
    diagonal, in xe's dtype on xe's device; with ``rows`` (R,) (indices
    into xe) only those rows, (R, Ne), and ``valid`` (R,) bool zeroes the
    rows it marks False (the sharded step's padded rows)."""
    ne = xe.shape[0]
    if rows is None:
        xr, tr = xe, type_e
        offdiag = ~torch.eye(ne, dtype=torch.bool, device=xe.device)
    else:
        xr, tr = xe[rows], type_e[rows]
        offdiag = rows[:, None] != torch.arange(ne, device=xe.device)[None, :]
        if valid is not None:
            offdiag = offdiag & valid[:, None]
    dx = min_image(xr[:, None, :] - xe[None, :, :], box, periodic)
    rsq = torch.sum(dx * dx, dim=-1)
    mask = (rsq < cut_coulsq) & offdiag
    rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
    dudq = erfcr_sqrt(g * g * rsq_safe) * g + potential_a(
        rsq_safe, tr[:, None], type_e[None, :])
    return torch.where(mask, dudq, torch.zeros_like(dudq))


def make_matfree_operator(fksp, xe, real_block, diag_extra, *, slabflag,
                          volume) -> MatfreeOperator:
    """A p as a function of p: the electrode phase tables built here, once
    per solve, and reused by every apply (``fksp`` in xe's dtype)."""
    phi = ewf.make_phi_operator_kv(xe, fksp.kx_t, fksp.ky_t, fksp.kz_t,
                                   fksp.unitk, fksp.ug_t)
    return MatfreeOperator(
        phi=phi, real_block=real_block, diag_extra=diag_extra,
        z=xe[:, 2], slab=(4.0 * math.pi / volume) if slabflag else 0.0)


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
    def ele_contig(self) -> bool:
        """Whether the electrodes occupy rows [0, Ne), the layout
        ``models.system.electrodes_first`` makes: every electrode read and
        write is then a slice (``ele_rows``, ``set_ele``), else an
        ``index_select`` / ``index_copy`` through ``ele_idx_t``."""
        e = self.ele_idx
        return len(e) > 0 and int(e[0]) == 0 and int(e[-1]) == len(e) - 1

    def ele_rows(self, t):
        """The electrode rows of ``t`` (along its first axis)."""
        if self.ele_contig:
            return t[:self.ne]
        return t.index_select(0, self.ele_idx_t)

    def set_ele(self, q, vals):
        """q with the electrode rows replaced by ``vals`` (distinct rows: no
        atomics, the step stays bit-reproducible)."""
        if self.ele_contig:
            return torch.cat([vals.to(q.dtype), q[self.ne:]])
        return q.index_copy(0, self.ele_idx_t, vals.to(q.dtype))

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
        x = x.to(self.solve_dtype)
        q = q.to(self.solve_dtype)
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
        if not self._ewald_cacheable():
            return None
        tabs = ewf.axis_tables(self.fksp, x)
        sr, si = ewf.structure_factor_tab(tabs, q_elyte)
        return (tabs, sr, si, z_perm(x, self.box, self.periodic))

    def _ewald_cacheable(self) -> bool:
        """Whether the factored Ewald's per-step tables are built whole and
        shared with the force path: up to KXY_CHUNK xy vectors (above it
        the sums run in chunks and nothing is shared)."""
        return self.fksp is not None and self.fksp.nxy <= ewf.KXY_CHUNK

    def b_vector_full(self, x, q, nbr=None, ncfg=None, tasg=None):
        """Assemble b for the current electrolyte configuration.

        k-space: b_i -= sum_k 2 ug_k (c_i ReS + s_i ImS)   [km_ewald.cpp:789-825]
                 or the mesh potential at the electrodes    [pppm_conp.cpp:269-316]
        real:    b_i -= sum_(elyte j in range) q_j (erfc(g r)/r + pot(r))
                                                            [fix_conp.cpp:1281-1365]
        slab:    b_i -= z_i * (4 pi / V) sum_elyte q_j z_j  [km_ewald.cpp:827-847]
        ``nbr``/``ncfg``: the engine's Verlet list, whose electrode rows
        then give the real-space part.  x and q are in the solve dtype.
        Returns (b, kcache)."""
        q_elyte = torch.where(self.elyte_t, q, torch.zeros_like(q))
        kcache = self.elyte_kcache(x, q, tasg)
        xe = self.ele_rows(x)
        zsort = None
        if self.pppm_grid is not None and self.ele_zplanes is not None:
            # the electrodes sit on a few z planes: read u there with a
            # small z-DFT matmul and P plane FFTs, no full inverse FFT
            grid = self.pppm_grid
            up = pppm_ops.u_on_zplanes(grid, kcache[0], self.ele_zplanes)
            b = -pppm_ops.gather_zplanes(grid, up, xe, self.ele_zpinv)
        elif self.pppm_grid is not None:
            # rough, z-extended or mobile electrodes: the full potential
            # mesh and the stencil readout (tiled above the dense bound)
            u = pppm_ops.poisson_u_from_k(self.pppm_grid, kcache[0])
            b = -pppm_ops.gather(self.pppm_grid, u, xe)
        elif kcache is not None:
            tabs, sr, si, zsort = kcache
            (pr, pi), (zr, zi) = tabs
            rows = self.ele_rows
            tabs_e = ((rows(pr), rows(pi)), (rows(zr), rows(zi)))
            b = -ewf.potential_on_points_tab(tabs_e, sr, si, self.fksp.ug_t)
        else:
            # above KXY_CHUNK: the chunked structure factor and the
            # readout from the electrodes' own tables
            sr, si = ewf.structure_factor_f(self.fksp, x, q_elyte)
            b = -ewf.potential_on_points_f(self.fksp, xe, sr, si)
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
            b = b - xe[:, 2] * slabcorr
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

    @property
    def a_kernel(self):
        """The A matrix's pair potential on the solver's device and dtype:
        ETA's closure over eta / sqrt(2), EHGO's table kernel."""
        if self.cfg.pairmode is PairMode.ETA:
            return self.kernels.potential_A
        return self.step_kernels[0]

    def operator(self, pend: SolvePending):
        """p -> A p of this solve: A itself (CG) or the matrix-free operator
        that ``solve_begin`` built (CG_MATFREE)."""
        return DenseOperator(self.amat) if pend.op is None else pend.op

    def _matfree_operator(self, x):
        """The CG_MATFREE operator at positions x (solve dtype): the
        electrodes' phase tables, and the real-space block rebuilt from x
        with mobile electrodes (the set-up one otherwise)."""
        xe = self.ele_rows(x)
        real_block = self.real_block
        if self.cfg.mobile_electrodes:
            real_block = realspace_block(
                xe, self.ele_rows(self.type_t), self.a_kernel,
                g=self.ksp.g_ewald, box=self.box, periodic=self.periodic,
                cut_coulsq=self.cut_coulsq)
        return make_matfree_operator(
            self.fksp, xe, real_block, self.diag_extra,
            slabflag=self.ksp.slabflag, volume=self.ksp.volume)

    def _cg_warm_start(self, q, step, scalar_prev):
        """The previous solve's A^-1 b iterate from the current electrode
        charges: q_ele - potdiff_prev * elesetq - eleinitq, de-meaned.
        potdiff_prev is the target at step - nevery for CONP (the step the
        charges were solved at), the previous fix scalar for CONQ and COND
        (None: no warm start).  A non-finite iterate (charges healed from a
        NaN-poisoned state) gives 0, decided on the device."""
        cfg = self.cfg
        if cfg.mode is Mode.CONP:
            potdiff_prev = (self.target(step - cfg.nevery)
                            if callable(cfg.target) else float(cfg.target))
        elif scalar_prev is not None:
            potdiff_prev = scalar_prev.to(self.solve_dtype)
        else:
            return None
        x0 = (self.ele_rows(q) - self.eleinitq
              - potdiff_prev * self.elesetq)
        x0 = x0 - torch.mean(x0)
        return torch.where(torch.all(torch.isfinite(x0)), x0,
                           torch.zeros_like(x0))

    def solve_begin(self, x, q, nbr=None, ncfg=None, tasg=None, step=None,
                    scalar_prev=None) -> SolvePending:
        """The solve up to its CG iterations: b (and the k-space cache) at
        x, then A^-1 b (INV), or the operator and the warm-started CG carry
        (CG, CG_MATFREE).  ``step``: the step being computed (a () int64
        device tensor); ``scalar_prev``: the previous fix scalar."""
        x = x.to(self.solve_dtype)
        q = q.to(self.solve_dtype)
        b, kcache = self.b_vector_full(x, q, nbr, ncfg, tasg)
        cfg = self.cfg
        if cfg.solver is Solver.INV:
            return SolvePending(b=b, kcache=kcache, eleallq=self.apply_ainv(b))
        op = self._matfree_operator(x) if cfg.solver is Solver.CG_MATFREE \
            else None
        pend = SolvePending(b=b, kcache=kcache, op=op)
        pend.cg = cg_start(self.operator(pend), b, cfg.cg_tolerance,
                           cfg.cg_maxiter,
                           x0=self._cg_warm_start(q, step, scalar_prev))
        return pend

    def cg_active(self, pend: SolvePending) -> bool:
        """Whether the solve needs another CG block (a host read)."""
        return pend.cg is not None and bool(pend.cg.active)

    def cg_block(self, pend: SolvePending) -> CGState:
        """The next ``CG_BLOCK`` iterations of the solve's carry."""
        return cg_block(self.operator(pend), pend.cg, self.cfg.cg_tolerance,
                        self.cfg.cg_maxiter)

    def solve_end(self, pend: SolvePending, x, q, step=None):
        """The charges and the fix scalar from A^-1 b.  Returns (q_new in
        q's dtype, scalar in the solve dtype, kcache); scalar is the fix's
        output: the CONP induced charge dV*totsetq + sum_left(A^-1 b)
        (fix_conp.cpp:1159), the CONQ potential difference (fix_conq.cpp:78)
        or the COND one (fix_cond.cpp:115)."""
        eleallq = pend.eleallq if pend.cg is None else pend.cg.x
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
            qs = q.to(self.solve_dtype)
            dipole = -torch.sum(torch.where(self.elyte_t, qs,
                                            torch.zeros_like(qs))
                                * x.to(self.solve_dtype)[:, 2])
            potdiff = self.vmult * (target - dipole / self.box[2]
                                    - torch.sum(self.setzvec * eleallq))
            scalar = potdiff
        q_ele = eleallq + potdiff * self.elesetq + self.eleinitq
        return self.set_ele(q, q_ele), scalar, pend.kcache

    def solve_full(self, x, q, nbr=None, ncfg=None, tasg=None, step=None,
                   scalar_prev=None):
        """One charge update at the step ``step`` (a () int64 device
        tensor; read by callable targets and the CONP warm start):
        ``solve_begin``, the CG blocks while the flag says so,
        ``solve_end``.  Returns (q_new, scalar, kcache)."""
        pend = self.solve_begin(x, q, nbr, ncfg, tasg, step, scalar_prev)
        while self.cg_active(pend):
            pend.cg = self.cg_block(pend)
        return self.solve_end(pend, x, q, step)

    def cg_iterations(self, x, q, nbr=None, ncfg=None, tasg=None) -> int:
        """The CG iterations of a cold solve at (x, q), the per-solve trace
        the reference writes to its timing log (fix_conp.cpp:926-928); 0
        for INV.  A diagnostic off the step: it reads the device."""
        cfg = self.cfg
        if cfg.solver is Solver.INV:
            return 0
        x = x.to(self.solve_dtype)
        q = q.to(self.solve_dtype)
        b, _ = self.b_vector_full(x, q, nbr, ncfg, tasg)
        apply_a = (self._matfree_operator(x) if cfg.solver is
                   Solver.CG_MATFREE else DenseOperator(self.amat))
        _, it = cg_solve(apply_a, b, cfg.cg_tolerance, cfg.cg_maxiter)
        return int(it)


def setup_conp(system: System, md: MDConfig, cfg: ConpConfig, *,
               x0: Optional[np.ndarray] = None,
               q0: Optional[np.ndarray] = None,
               g_ewald: Optional[float] = None,
               solve_dtype=DEFAULT_DTYPE, device=None) -> ConpSolver:
    """One-time setup: k-space tables, A assembly, inverse + projection,
    d vector, elesetq (linalg_init/linalg_setup, fix_conp.cpp:393-464).
    CG keeps A and forms no inverse; CG_MATFREE keeps only A's real-space
    block and diagonal; both solve elesetq = A^-1 d by CG.  ``cfg.a_file``
    / ``cfg.ainv_file`` read A / its projected inverse from a file
    (``utils/matio``, rows by tag), ``cfg.matout`` writes ``amatrix`` and
    ``inv_a_matrix`` into the working directory.  The electrodes may sit
    on any rows.

    The linear algebra runs in float64 on the CPU, except CG_MATFREE's CG
    for elesetq, which runs in float64 on ``device`` (each apply is the
    matrix-free operator's eight (Ne, nxy, nz) products); the context is
    then cast to ``solve_dtype`` (A^-1 stays float64,
    ``ConpSolver.apply_ainv``) and placed on ``device`` (None: the card;
    raises when no CUDA device is visible)."""
    device = resolve_device(device)
    units = system.units()
    x0 = system.x0 if x0 is None else np.asarray(x0)
    q0 = system.q0 if q0 is None else np.asarray(q0)
    ele_idx = np.nonzero(system.ele_mask)[0]
    if len(ele_idx) == 0:
        raise ValueError("no electrode atoms")
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
    use_cg = cfg.solver is Solver.CG
    matfree = cfg.solver is Solver.CG_MATFREE
    # the per-step k-space: the factored Ewald tables outside PPPM, and for
    # the matrix-free operator under PPPM too (A is the exact Ewald sum
    # either way, pppm_conp.cpp:91-101)
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
    if cfg.kspace is not KSpaceStyle.PPPM or matfree:
        fksp = ewf.factorize(ksp, device=device, dtype=solve_dtype)

    kernels = make_kernels(cfg, system)
    cut_coulsq = min(md.cutoff ** 2, (ERFC_MAX / g_ewald) ** 2)
    xe = np.asarray(x0[ele_idx], np.float64)
    type_e = system.type[ele_idx]
    tags_e = system.tag[ele_idx]

    # --- A matrix, inverse, projection (float64, CPU); the placeholders of
    # the matrices a solver does not keep
    z64 = lambda *shape: torch.zeros(shape, dtype=torch.float64)
    amat, real_block, diag_extra = z64(1, 1), z64(1, 1), z64(1)
    zhalf = system.box_lo[2] + box[2] / 2
    z_e = torch.from_numpy(xe[:, 2])
    proj = dict(nullneutral=not cfg.nonneutral, zneutr=cfg.zneutr, z_e=z_e,
                zhalf=zhalf)
    if matfree:
        # never the k-space block: its real-space block and diagonal only
        real_block = realspace_block(
            torch.from_numpy(xe), torch.as_tensor(type_e),
            kernels.potential_A, g=g_ewald, box=box,
            periodic=system.periodic, cut_coulsq=cut_coulsq)
        diag_extra = torch.as_tensor(
            kernels.self_diag[ele_idx] - 2.0 / math.sqrt(math.pi) * g_ewald,
            dtype=torch.float64)
        ainv = z64(1, 1)
        ee = float("nan")
    elif cfg.ainv_file is not None:
        # the inverse from a file (the inv keyword), rows in tag order
        ainv = torch.from_numpy(matio.read_matrix(cfg.ainv_file, tags_e)[1])
        ee = float("nan")
    else:
        if cfg.a_file is not None:
            a = torch.from_numpy(matio.read_matrix(cfg.a_file, tags_e)[1])
        else:
            a = assemble_amatrix(xe, type_e, kernels.self_diag[ele_idx], ksp,
                                 kernels, box=box, periodic=system.periodic,
                                 cut_coulsq=cut_coulsq)
        if cfg.matout:
            # written into the working directory, as the reference does
            matio.write_matrix("amatrix", tags_e, a.numpy())
        if use_cg:
            # CG skips the O(Ne^3) inverse; neutrality is kept by its
            # de-meaned residuals, not by a projection
            amat = a
            ainv = z64(1, 1)
            ee = float("nan")
        else:
            ainv = torch.linalg.inv(a)
            if not one_electrode:
                ainv, ee = project_inverse(ainv, **proj)
                ee = float(ee)
            else:
                ee = float(torch.sum(ainv))

    # --- d vector and elesetq (b_setq_cal + get_setq)
    d = torch.from_numpy(build_d_vector(system, cfg, xe))
    if matfree:
        fk64 = (fksp if solve_dtype == torch.float64
                else ewf.factorize(ksp, device=device, dtype=torch.float64))
        op = make_matfree_operator(
            fk64, torch.from_numpy(xe).to(device), real_block.to(device),
            diag_extra.to(device), slabflag=ksp.slabflag, volume=ksp.volume)
        elesetq, _ = cg_solve(op, d.to(device), cfg.cg_tolerance,
                              cfg.cg_maxiter)
        elesetq = elesetq.cpu()
    elif use_cg:
        elesetq, _ = cg_solve(amat, d, cfg.cg_tolerance, cfg.cg_maxiter)
    else:
        elesetq = ainv @ d
    elecheck_ele = torch.from_numpy(system.elecheck[ele_idx])
    totsetq = torch.sum(torch.where(elecheck_ele == 1, elesetq,
                                    torch.zeros_like(elesetq)))
    if one_electrode and not use_cg:
        # projection deferred until after setq (fix_conp.cpp:958, 1115);
        # as in the JAX package, CG_MATFREE's placeholder goes through it
        ainv, ee = project_inverse(ainv, **proj)
        ee = float(ee)
    if cfg.matout and cfg.ainv_file is None and not use_cg:
        matio.write_matrix("inv_a_matrix", tags_e, ainv.numpy())
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
        ainv=ainv.to(device), amat=f(amat), real_block=f(real_block),
        diag_extra=f(diag_extra), d=f(d), elesetq=f(elesetq),
        totsetq=f(totsetq),
        eleinitq=f(eleinitq), elecheck_ele=elecheck_ele.to(device),
        ele_idx=torch.as_tensor(ele_idx, device=device),
        setzvec=f(setzvec), vmult=f(vmult))
    return ConpSolver(
        cfg=cfg, ksp=ksp, kernels=kernels, fksp=fksp, ctx=ctx,
        ele_idx=ele_idx, elyte_mask=~system.ele_mask, type_idx=system.type,
        box=box, periodic=system.periodic, cut_coulsq=cut_coulsq,
        ee_diag=ee, solve_dtype=solve_dtype, pppm_grid=pppm_grid,
        ele_zplanes=zp, ele_zpinv=zpinv, one_electrode=one_electrode)
