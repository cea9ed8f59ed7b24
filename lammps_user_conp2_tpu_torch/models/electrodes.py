"""Electrode bookkeeping, A-matrix assembly, inversion + projection, d-vector.

FixConp's linear-algebra setup (fix_conp.cpp:426-464 linalg_setup; 777-861
a_cal; 932-980 inv; 982-1067 inv_project; 609-637 b_setq_cal; 1071-1116
get_setq), run once in float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..ops import ewald as ewald_ops
from ..ops.erfc import ERFC_MAX, erfcr_sqrt
from ..ops.ewald_factored import amatrix_kspace_host
from ..ops.pairs import eta_pair_kernels, min_image
from ..utils.config import ConpConfig, FFMode, PairMode
from .system import System

MY_PIS = math.sqrt(math.pi)


@dataclasses.dataclass
class ConpContext:
    """Static context of the per-step INV charge solve (tensors)."""
    ainv: torch.Tensor          # (Ne, Ne) projected inverse
    d: torch.Tensor             # (Ne,) applied-potential coupling vector
    elesetq: torch.Tensor       # (Ne,) A^-1 d
    totsetq: torch.Tensor       # () sum over the left electrode of elesetq
    eleinitq: torch.Tensor      # (Ne,) initial charges baseline (qinit) or zeros
    elecheck_ele: torch.Tensor  # (Ne,) +1/-1
    ele_idx: torch.Tensor       # (Ne,) indices into the global atom arrays


@dataclasses.dataclass(frozen=True)
class ElectrodeKernels:
    """Pair-mode kernels (fix_conp.h:91-94).  ``eta_ij``/``fo_ij`` are the
    per-type-pair width/overlap tables of the one parameterization the CUDA
    kernels evaluate (ETA: uniform eta, fo = 0)."""
    potential: Callable    # blist / b-vector kernel
    force: Callable        # post-force correction kernel
    potential_A: Callable  # A-matrix variant (eta/sqrt(2) in ETA mode)
    self_diag: np.ndarray  # (N,) per-atom A diagonal self term
    eta_ij: np.ndarray     # (T+1, T+1) pairwise Gaussian widths
    fo_ij: np.ndarray      # (T+1, T+1) overlap prefactors (0 in ETA mode)


def make_kernels(cfg: ConpConfig, system: System) -> ElectrodeKernels:
    if cfg.pairmode is not PairMode.ETA:
        raise NotImplementedError("EHGO pair mode is not ported yet")
    nt1 = system.ntypes + 1
    pot, frc, pot_a = eta_pair_kernels(cfg.eta)
    # diagonal self term sqrt(2/pi)*eta (fix_conp.cpp:796-801)
    self_diag = np.full(system.natoms, math.sqrt(2.0) / MY_PIS * cfg.eta)
    return ElectrodeKernels(pot, frc, pot_a, self_diag,
                            eta_ij=np.full((nt1, nt1), cfg.eta),
                            fo_ij=np.zeros((nt1, nt1)))


def assemble_amatrix(xe, type_e, self_diag_e, ksp: ewald_ops.EwaldKSpace,
                     kernels: ElectrodeKernels, *, box, periodic,
                     cut_coulsq: float) -> torch.Tensor:
    """Full A matrix (float64, CPU): k-space block + real-space erfc +
    Gaussian self terms.

    The k-space block comes from the host plane-factored sum
    (``amatrix_kspace_host``) at every size.  Real-space off-diagonal
    (alist_coul_cal, fix_conp.cpp:1209-1279):
      dudq = erfc(g r)/r + pair_potential_A(r^2)
    gated by rsq < min(coul cutoff^2, ERFC_MAX^2/g^2)."""
    g = ksp.g_ewald
    cutsq = min(cut_coulsq, (ERFC_MAX / g) ** 2)
    xe = np.asarray(xe, np.float64)
    a = torch.from_numpy(amatrix_kspace_host(xe, ksp))
    xt = torch.from_numpy(xe)
    te = torch.as_tensor(type_e)
    ne = xe.shape[0]
    dx = min_image(xt[:, None, :] - xt[None, :, :], box, periodic)
    rsq = torch.sum(dx * dx, dim=-1)
    mask = (rsq < cutsq) & ~torch.eye(ne, dtype=torch.bool)
    rsq_safe = torch.where(mask, rsq, torch.ones_like(rsq))
    dudq = erfcr_sqrt(g * g * rsq_safe) * g + kernels.potential_A(
        rsq_safe, te[:, None], te[None, :])
    a = a + torch.where(mask, dudq, torch.zeros_like(dudq))
    return a + torch.diag(torch.as_tensor(self_diag_e, dtype=torch.float64))


def project_inverse(ainv, *, nullneutral: bool, zneutr: bool, z_e=None,
                    zhalf=None):
    """Electroneutrality projection of A^-1 (inv_project, fix_conp.cpp:982-1067).

    ainv <- ainv - (ainv e)(ainv e)^T / (e^T ainv e), then optionally the same
    against e_pos (indicator z > zhalf).  Returns (ainv, ee_log) with
    ee_log = e^T A^-1 e (the `<e,e>` diagnostic, fix_conp.cpp:1006-1009)."""
    ainve = torch.sum(ainv, dim=1)
    totinve = torch.sum(ainve)
    if nullneutral:
        if float(totinve) ** 2 > 1e-8:
            ainv = ainv - torch.outer(ainve, ainve) / totinve
        if zneutr:
            pos = (z_e > zhalf).to(ainv.dtype)
            ainve2 = ainv @ pos
            totinve2 = torch.sum(ainve2 * pos)
            if float(totinve2) ** 2 > 1e-8:
                ainv = ainv - torch.outer(ainve2, ainve2) / totinve2
    return ainv, totinve


def build_d_vector(system: System, cfg: ConpConfig, xe) -> np.ndarray:
    """b_setq_cal (fix_conp.cpp:609-637): the applied-potential coupling,
    d_i = -0.5*evscale*(+-1) in the NORMAL slab mode."""
    if cfg.ff is not FFMode.NORMAL:
        raise NotImplementedError(f"{cfg.ff.name} field mode is not ported yet")
    evscale = system.units().evscale
    eci = system.elecheck[system.ele_mask]
    return -0.5 * evscale * eci
