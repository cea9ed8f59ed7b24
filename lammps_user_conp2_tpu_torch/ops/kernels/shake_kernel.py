"""SHAKE positions (K7) and RATTLE velocities (K8): the CUDA kernels of
``csrc/shake_kernel.cu`` and their plain PyTorch versions.

Per cluster, ITERS Gauss-Seidel sweeps over the constraint slots s:

    SHAKE   r = mi(x_i - x_j), r0 = mi(x_old_i - x_old_j)
            lam = (r.r - d^2) / (2 (1/m_i + 1/m_j) r.r0)
            x_i -= lam r0 / m_i ;  x_j += lam r0 / m_j
    RATTLE  r = mi(x_i - x_j)
            mu = (v_i - v_j).r / ((1/m_i + 1/m_j) r.r)
            v_i -= mu r / m_i ;  v_j += mu r / m_j

with the JAX package's clamps (|denominator| > 1e-12 for SHAKE,
denominator > 1e-12 for RATTLE), masking after the division, and a fixed
number of sweeps (no early exit, no relaxation factor: the JAX package's
omega is 1; ``csrc/shake_kernel.cu`` fixes the same SH_ITERS = 12).  The
plain versions repeat the JAX package's XLA path (``models/shake.py``) op for op: the same slot order,
the dot products summed as (a0 b0 + a1 b1) + a2 b2, the write-back of the
valid columns only, dv = (x - x_new) / dt over all atoms.

``shake_positions`` and ``rattle_velocities`` launch their kernel for CUDA
float32 tensors, take the plain version for CPU tensors and raise for
anything else.
"""

from __future__ import annotations

import torch

from ..pairs import min_image
from . import build

ITERS = 12   # the JAX package's fixed sweep count (models/shake.py)

shake_launches = build.LaunchCounter("shake_positions")
rattle_launches = build.LaunchCounter("rattle_velocities")


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _tables(cons):
    """(atoms, rows, ci, cj, invm_i, invm_j) with int64 indices."""
    atoms = cons.atoms.long()
    rows = torch.arange(atoms.shape[0], device=atoms.device)
    ci, cj = cons.ci.long(), cons.cj.long()
    return (atoms, rows, ci, cj, torch.gather(cons.invm, 1, ci),
            torch.gather(cons.invm, 1, cj))


def _write_back(cons, atoms, out, clusters):
    valid = cons.amask
    out[atoms[valid]] = clusters[valid]
    return out


def shake_positions_plain(cons, x_new, x_old, dt, *, box, periodic):
    """(x, dv): x_new corrected onto the constraints, dv = (x - x_new)/dt."""
    atoms, rows, ci, cj, invmi, invmj = _tables(cons)
    isum = invmi + invmj
    xc = x_new[atoms]                              # (M, K, 3)
    xo = x_old[atoms]
    r_old = [min_image(xo[rows, ci[:, s]] - xo[rows, cj[:, s]], box,
                       periodic) for s in range(ci.shape[1])]
    for _ in range(ITERS):
        for s in range(ci.shape[1]):
            i, j = ci[:, s], cj[:, s]
            rn = min_image(xc[rows, i] - xc[rows, j], box, periodic)
            diff = _dot(rn, rn) - cons.dist2[:, s]
            denom = 2.0 * isum[:, s] * _dot(rn, r_old[s])
            lam = diff / torch.where(denom.abs() > 1e-12, denom, 1e-12)
            lam = torch.where(cons.cmask[:, s], lam, 0.0)
            corr = lam[:, None] * r_old[s]
            xc[rows, i] = xc[rows, i] - invmi[:, s, None] * corr
            xc[rows, j] = xc[rows, j] + invmj[:, s, None] * corr
    x = _write_back(cons, atoms, x_new.clone(), xc)
    return x, (x - x_new) / dt


def rattle_velocities_plain(cons, x, v, *, box, periodic):
    """v projected onto the constraint manifold (v_ij . r_ij = 0)."""
    atoms, rows, ci, cj, invmi, invmj = _tables(cons)
    isum = invmi + invmj
    xc = x[atoms]
    vc = v[atoms]
    r, denom = [], []
    for s in range(ci.shape[1]):
        rs = min_image(xc[rows, ci[:, s]] - xc[rows, cj[:, s]], box, periodic)
        r.append(rs)
        d = isum[:, s] * _dot(rs, rs)
        denom.append(torch.where(d > 1e-12, d, 1e-12))
    for _ in range(ITERS):
        for s in range(ci.shape[1]):
            i, j = ci[:, s], cj[:, s]
            vij = vc[rows, i] - vc[rows, j]
            mu = _dot(vij, r[s]) / denom[s]
            mu = torch.where(cons.cmask[:, s], mu, 0.0)
            corr = mu[:, None] * r[s]
            vc[rows, i] = vc[rows, i] - invmi[:, s, None] * corr
            vc[rows, j] = vc[rows, j] + invmj[:, s, None] * corr
    return _write_back(cons, atoms, v.clone(), vc)


def _check(name, cons, *arrays):
    build.check_cuda(name, torch.float32, *arrays, cons.invm, cons.dist2)
    build.check_cuda(name, torch.int32, cons.atoms, cons.ci, cons.cj)
    build.check_cuda(name, torch.bool, cons.amask, cons.cmask)
    n = arrays[0].shape[0]
    if any(a.shape != (n, 3) for a in arrays):
        raise ValueError(f"{name}: expected (N, 3) positions/velocities")


def _geometry(box, periodic):
    return [float(b) for b in box] + [int(bool(p)) for p in periodic]


def shake_positions(cons, x_new, x_old, dt, *, box, periodic):
    """SHAKE: returns (x, dv = (x - x_new)/dt).  x_new, x_old (N, 3): the
    positions after and before the drift; ``cons`` the
    ``models.shake.ShakeConstraints`` tables on the same device."""
    if x_new.device.type == "cpu":
        return shake_positions_plain(cons, x_new, x_old, dt, box=box,
                                     periodic=periodic)
    _check("shake_positions", cons, x_new, x_old)
    m, k = cons.atoms.shape
    x = x_new.clone()
    dv = torch.zeros_like(x_new)
    lib = build.load_library()
    status = lib.conp2_shake_positions_f32(
        x_new.data_ptr(), x_old.data_ptr(), cons.atoms.data_ptr(),
        cons.amask.data_ptr(), cons.ci.data_ptr(), cons.cj.data_ptr(),
        cons.invm.data_ptr(), cons.dist2.data_ptr(), cons.cmask.data_ptr(),
        m, k, cons.ci.shape[1], float(dt),
        *_geometry(box, periodic), x.data_ptr(), dv.data_ptr(),
        build.stream_ptr())
    build.check_status("shake_positions", status)
    shake_launches.count += 1
    return x, dv


def rattle_velocities(cons, x, v, *, box, periodic):
    """RATTLE: v (N, 3) with the relative velocities along each constraint
    removed at positions x (N, 3)."""
    if v.device.type == "cpu":
        return rattle_velocities_plain(cons, x, v, box=box, periodic=periodic)
    _check("rattle_velocities", cons, x, v)
    m, k = cons.atoms.shape
    out = v.clone()
    lib = build.load_library()
    status = lib.conp2_rattle_velocities_f32(
        x.data_ptr(), v.data_ptr(), cons.atoms.data_ptr(),
        cons.amask.data_ptr(), cons.ci.data_ptr(), cons.cj.data_ptr(),
        cons.invm.data_ptr(), cons.cmask.data_ptr(), m, k, cons.ci.shape[1],
        *_geometry(box, periodic), out.data_ptr(), build.stream_ptr())
    build.check_status("rattle_velocities", status)
    rattle_launches.count += 1
    return out
