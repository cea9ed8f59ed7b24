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
float32 tensors and take the plain version for CPU and CUDA float64
tensors (``build.kernel_route``).  On the card each call is one launch that writes every row
of its outputs once: the clusters' valid rows from the packed cluster
records (``pack_records``), the free rows copied from the input through
the free-row table (``free_rows``); both are built once, at setup, by
``models.shake.ShakeConstraints``.  SHAKE's dv is (x - x_new) times 1/dt
formed in double and rounded to float32, which is how PyTorch divides a
CUDA float32 tensor by a Python float, so it equals the plain version's
on the card bit for bit at any dt.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pairs import min_image
from . import build

ITERS = 12   # the JAX package's fixed sweep count (models/shake.py)
# the slot code of a cluster whose slots are (0,1), (1,2), (0,2), all
# constrained (the il decks' cations): the one csrc/shake_kernel.cu
# instantiates with its columns known at compile time (SH_LINEAR3)
LINEAR3_CODE = (0 | 1 << 2 | 1 << 4) | (1 | 2 << 2 | 1 << 4) << 5 | (
    0 | 2 << 2 | 1 << 4) << 10

shake_launches = build.LaunchCounter("shake_positions")
rattle_launches = build.LaunchCounter("rattle_velocities")


def record_len(c: int) -> int:
    """int32 words of one packed cluster record with ``c`` slots: the atom
    ids (4), (code, amask bits, 0, 0), per slot (imi, imj, 2 (imi + imj),
    d^2), the slots' imi + imj padded to a multiple of 4."""
    return 4 * (2 + c + (c + 3) // 4)


def pack_records(atoms, amask, ci, cj, dist2, cmask, invm):
    """(records, code): one int32 row of ``record_len(C)`` words per
    cluster, float fields stored as float32 bits, each formed in float32 as
    the kernels form them (imi + imj, then times 2); code is the slot code
    every cluster shares (slot s: si | sj << 2 | cmask << 4 at bit 5 s),
    or -1.  Padding atom columns repeat column 0 (at most 4 columns)."""
    atoms = np.asarray(atoms, np.int64)
    amask = np.asarray(amask, bool)
    ci = np.asarray(ci, np.int64)
    cj = np.asarray(cj, np.int64)
    cmask = np.asarray(cmask, bool)
    m, k = atoms.shape
    c = ci.shape[1]
    if k > 4 or c > 6 or ci.max(initial=0) > 3 or cj.max(initial=0) > 3:
        raise ValueError(f"shake clusters of {k} atoms and {c} slots: the "
                         "records hold at most 4 atoms and 6 slots")
    invm32 = np.asarray(invm, np.float32)
    imi = np.take_along_axis(invm32, ci, 1)
    imj = np.take_along_axis(invm32, cj, 1)
    isum = imi + imj                               # float32, rounded once
    rec = np.zeros((m, record_len(c) // 4, 4), np.int32)
    rec[:, 0, :k] = atoms
    rec[:, 0, k:] = atoms[:, :1]
    codes = np.zeros(m, np.int64)
    for s in range(c):
        codes |= (ci[:, s] | cj[:, s] << 2 | cmask[:, s].astype(np.int64)
                  << 4) << (5 * s)
    rec[:, 1, 0] = codes
    rec[:, 1, 1] = (amask.astype(np.int64) << np.arange(k)).sum(1)
    f = rec.view(np.float32)
    f[:, 2:2 + c] = np.stack([imi, imj, np.float32(2.0) * isum,
                              np.asarray(dist2, np.float32)], axis=-1)
    for s in range(c):
        f[:, 2 + c + s // 4, s % 4] = isum[:, s]
    code = int(codes[0]) if m and (codes == codes[0]).all() else -1
    return rec.reshape(m, -1), code


def free_rows(atoms, amask, natoms):
    """int32, ascending: the free rows, the atoms of ``natoms`` in no
    cluster's valid columns.  Raises if an atom is in two clusters' valid
    columns or outside the atoms."""
    taken = np.asarray(atoms, np.int64)[np.asarray(amask, bool)]
    count = np.bincount(taken, minlength=natoms)
    if count.shape[0] > natoms or (count > 1).any():
        raise ValueError("shake clusters must be disjoint and inside the "
                         f"{natoms} atoms")
    return np.flatnonzero(count == 0).astype(np.int32)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _tables(cons):
    """(atoms, rows, ci, cj, invm_i, invm_j) with int64 indices."""
    atoms = cons.atoms.long()
    rows = torch.arange(atoms.shape[0], device=atoms.device)
    ci, cj = cons.ci.long(), cons.cj.long()
    return (atoms, rows, ci, cj, torch.gather(cons.invm, 1, ci),
            torch.gather(cons.invm, 1, cj))


def _write_back(cons, out, clusters):
    """``out`` with the clusters' valid entries written to their rows,
    through the index tables ``ShakeConstraints`` built at setup (no
    boolean mask, so no host sync on the card)."""
    out[cons.valid_rows] = clusters.reshape(-1, 3)[cons.valid_flat]
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
    x = _write_back(cons, x_new.clone(), xc)
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
    return _write_back(cons, v.clone(), vc)


def _check(name, cons, *arrays):
    build.check_cuda(name, torch.float32, *arrays)
    build.check_cuda(name, torch.int32, cons.rec, cons.free_rows)
    n = arrays[0].shape[0]
    if any(a.shape != (n, 3) for a in arrays):
        raise ValueError(f"{name}: expected (N, 3) positions/velocities")
    if n != cons.natoms:
        raise ValueError(f"{name}: {n} rows, but the free-row table is for "
                         f"{cons.natoms} atoms")
    if cons.rec.data_ptr() % 16:
        raise ValueError(f"{name}: the cluster records are not 16-byte "
                         "aligned")


def _geometry(box, periodic):
    return [float(b) for b in box] + [int(bool(p)) for p in periodic]


def _shape(cons):
    """(M, free rows, K, C, code): the launch's table sizes."""
    m, k = cons.atoms.shape
    return m, cons.free_rows.shape[0], k, cons.ci.shape[1], cons.code


def shake_positions(cons, x_new, x_old, dt, *, box, periodic):
    """SHAKE: returns (x, dv = (x - x_new)/dt).  x_new, x_old (N, 3): the
    positions after and before the drift; ``cons`` the
    ``models.shake.ShakeConstraints`` tables on the same device.  On the
    card: one launch writes every row of x and dv (float32; the plain
    version for CPU and CUDA float64 tensors)."""
    if not build.kernel_route("shake_positions", x_new):
        return shake_positions_plain(cons, x_new, x_old, dt, box=box,
                                     periodic=periodic)
    _check("shake_positions", cons, x_new, x_old)
    x = torch.empty_like(x_new)
    dv = torch.empty_like(x_new)
    lib = build.load_library()
    status = lib.conp2_shake_positions_f32(
        x_new.data_ptr(), x_old.data_ptr(), cons.rec.data_ptr(),
        cons.free_rows.data_ptr(), *_shape(cons), 1.0 / float(dt),
        *_geometry(box, periodic), x.data_ptr(), dv.data_ptr(),
        build.stream_ptr())
    build.check_status("shake_positions", status)
    shake_launches.count += 1
    return x, dv


def rattle_velocities(cons, x, v, *, box, periodic):
    """RATTLE: v (N, 3) with the relative velocities along each constraint
    removed at positions x (N, 3).  On the card: one launch writes every
    row of the result (float32; the plain version for CPU and CUDA float64
    tensors)."""
    if not build.kernel_route("rattle_velocities", v):
        return rattle_velocities_plain(cons, x, v, box=box, periodic=periodic)
    _check("rattle_velocities", cons, x, v)
    out = torch.empty_like(v)
    lib = build.load_library()
    status = lib.conp2_rattle_velocities_f32(
        x.data_ptr(), v.data_ptr(), cons.rec.data_ptr(),
        cons.free_rows.data_ptr(), *_shape(cons), *_geometry(box, periodic),
        out.data_ptr(), build.stream_ptr())
    build.check_status("rattle_velocities", status)
    rattle_launches.count += 1
    return out
