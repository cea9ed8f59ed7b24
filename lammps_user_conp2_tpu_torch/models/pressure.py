"""Virial and pressure.

The reference books its correction-force virial through LAMMPS ev_tally
(fix_conp.cpp:1436) and leaves the pressure to LAMMPS; here the whole
virial is computed in one place.  The scalar (isotropic) virial

    W = sum_pairs f_ij . r_ij            (pair, bonded, CONP correction)
      + W_kspace                         (the Ewald k-space virial)
      + W_background

gives P = (2 KE + W) / (3 V) * nktv2p (LAMMPS real units); the tensor
P_ab = (sum_i m v_a v_b + W_ab) / V * nktv2p, in Voigt order xx yy zz xy
xz yz.  The pair sums run over row blocks of ``block`` atoms against every
atom, so the transient is a (block, N) slab.  Held against the numerical
volume derivative P = -dE/dV at fixed fractional coordinates
(tests/test_torch_pressure.py).
"""

from __future__ import annotations

import math

import torch

from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.erfc import EWALD_F
from ..ops.pairs import gauss_table_kernels, min_image, special_factors

VOIGT = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
NKTV2P = 68568.415          # LAMMPS real units: pressure conversion


def _pair_blocks(x, q, type_idx, tables, exclusions, *, box, periodic, cutoff,
                 g_ewald, qqr2e, elecheck=None, force_kernel=None,
                 block=512):
    """Yields (dx, rsq, fpair) per row block: fpair = F/r of every pair
    (LJ, real-space Coulomb with its exclusion corrections and, with
    ``elecheck``/``force_kernel``, the CONP Gaussian correction on
    electrode-electrolyte pairs), 0 outside the cutoff."""
    n = x.shape[0]
    cutsq = cutoff * cutoff
    cols = torch.arange(n, device=x.device)
    is_ele = None if elecheck is None else elecheck != 0
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        xi, qi, ti = x[i0:i1], q[i0:i1], type_idx[i0:i1]
        dx = min_image(xi[:, None, :] - x[None, :, :], box, periodic)
        rsq = torch.sum(dx * dx, dim=-1)
        notself = torch.arange(i0, i1, device=x.device)[:, None] != cols[None, :]
        inrange = (rsq < cutsq) & notself
        if exclusions is None:
            si = torch.ones_like(rsq)
        else:
            si = special_factors(exclusions[0][i0:i1], exclusions[1][i0:i1],
                                 cols[None, :], x.dtype)
        rsq_safe = torch.where(inrange, rsq, torch.ones_like(rsq))
        r2inv = 1.0 / rsq_safe
        r6inv = r2inv ** 3
        tij = (ti[:, None], type_idx[None, :])
        zero = torch.zeros_like(rsq)
        flj = torch.where(inrange & (si > 0),
                          si * r6inv * (tables.lj1[tij] * r6inv
                                        - tables.lj2[tij]) * r2inv, zero)
        r = torch.sqrt(rsq_safe)
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        t = 1.0 / (1.0 + 0.3275911 * grij)
        erfc = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                    + t * (-1.453152027 + t * 1.061405429)))) * expm2
        pref = qqr2e * qi[:, None] * q[None, :] / r
        fcoul = pref * (erfc + EWALD_F * grij * expm2) - (1.0 - si) * pref
        fpair = flj + torch.where(inrange, fcoul, zero) * r2inv
        if force_kernel is not None:
            xor = is_ele[i0:i1, None] ^ is_ele[None, :]
            fk = force_kernel(rsq_safe, *tij)
            fpair = fpair + torch.where(
                inrange & xor, qqr2e * qi[:, None] * q[None, :] * fk * r2inv,
                zero)
        yield dx, rsq, fpair


def pair_virial_scalar(x, q, type_idx, tables, exclusions, *, box, periodic,
                       cutoff, g_ewald, qqr2e, block=512):
    """W = sum_(i<j) f_ij . r_ij for LJ and the real-space Coulomb with its
    exclusion corrections (no volume factor)."""
    w = torch.zeros((), dtype=x.dtype, device=x.device)
    for _, rsq, fpair in _pair_blocks(
            x, q, type_idx, tables, exclusions, box=box, periodic=periodic,
            cutoff=cutoff, g_ewald=g_ewald, qqr2e=qqr2e, block=block):
        w = w + 0.5 * torch.sum(fpair * rsq)
    return w


def pair_virial_tensor(x, q, type_idx, tables, exclusions, *, box, periodic,
                       cutoff, g_ewald, qqr2e, elecheck=None,
                       force_kernel=None, block=512):
    """W_ab = sum_(i<j) f_ij,a r_ij,b (Voigt 6-vector) for LJ and the
    real-space Coulomb with its exclusion corrections, and with
    ``elecheck``/``force_kernel`` ((rsq, itype, jtype) -> the correction
    kernel) the CONP Gaussian correction force (the reference's ev_tally,
    fix_conp.cpp:1436)."""
    w = torch.zeros(6, dtype=x.dtype, device=x.device)
    for dx, _, fpair in _pair_blocks(
            x, q, type_idx, tables, exclusions, box=box, periodic=periodic,
            cutoff=cutoff, g_ewald=g_ewald, qqr2e=qqr2e, elecheck=elecheck,
            force_kernel=force_kernel, block=block):
        w = w + torch.stack([0.5 * torch.sum(fpair * dx[..., a] * dx[..., b])
                             for a, b in VOIGT])
    return w


def _bonds(x, bonds, bond_coeffs, box, periodic):
    """(dx, fbr) of the harmonic bonds: f_ij = fbr * dx."""
    bt, i, j = bonds[:, 0], bonds[:, 1], bonds[:, 2]
    dx = min_image(x[i] - x[j], box, periodic)
    r = torch.sqrt(torch.sum(dx * dx, dim=1))
    return dx, -2.0 * bond_coeffs[bt, 0] * (r - bond_coeffs[bt, 1]) / r


def bonded_virial_scalar(x, bonds, bond_coeffs, angles, angle_coeffs, *,
                         box, periodic):
    """W of the harmonic bonds; a harmonic angle's energy depends on the
    angle only, which a uniform dilation keeps: no isotropic virial."""
    w = torch.zeros((), dtype=x.dtype, device=x.device)
    if bonds.shape[0]:
        dx, fbr = _bonds(x, bonds, bond_coeffs, box, periodic)
        w = w + torch.sum(fbr * torch.sum(dx * dx, dim=1))
    return w


def bonded_virial_tensor(x, bonds, bond_coeffs, angles, angle_coeffs, *,
                         box, periodic):
    """Voigt tensor of the harmonic bonds and angles (f1.d1 + f3.d2, the
    three-body split LAMMPS tallies)."""
    w = torch.zeros(6, dtype=x.dtype, device=x.device)
    if bonds.shape[0]:
        dx, fbr = _bonds(x, bonds, bond_coeffs, box, periodic)
        w = w + torch.stack([torch.sum(fbr * dx[:, a] * dx[:, b])
                             for a, b in VOIGT])
    if angles.shape[0]:
        at, i, j, k = angles[:, 0], angles[:, 1], angles[:, 2], angles[:, 3]
        ka = angle_coeffs[at, 0]
        t0 = angle_coeffs[at, 1] * (math.pi / 180.0)
        d1 = min_image(x[i] - x[j], box, periodic)
        d2 = min_image(x[k] - x[j], box, periodic)
        r1sq = torch.sum(d1 * d1, dim=1)
        r2sq = torch.sum(d2 * d2, dim=1)
        r1 = torch.sqrt(r1sq)
        r2 = torch.sqrt(r2sq)
        c = torch.clamp(torch.sum(d1 * d2, dim=1) / (r1 * r2), -1.0, 1.0)
        s = torch.clamp(torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)),
                        min=0.001)
        a = -2.0 * ka * (torch.arccos(c) - t0) / s
        a11 = a * c / r1sq
        a12 = -a / (r1 * r2)
        a22 = a * c / r2sq
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        w = w + torch.stack([torch.sum(f1[:, a_] * d1[:, b_]
                                       + f3[:, a_] * d2[:, b_])
                             for a_, b_ in VOIGT])
    return w


def _kvectors(fk: ewf.FactoredKSpace, dtype):
    """(kx, ky, kz) as (nxy, 1), (nxy, 1), (1, nz) tensors."""
    ux, uy, uz = fk.unitk
    return ((fk.kx_t.to(dtype) * ux)[:, None],
            (fk.ky_t.to(dtype) * uy)[:, None],
            (fk.kz_t.to(dtype) * uz)[None, :])


def kspace_virial_scalar(fk: ewf.FactoredKSpace, x, q):
    """Isotropic Ewald k-space virial W = sum_k u_k |S_k|^2 (1 - k^2/(2g^2)),
    -3 dE/dlnV at fixed fractional coordinates."""
    sr, si = ewf.structure_factor_f(fk, x, q)
    kx, ky, kz = _kvectors(fk, x.dtype)
    ksq = kx ** 2 + ky ** 2 + kz ** 2
    g = fk.g_ewald
    return torch.sum(fk.ug_t.to(x.dtype) * (sr * sr + si * si)
                     * (1.0 - ksq / (2.0 * g * g)))


def kspace_virial_tensor(fk: ewf.FactoredKSpace, x, q):
    """Ewald k-space Voigt tensor
    W_ab = sum_k u_k |S_k|^2 [delta_ab - 2 (1 + k^2/(4g^2)) k_a k_b / k^2]
    (its trace is the scalar's 1 - k^2/(2g^2) form)."""
    sr, si = ewf.structure_factor_f(fk, x, q)
    ug = fk.ug_t.to(x.dtype)
    kx, ky, kz = _kvectors(fk, x.dtype)
    zero = torch.zeros_like(ug)
    kv = (kx + zero, ky + zero, kz + zero)
    ksq = kx ** 2 + ky ** 2 + kz ** 2
    ksq_safe = torch.where(ug > 0, ksq, torch.ones_like(ksq))
    s2 = ug * (sr * sr + si * si)
    g = fk.g_ewald
    vterm = -2.0 * (1.0 + 0.25 * ksq / (g * g)) / ksq_safe
    return torch.stack([torch.sum(s2 * ((1.0 if a == b else 0.0)
                                        + vterm * kv[a] * kv[b]))
                        for a, b in VOIGT])


def pppm_virial_tensor(grid, rho):
    """Mesh k-space Voigt tensor (LAMMPS pppm.cpp vg[] bookkeeping):
    W_ab = sum_k E(k) [delta_ab - 2 (1/k^2 + 1/(4g^2)) k_a k_b],
    E(k) = G(k) |rho(k)|^2 / (2V), over the full spectrum: the
    half-spectrum influence function mirrored along z (it is even in
    each wavenumber)."""
    dt, dev = rho.dtype, rho.device
    rhok = torch.fft.fftn(rho.to(dt.to_complex()))
    gh = pppm_ops._dev_greens(grid, dt, dev)
    nzh = gh.shape[2]
    gk = torch.cat([gh, gh[:, :, 1:grid.nz - nzh + 1].flip(2)], dim=2)
    ek = 0.5 * gk * torch.abs(rhok) ** 2 / grid.volume
    mk = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    kx = mk(grid.fkx)[:, None, None]
    ky = mk(grid.fky)[None, :, None]
    kz = mk(grid.fkz)[None, None, :]
    zero = torch.zeros_like(ek)
    kv = (kx + zero, ky + zero, kz + zero)
    ksq = kx ** 2 + ky ** 2 + kz ** 2
    ksq_safe = torch.where(ksq > 0, ksq, torch.ones_like(ksq))
    g = grid.g_ewald
    vterm = torch.where(ksq > 0, -2.0 * (1.0 / ksq_safe + 0.25 / (g * g)),
                        torch.zeros_like(ksq))
    return torch.stack([torch.sum(ek * ((1.0 if a == b else 0.0)
                                        + vterm * kv[a] * kv[b]))
                        for a, b in VOIGT])


def _engine_bonded(engine, x, fn):
    if not engine.has_bonded:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return fn(x, engine.bonds, engine.bond_coeffs, engine.angles,
              engine.angle_coeffs, box=engine.ksp_force.box,
              periodic=engine.system.periodic)


def _volume(engine) -> float:
    b = engine.ksp_force.box
    return b[0] * b[1] * b[2]


def pressure_tensor(engine, state, *, block=512):
    """Voigt pressure tensor (xx yy zz xy xz yz) in atmospheres,
    P_ab = (sum_i m v_a v_b + W_ab) / V * nktv2p: the pair, exclusion, CONP
    correction, bonded and k-space (Ewald or mesh) virials, the background
    term on the diagonal.  Slab systems: the z components hold the real and
    k-space parts only (the slab correction's virial has no NPT consumer,
    as in the reference)."""
    sys = engine.system
    u = engine.units
    x, q, v = state.x, state.q, state.v
    kern = None
    if engine.conp is not None:
        # the correction kernel over the engine's (eta, fo) tables, in its
        # dtype: ETA's uniform eta with fo = 0, or EHGO's per-type pairs
        kern = gauss_table_kernels(engine.eta_tab, engine.fo_tab)[1]
    w = pair_virial_tensor(
        x, q, engine.type_idx, engine.tables, engine.exclusions,
        box=engine.ksp_force.box, periodic=sys.periodic,
        cutoff=engine.md.cutoff, g_ewald=engine.ksp_force.g_ewald,
        qqr2e=u.qqr2e, elecheck=engine.elecheck if kern else None,
        force_kernel=kern, block=block)
    w = w + _engine_bonded(engine, x, bonded_virial_tensor)
    if engine.pppm_grid is not None:
        grid = engine.pppm_grid
        # the spread takes the tiled route (K2b) above the dense bound
        rho = pppm_ops.spread(grid, x, q)
        w = w + u.qqr2e * pppm_virial_tensor(grid, rho)
        g, volume = grid.g_ewald, grid.volume
    else:
        w = w + u.qqr2e * kspace_virial_tensor(engine.fksp, x, q)
        g, volume = engine.ksp_force.g_ewald, engine.ksp_force.volume
    # the background term E_bg ~ 1/V gives delta_ab E_bg (the self term is
    # volume-independent: no virial)
    qsum = torch.sum(q)
    ebg = u.qqr2e * math.pi / (2 * g * g * volume) * qsum * qsum
    w = w + torch.stack([ebg, ebg, ebg, 0 * ebg, 0 * ebg, 0 * ebg])
    mass = engine.integrator.mass
    ke6 = torch.stack([torch.sum(mass * v[:, a] * v[:, b]) * u.mvv2e
                       for a, b in VOIGT])
    return (ke6 + w) / _volume(engine) * NKTV2P


def pressure_scalar(engine, state, *, block=512):
    """Isotropic pressure in atmospheres, P = (2 KE + W) / (3 V) * nktv2p,
    on the Ewald force path (the pair, bonded and Ewald k-space virials and
    the background term; no CONP correction, as in the JAX package)."""
    sys = engine.system
    u = engine.units
    x, q, v = state.x, state.q, state.v
    w = pair_virial_scalar(
        x, q, engine.type_idx, engine.tables, engine.exclusions,
        box=engine.ksp_force.box, periodic=sys.periodic,
        cutoff=engine.md.cutoff, g_ewald=engine.ksp_force.g_ewald,
        qqr2e=u.qqr2e, block=block)
    w = w + _engine_bonded(engine, x, bonded_virial_scalar)
    if engine.fksp is not None:
        w = w + u.qqr2e * kspace_virial_scalar(engine.fksp, x, q)
        g = engine.ksp_force.g_ewald
        qsum = torch.sum(q)
        w = w + 3.0 * u.qqr2e * math.pi / (
            2 * g * g * engine.ksp_force.volume) * qsum * qsum
    ke2 = u.mvv2e * torch.sum(engine.integrator.mass[:, None] * v * v)
    return (ke2 + w) / (3.0 * _volume(engine)) * NKTV2P
