"""Factorized Ewald: k-space sums as dense matrix products.

The reference's lowmem mode factorizes trig tables as xy * z products
(km_ewald.cpp:360-363).  With e^{ik.r} = e^{i(kx x + ky y)} * e^{i kz z}
every k-space sum becomes a product of (N, nxy) and (N, nz) tables:

    S(kxy, kz)   = P^T diag(q) Z               [structure factors]
    E            = sum ug |S|^2
    F_j          = 2 q_j sum ug k Im[P_j Z_j conj(S)]
    phi(points)  = sum 2 ug Re[S conj(Pe) conj(Ze)]     [b-vector readout]

The tables take O(N*(nxy+nz)) transcendentals; the products are plain
``torch.matmul`` in full float32 or float64 (TF32 is off, see the package
``__init__``).  The (kxy, kz) grid covers exactly the half-space set of
``ops.ewald.setup_ewald`` (excluded combinations get ug=0).

Up to ``KXY_CHUNK`` xy vectors the (N, nxy) tables are built once per
step and shared between the charge solve and the forces; above it they are
never formed whole: the sums run over chunks of ``KXY_CHUNK`` xy vectors (a
Python loop over a count fixed by the tables, so it captures in a CUDA
graph), and the extra memory stays O(N * KXY_CHUNK).  ``make_phi_operator_kv``
is the k-space part of the matrix-free CG operator.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .ewald import EwaldKSpace

# above this kxy count the (N, nxy) tables are scanned in chunks instead of
# formed whole (at 100k atoms x 5,000+ xy vectors they are GBs)
KXY_CHUNK = 1024


class FactoredKSpace(nn.Module):
    """Factorized tables built from an EwaldKSpace's parameters.  Host
    copies (``kxy``, ``kz``, ``ug`` as numpy) plus device buffers in the run
    dtype (``kx_t``, ``ky_t``, ``kz_t``, ``ug_t``)."""

    def __init__(self, *, g_ewald, volume, slabflag, box, unitk, kxy, kz, ug,
                 ug_tot, device=None, dtype=torch.float64):
        super().__init__()
        self.g_ewald = g_ewald
        self.volume = volume
        self.slabflag = slabflag
        self.box = box
        self.unitk = unitk            # (ux, uy, uz) with uz slab-extended
        self.kxy = kxy                # (nxy, 2) int
        self.kz = kz                  # (nz,) int, -kzmax..kzmax
        self.ug = ug                  # (nxy, nz) weights; 0 where excluded
        self.ug_tot = ug_tot
        mk = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.register_buffer("kx_t", mk(kxy[:, 0]))
        self.register_buffer("ky_t", mk(kxy[:, 1]))
        self.register_buffer("kz_t", mk(kz))
        self.register_buffer("ug_t", mk(ug))

    @property
    def nxy(self) -> int:
        return len(self.kxy)

    @property
    def nz(self) -> int:
        return len(self.kz)


def factorize(ksp: EwaldKSpace, *, device=None,
              dtype=torch.float64) -> FactoredKSpace:
    """Build the (kxy, kz) factorization covering ksp's half-space set."""
    xprd, yprd, zprd = ksp.box
    zprd_slab = zprd * (ksp.slab_volfactor if ksp.slabflag else 1.0)
    unitk = (2 * math.pi / xprd, 2 * math.pi / yprd, 2 * math.pi / zprd_slab)
    kxm, kym, kzm = ksp.kxmax, ksp.kymax, ksp.kzmax
    gsqmx = max((unitk[0] * kxm) ** 2, (unitk[1] * kym) ** 2,
                (unitk[2] * kzm) ** 2) * 1.00001

    xy = []
    for kx in range(0, kxm + 1):
        for ky in range(-kym, kym + 1):
            if kx == 0 and ky < 0:
                continue
            xy.append((kx, ky))
    xy = np.array(xy, np.int64)
    kz = np.arange(-kzm, kzm + 1, dtype=np.int64)

    kxc = xy[:, 0] * unitk[0]
    kyc = xy[:, 1] * unitk[1]
    kzc = kz * unitk[2]
    sqk = (kxc ** 2 + kyc ** 2)[:, None] + (kzc ** 2)[None, :]
    # half-space rule: (kx>0) | (kx==0 & ky>0) | (kx==0 & ky==0 & kz>0)
    half = (xy[:, 0] > 0)[:, None] | ((xy[:, 0] == 0) & (xy[:, 1] > 0))[:, None] \
        | (((xy[:, 0] == 0) & (xy[:, 1] == 0))[:, None] & (kz > 0)[None, :])
    inc = half & (sqk <= gsqmx) & (sqk > 0)
    preu = 4.0 * math.pi / ksp.volume
    sqk_safe = np.where(inc, sqk, 1.0)
    ug = np.where(inc, preu * np.exp(-0.25 * sqk_safe / ksp.g_ewald ** 2) / sqk_safe, 0.0)
    # drop all-zero xy rows (xy pairs fully outside the sphere)
    keep = ug.any(axis=1)
    return FactoredKSpace(
        g_ewald=ksp.g_ewald, volume=ksp.volume, slabflag=ksp.slabflag,
        box=ksp.box, unitk=unitk, kxy=xy[keep], kz=kz, ug=ug[keep],
        ug_tot=float(2.0 * ug.sum()), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# per-step tables and sums
# ---------------------------------------------------------------------------

def _frac_ku(coord, inv_l, k):
    """frac(k * coord/L) in [-0.5, 0.5) with float32-safe precision.

    Naive k*u loses ~k*ulp(u) of phase (k up to several hundred -> 1e-4 rad
    in float32, visible as ~1e-3 e charge errors).  Split u into a 12-bit
    head (k*u_hi is exact in float32 for |k| <= 4096) and a small tail,
    reduce the head modulo 1 exactly, and add the tail: phase error ~ ulp,
    not k*ulp."""
    u = coord * inv_l
    u = u - torch.floor(u)
    scale = 4096.0
    u_hi = torch.round(u * scale) * (1.0 / scale)
    u_lo = u - u_hi
    a = k[None, :] * u_hi[:, None]
    a = a - torch.floor(a)
    ph = a + k[None, :] * u_lo[:, None]
    return ph - torch.round(ph)


def _xy_tables(x, kx, ky, unitk):
    """(Pr, Pi) (N, nxy) phase tables for the xy axes."""
    ux, uy, _ = unitk
    two_pi = 2.0 * math.pi
    # unitk = 2*pi/L -> coord/L = coord * unitk / (2*pi)
    fx = _frac_ku(x[:, 0], ux / two_pi, kx)
    fy = _frac_ku(x[:, 1], uy / two_pi, ky)
    fxy = fx + fy
    phase_xy = two_pi * (fxy - torch.round(fxy))
    return torch.cos(phase_xy), torch.sin(phase_xy)


def _z_tables(x, kz, unitk):
    """(Zr, Zi) (N, nz) phase tables for the z axis."""
    two_pi = 2.0 * math.pi
    phase_z = two_pi * _frac_ku(x[:, 2], unitk[2] / two_pi, kz)
    return torch.cos(phase_z), torch.sin(phase_z)


def axis_tables_kv(x, kx, ky, kz, unitk):
    """((Pr, Pi) (N, nxy), (Zr, Zi) (N, nz)) phase tables for the xy
    vectors (kx, ky) and the z vectors kz (tensors of x's dtype)."""
    return _xy_tables(x, kx, ky, unitk), _z_tables(x, kz, unitk)


def axis_tables(fk: FactoredKSpace, x):
    """((Pr, Pi) (N, nxy), (Zr, Zi) (N, nz)) phase tables."""
    return axis_tables_kv(x, fk.kx_t, fk.ky_t, fk.kz_t, fk.unitk)


def _pad_kxy(kx, ky, ug, chunk):
    """(kx, ky, ug) padded along the xy axis to a multiple of ``chunk``
    (padded rows: k = 0, ug = 0, so they add nothing), and nxy."""
    nxy = kx.shape[0]
    npad = (-nxy) % chunk
    if npad:
        kx = torch.cat([kx, kx.new_zeros(npad)])
        ky = torch.cat([ky, ky.new_zeros(npad)])
        ug = torch.cat([ug, ug.new_zeros((npad, ug.shape[1]))])
    return kx, ky, ug, nxy


def kxy_shard(fk: FactoredKSpace, d: int, rank: int):
    """Rank ``rank``'s share of the xy vectors among ``d``: (kx, ky, ug),
    the contiguous rows [rank nl, (rank + 1) nl) of the tables padded to d
    nl rows with k = 0 and ug = 0, so pad rows add nothing (JAX
    ``parallel/sharded.py:138-145``).  The ``*_fkv`` functions take a
    shard as they take the whole, in chunks of ``KXY_CHUNK`` above it."""
    nl = -(-fk.nxy // d)
    kx, ky, ug, _ = _pad_kxy(fk.kx_t, fk.ky_t, fk.ug_t, nl * d)
    sl = slice(rank * nl, (rank + 1) * nl)
    return kx[sl].contiguous(), ky[sl].contiguous(), ug[sl].contiguous()


def structure_factor_f(fk: FactoredKSpace, x, q):
    """S(kxy, kz): (Sr, Si), each (nxy, nz)."""
    return structure_factor_fkv(x, q, fk.kx_t, fk.ky_t, fk.kz_t, fk.unitk)


def structure_factor_fkv(x, q, kx, ky, kz, unitk):
    if kx.shape[0] > KXY_CHUNK:
        return _structure_factor_chunked(x, q, kx, ky, kz, unitk)
    return structure_factor_tab(axis_tables_kv(x, kx, ky, kz, unitk), q)


def _sf_chunks(x, q, kx, ky, ztabs, unitk, chunk):
    """S per chunk of ``chunk`` xy vectors, the z tables built once."""
    return [structure_factor_tab(
        (_xy_tables(x, kx[lo:lo + chunk], ky[lo:lo + chunk], unitk), ztabs),
        q) for lo in range(0, kx.shape[0], chunk)]


def _structure_factor_chunked(x, q, kx, ky, kz, unitk, chunk=KXY_CHUNK):
    """S(kxy, kz) over chunks of ``chunk`` xy vectors: O(N * chunk) extra
    memory instead of O(N * nxy)."""
    sfs = _sf_chunks(x, q, kx, ky, _z_tables(x, kz, unitk), unitk, chunk)
    return (torch.cat([sr for sr, _ in sfs]),
            torch.cat([si for _, si in sfs]))


def potential_on_points_f(fk: FactoredKSpace, xe, sr, si):
    """phi(xe) = sum 2 ug Re[S conj(Pe) conj(Ze)]: the b-vector readout from
    the positions of the points."""
    return potential_on_points_fkv(xe, sr, si, fk.kx_t, fk.ky_t, fk.kz_t,
                                   fk.unitk, fk.ug_t)


def potential_on_points_fkv(xe, sr, si, kx, ky, kz, unitk, ug):
    return potential_on_points_tab(axis_tables_kv(xe, kx, ky, kz, unitk),
                                   sr, si, ug)


def structure_factor_tab(tabs, q):
    """S(kxy, kz) from precomputed axis tables: returns (Sr, Si) (nxy, nz).

    The charge solve and the force evaluation run at the same positions, so
    the tables are built once per step and shared.  The four
    (nxy, N) x (N, nz) products ride two matmuls with the real/imag z
    columns concatenated."""
    (pr, pi), (zr, zi) = tabs
    nz = zr.shape[1]
    qz = q[:, None] * torch.cat([zr, zi], dim=1)             # (N, 2nz)
    a = pr.T @ qz                                           # (nxy, 2nz)
    b = pi.T @ qz
    sr = a[:, :nz] - b[:, nz:]
    si = a[:, nz:] + b[:, :nz]
    return sr, si


def potential_on_points_tab(tabs_pts, sr, si, ug):
    """b-vector readout phi(points) from point tables (rows of the per-step
    tables at the electrode indices)."""
    (per, pei), (zer, zei) = tabs_pts
    nxy = sr.shape[0]
    mr = 2.0 * ug * sr
    mi = 2.0 * ug * si
    m = torch.cat([mr.T, mi.T], dim=1)                       # (nz, 2nxy)
    tzr = zer @ m                                           # (Ne, 2nxy)
    tzi = zei @ m
    tr = tzr[:, :nxy] + tzi[:, nxy:]
    ti = tzr[:, nxy:] - tzi[:, :nxy]
    return torch.sum(per * tr + pei * ti, dim=1)


def _energy_forces_from_s(fk: FactoredKSpace, q, tabs, sr, si):
    """(energy, forces) from the full tables and the complete S."""
    return _energy_forces_tabs(q, tabs, sr, si, fk.kx_t, fk.ky_t, fk.kz_t,
                               fk.unitk, fk.ug_t)


def _energy_forces_tabs(q, tabs, sr, si, kx, ky, kz, unitk, ug):
    e = torch.sum(ug * (sr * sr + si * si))
    return e, _forces_from_s(q, tabs, sr, si, kx, ky, kz, unitk, ug)


def _forces_from_s(q, tabs, sr, si, kx, ky, kz, unitk, ug):
    """2 q_j sum ug k Im[P_j Z_j conj(S)] over the tables' xy vectors."""
    (pr, pi), (zr, zi) = tabs
    nxy = pr.shape[1]
    wr = ug * sr
    wi = -ug * si
    ux, uy, uz = unitk
    kzv = kz * uz
    # the eight (N, nz) x (nz, nxy) products ride two matmuls with the four
    # weighted-S variants concatenated along columns
    w4 = torch.cat([wr.T, wi.T, (wr * kzv).T, (wi * kzv).T], dim=1)  # (nz, 4nxy)
    A = zr @ w4                                              # (N, 4nxy)
    B = zi @ w4
    gr = A[:, :nxy] - B[:, nxy:2 * nxy]
    gi = A[:, nxy:2 * nxy] + B[:, :nxy]
    gzr = A[:, 2 * nxy:3 * nxy] - B[:, 3 * nxy:]
    gzi = A[:, 3 * nxy:] + B[:, 2 * nxy:3 * nxy]
    im_pg = pr * gi + pi * gr
    im_pgz = pr * gzi + pi * gzr
    kmat = torch.stack([kx * ux, ky * uy], dim=1)           # (nxy, 2)
    fxy = im_pg @ kmat                                       # (N, 2)
    fz = torch.sum(im_pgz, dim=1)
    return 2.0 * q[:, None] * torch.cat([fxy, fz[:, None]], dim=1)


def energy_forces_cached(fk: FactoredKSpace, q, tabs, sr_elyte, si_elyte,
                         ele_rows):
    """(energy, forces) with the per-step caches from the charge solve:
    ``tabs`` are the full-atom axis tables and (sr_elyte, si_elyte) the
    electrolyte structure factor at the same positions.  Only the electrode
    rows add new structure factor; ``ele_rows`` takes them from a tensor
    (``ConpSolver.ele_rows``: a slice in the electrodes-first layout)."""
    (pr, pi), (zr, zi) = tabs
    nz = zr.shape[1]
    qz = ele_rows(q)[:, None] * torch.cat([ele_rows(zr), ele_rows(zi)],
                                          dim=1)                # (Ne, 2nz)
    ar = ele_rows(pr).T @ qz
    br = ele_rows(pi).T @ qz
    sr = sr_elyte + ar[:, :nz] - br[:, nz:]
    si = si_elyte + ar[:, nz:] + br[:, :nz]
    return _energy_forces_from_s(fk, q, tabs, sr, si)


def energy_forces_f(fk: FactoredKSpace, x, q):
    """(energy, forces) without the qqr2e prefactor -- plain Ewald k-space
    from the positions alone (in chunks above KXY_CHUNK xy vectors)."""
    return energy_forces_fkv(x, q, fk.kx_t, fk.ky_t, fk.kz_t, fk.unitk,
                             fk.ug_t)


def energy_forces_fkv(x, q, kx, ky, kz, unitk, ug):
    if kx.shape[0] > KXY_CHUNK:
        return _energy_forces_chunked(x, q, kx, ky, kz, unitk, ug)
    tabs = axis_tables_kv(x, kx, ky, kz, unitk)
    sr, si = structure_factor_tab(tabs, q)
    return _energy_forces_tabs(q, tabs, sr, si, kx, ky, kz, unitk, ug)


def _energy_forces_chunked(x, q, kx, ky, kz, unitk, ug, chunk=KXY_CHUNK):
    """``energy_forces_fkv`` over chunks of ``chunk`` xy vectors, in two
    passes (the forces need the complete structure factor), each
    O(N * chunk) in extra memory; the z tables are built once for both.
    The chunks' force sums add in chunk order."""
    kx, ky, ug, nxy = _pad_kxy(kx, ky, ug, chunk)
    ztabs = _z_tables(x, kz, unitk)
    # pass 1: the structure factor per chunk (small: chunk x nz)
    sfs = _sf_chunks(x, q, kx, ky, ztabs, unitk, chunk)
    los = range(0, kx.shape[0], chunk)
    e = sum(torch.sum(ug[lo:lo + chunk] * (sr * sr + si * si))
            for lo, (sr, si) in zip(los, sfs))
    # pass 2: the forces per chunk
    f = torch.zeros_like(x)
    for lo, (sr, si) in zip(los, sfs):
        sl = slice(lo, lo + chunk)
        tabs = (_xy_tables(x, kx[sl], ky[sl], unitk), ztabs)
        f = f + _forces_from_s(q, tabs, sr, si, kx[sl], ky[sl], kz, unitk,
                               ug[sl])
    return e, f


@dataclasses.dataclass
class PhiOperator:
    """p -> phi(xe) for charges p placed at the points xe: the self-adjoint
    k-space operator of matrix-free CG, phi = sum_k 2 ug Re[S(p) conj(E_e)],
    the structure factor of p and its readout at the points.  The points'
    phase tables are built once (``make_phi_operator_kv``) and every apply
    reuses them: eight (Ne, nxy, nz) products, four matmuls with the real
    and imaginary columns side by side."""
    tabs: tuple           # ((Pr, Pi) (Ne, nxy), (Zr, Zi) (Ne, nz))
    ug: torch.Tensor      # (nxy, nz)

    def __call__(self, p):
        sr, si = structure_factor_tab(self.tabs, p)
        return potential_on_points_tab(self.tabs, sr, si, self.ug)


def make_phi_operator_kv(xe, kx, ky, kz, unitk, ug) -> PhiOperator:
    """The k-space operator of matrix-free CG at the points xe, their phase
    tables built here, once per solve."""
    return PhiOperator(axis_tables_kv(xe, kx, ky, kz, unitk), ug)


# ---------------------------------------------------------------------------
# host-side (numpy) A-matrix k-space block
# ---------------------------------------------------------------------------

PLANE_MAX = 64


def amatrix_kspace_host(xe, ksp: EwaldKSpace, *, plane_max: int = PLANE_MAX,
                        chunk: int = 8192) -> np.ndarray:
    """K-space A block on the host (numpy, float64).

    Uses the xy*z factorization plus the observation that electrode atoms
    occupy a handful of distinct z values (lattice planes):

        A_ij = Re sum_a Pxy_i,a conj(Pxy_j,a) G_a(plane_i, plane_j)
        G_a(p, q) = sum_b 2 ug[a,b] exp(i kz_b uz (z_p - z_q))

    which is O(Ne^2 nxy + nxy nz P^2) with no (Ne, K) tables.  Falls back
    to a K-chunked direct sum when the electrodes are not plane-structured
    (P > plane_max).  Returns the full k-space block including the ug_tot
    diagonal and the slab correction."""
    xe = np.asarray(xe, np.float64)
    zu, zinv = np.unique(xe[:, 2], return_inverse=True)
    if len(zu) <= plane_max:
        a = _amatrix_host_planes(xe, ksp, zu, zinv)
    else:
        a = _amatrix_host_chunked(xe, ksp, chunk)
    diag = ksp.ug_tot - (2.0 / math.sqrt(math.pi)) * ksp.g_ewald
    np.fill_diagonal(a, diag)
    if ksp.slabflag:
        z = xe[:, 2]
        a = a + (4.0 * math.pi / ksp.volume) * np.outer(z, z)
    return a


def _amatrix_host_planes(xe, ksp, zu, zinv):
    fk = factorize(ksp)
    ux, uy, uz = fk.unitk
    nxy = fk.nxy
    p_cnt = len(zu)
    # G[a, p, q] = sum_b 2 ug[a,b] e^{i kz_b uz (zu_p - zu_q)}
    dz = (zu[:, None] - zu[None, :]).ravel()                 # (P*P,)
    ez = np.exp(1j * uz * np.outer(fk.kz.astype(np.float64), dz))  # (nz, P*P)
    g = (2.0 * fk.ug) @ ez                                   # (nxy, P*P)
    g = g.reshape(nxy, p_cnt, p_cnt)
    phase = np.outer(xe[:, 0] * ux, fk.kxy[:, 0]) + \
        np.outer(xe[:, 1] * uy, fk.kxy[:, 1])
    pxy = np.exp(1j * phase)                                 # (Ne, nxy)
    a = np.zeros((xe.shape[0], xe.shape[0]))
    groups = [np.nonzero(zinv == p)[0] for p in range(p_cnt)]
    for p in range(p_cnt):
        ip = groups[p]
        for q in range(p, p_cnt):
            jq = groups[q]
            blk = ((pxy[ip] * g[:, p, q][None, :]) @ pxy[jq].conj().T).real
            a[np.ix_(ip, jq)] = blk
            if q != p:
                a[np.ix_(jq, ip)] = blk.T
    return a


def _amatrix_host_chunked(xe, ksp, chunk):
    """Direct half-space sum, K-chunked, from per-axis complex power
    tables gathered per chunk."""
    xprd, yprd, zprd = ksp.box
    zprd_slab = zprd * (ksp.slab_volfactor if ksp.slabflag else 1.0)
    unitk = np.array([2 * math.pi / xprd, 2 * math.pi / yprd,
                      2 * math.pi / zprd_slab])
    kint = np.rint(ksp.kvecs / unitk).astype(np.int64)       # (K, 3)
    axp = np.exp(1j * unitk[0] * np.outer(xe[:, 0], np.arange(ksp.kxmax + 1)))
    ayp = np.exp(1j * unitk[1] * np.outer(
        xe[:, 1], np.arange(-ksp.kymax, ksp.kymax + 1)))
    azp = np.exp(1j * unitk[2] * np.outer(
        xe[:, 2], np.arange(-ksp.kzmax, ksp.kzmax + 1)))
    ne = xe.shape[0]
    a = np.zeros((ne, ne))
    for lo in range(0, ksp.kcount, chunk):
        hi = min(lo + chunk, ksp.kcount)
        ki = kint[lo:hi]
        e = axp[:, ki[:, 0]] * ayp[:, ki[:, 1] + ksp.kymax] \
            * azp[:, ki[:, 2] + ksp.kzmax]                   # (Ne, Kc)
        tw = 2.0 * ksp.ug[lo:hi]
        c = np.ascontiguousarray(e.real)
        s = np.ascontiguousarray(e.imag)
        a += (c * tw) @ c.T + (s * tw) @ s.T
    return a
