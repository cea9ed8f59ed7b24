"""PPPM (mesh Ewald): grid setup, B-spline spread, FFT Poisson, ad/ik forces.

The JAX package's ``ops/pppm.py`` in PyTorch:

  * grid + g_ewald selection (``set_grid_and_gewald``) reproduces LAMMPS
    pppm.cpp set_grid_global / adjust_gewald; the optimised influence
    function (Hockney-Eastwood, LAMMPS compute_gf_ik) is built once in
    float64 with explicit Brillouin sums (``compute_greens``);
  * small meshes take the dense path: per-axis weight matrices and
    matmuls (``spread``, ``gather``, ``gather3``, ``gather3_ad``);
  * large meshes take the tiled z-binned path of the production cell:
    atoms binned into 3-D mesh tiles (``tile_assign``, refreshed per step
    by ``refresh_tile_slots``), the charge spread straight into the
    z-binned mesh (K2a, ``ops/kernels/pppm_spread.py``), a shifted z-DFT
    matmul over the occupied rows plus an xy FFT (``_spread_rhok_tiled``),
    the Poisson solve and inverse transform back onto the z-binned rows
    (``pppm_energy_u_zbin``), and the ad force gather from those rows (K3,
    ``ops/kernels/pppm_gather.py``, ``gather3_ad_zbin``);
  * electrodes that sit on a few z planes take the z-plane transforms
    (``spread_zplanes``, ``rhok_from_zplanes``, ``u_on_zplanes``,
    ``gather_zplanes``).

``torch.fft`` takes the place of the JAX package's exact-phase xy DFT
matmuls (``_xy_fft2``/``_xy_ifft2``) and of its dense z DFT (``rfft3``/
``irfft3``): the same transforms, held to the JAX functions by the tests.
The z-binned rows overlap and are shifted, so their z transform stays a
matmul with the host-built float64 phase tables cast to the run dtype.

The z-binned route runs in every dtype (the JAX float64 engine takes the
real-mesh tiled spread/gather instead: the same algebra).  The real-mesh
tiled path serves ``spread``, ``gather`` and ``gather3`` above the dense
bound (the electrode re-spread and b-vector readout when the electrodes are
not read through their z planes, and the ik force readout on a tiled
mesh): per-tile charge patches (K2b, ``ops/kernels/pppm_spread.py
spread_tiles``) overlap-added into the (nx, ny, nz) mesh
(``spread_tiled``), and a per-atom stencil readout through the tile slots
of the wrap-padded mesh (``gather_tiled``, plain PyTorch on the card too:
the JAX package computes it in XLA).  ``gather3_ad_tiled`` is not ported
(the engine's ad forces take the z-binned gather in every dtype).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels import pppm_gather, pppm_spread

# Deserno & Holm ik-differentiation error coefficients (LAMMPS pppm.cpp acons)
ACONS = np.zeros((8, 7))
ACONS[1][0] = 2.0 / 3.0
ACONS[2][:2] = [1.0 / 50.0, 5.0 / 294.0]
ACONS[3][:3] = [1.0 / 588.0, 7.0 / 1440.0, 21.0 / 3872.0]
ACONS[4][:4] = [1.0 / 4320.0, 3.0 / 1936.0, 7601.0 / 2271360.0, 143.0 / 28800.0]
ACONS[5][:5] = [1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
                517231.0 / 106536960.0, 106640677.0 / 11737571328.0]
ACONS[6][:6] = [691.0 / 68140800.0, 13.0 / 57600.0, 47021.0 / 35512320.0,
                9694607.0 / 2095994880.0, 733191589.0 / 59609088000.0,
                326190917.0 / 11700633600.0]
ACONS[7][:7] = [1.0 / 345600.0, 3617.0 / 35512320.0, 745739.0 / 838397952.0,
                56399353.0 / 12773376000.0, 25091609.0 / 1560084480.0,
                1755948832039.0 / 36229939200000.0, 4887769399.0 / 37838389248.0]


def estimate_ik_error(h: float, prd: float, natoms: int, q2: float,
                      g_ewald: float, order: int) -> float:
    s = sum(ACONS[order][m] * (h * g_ewald) ** (2 * m) for m in range(order))
    return (q2 * (h * g_ewald) ** order
            * math.sqrt(g_ewald * prd * math.sqrt(2 * math.pi) * s / natoms)
            / (prd * prd))


def factorable(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def next_factorable(n: int) -> int:
    while not factorable(n):
        n += 1
    return n


def set_grid_and_gewald(*, box, accuracy_abs, natoms, q2, cutoff, order=5,
                        slab_volfactor=1.0, g_ewald=None, grid=None):
    """LAMMPS pppm.cpp set_grid_global + adjust_gewald, exactly.

    Returns (g_ewald, (nx, ny, nz_lammps), estimated_accuracy).  The z error
    estimate uses the physical zprd even under slab (LAMMPS behavior,
    validated vs tests/dilute/persist.log)."""
    xprd, yprd, zprd = box
    natoms = max(natoms, 1)
    if g_ewald is None:
        g0 = accuracy_abs * math.sqrt(natoms * cutoff * xprd * yprd * zprd) / (2.0 * q2)
        if g0 >= 1.0:
            g0 = (1.35 - 0.15 * math.log(accuracy_abs)) / cutoff
        else:
            g0 = math.sqrt(-math.log(g0)) / cutoff
    else:
        g0 = g_ewald

    if grid is None:
        ns = []
        for prd in (xprd, yprd, zprd):
            n = max(2, int(prd / (4.0 / g0)))
            while estimate_ik_error(prd / n, prd, natoms, q2, g0, order) > accuracy_abs:
                n += 1
            ns.append(next_factorable(n))
        nx, ny, nz = ns
    else:
        nx, ny, nz = grid

    def df_rspace(g):
        return (2.0 * q2 * math.exp(-g * g * cutoff * cutoff)
                / math.sqrt(natoms * cutoff * xprd * yprd * zprd))

    def df_kspace(g):
        l = [estimate_ik_error(p / n, p, natoms, q2, g, order)
             for p, n in ((xprd, nx), (yprd, ny), (zprd, nz))]
        return math.sqrt(sum(v * v for v in l)) / math.sqrt(3.0)

    g = g0
    if g_ewald is None:
        for _ in range(100):
            f = df_rspace(g) - df_kspace(g)
            h = 1e-6
            fp = (df_rspace(g + h) - df_kspace(g + h) - f) / h
            g -= f / fp
            if abs(df_rspace(g) - df_kspace(g)) < 1e-5:   # LAMMPS SMALL stop
                break
    est = math.sqrt(df_rspace(g) ** 2 + df_kspace(g) ** 2)
    return g, (nx, ny, nz), est


def rho_coeffs(order: int) -> np.ndarray:
    """B-spline polynomial coefficients (LAMMPS compute_rho_coeff):
    rho1d[i](dx) = sum_m coeff[i, m] dx^m, dx in [-1/2, 1/2]."""
    a = np.zeros((order, 2 * order + 1))   # a[l][k+order], k in -order..order
    a[0][order] = 1.0
    for j in range(1, order):
        anew = np.zeros_like(a)
        for k in range(-j, j + 1, 2):
            s = 0.0
            for l in range(j):
                anew[l + 1][k + order] += (a[l][k + 1 + order] - a[l][k - 1 + order]) / (l + 1)
                s += (0.5 ** (l + 1)) * (a[l][k - 1 + order] + ((-1) ** l) * a[l][k + 1 + order]) / (l + 1)
            anew[0][k + order] = s
        a = anew
    coeff = np.zeros((order, order))
    i = 0
    for k in range(-(order - 1), order, 2):
        for l in range(order):
            coeff[i, l] = a[l][k + order]
        i += 1
    return coeff


@dataclasses.dataclass(frozen=True, eq=False)
class PPPMGrid:
    """Static mesh data (host numpy) plus a per-grid cache of the device
    copies of its tables (identity-hashed: grids are never compared)."""
    order: int
    nx: int
    ny: int
    nz: int
    box: tuple               # physical box
    box_lo: tuple
    zprd_grid: float         # z extent the mesh spans (zprd * slab_volfactor)
    volume: float            # mesh volume (slab-extended)
    g_ewald: float
    slabflag: bool
    greens: np.ndarray       # (nx, ny, nz//2+1) half-spectrum influence fn
    fkx: np.ndarray          # (nx,) ik wavevectors
    fky: np.ndarray
    fkz: np.ndarray
    coeffs: np.ndarray       # (order, order) B-spline polynomials
    lammps_grid: tuple       # grid LAMMPS would print
    est_accuracy: float
    tile_cap: Optional[int] = None   # occupancy-measured tile slot capacity
    _dev: dict = dataclasses.field(default_factory=dict, init=False,
                                   repr=False)

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)


def _devconst(grid: PPPMGrid, key, make, dtype, device):
    """``make()`` (host numpy) as a tensor of ``dtype`` on ``device``,
    cached on the grid."""
    k = (key, dtype, str(device))
    if k not in grid._dev:
        grid._dev[k] = torch.as_tensor(np.asarray(make()), dtype=dtype,
                                       device=device)
    return grid._dev[k]


def _wk2(kper: np.ndarray, n: int, order: int) -> np.ndarray:
    """Squared B-spline Fourier transform W(k)^2 per axis index."""
    arg = math.pi * kper / n
    w = np.where(kper == 0, 1.0, np.power(np.where(kper == 0, 1.0, np.sin(arg) / np.where(arg == 0, 1.0, arg)), order))
    return w * w


# influence functions by argument set: a float32 card engine and a float64
# CPU engine of one cell share the (slow) float64 Brillouin sums
_GREENS_CACHE = {}
_GREENS_CACHE_MAX = 4


def compute_greens(nx, ny, nz, box_grid, g_ewald, order, eps_hoc=1e-7,
                   device=None) -> np.ndarray:
    """Hockney-Eastwood optimal influence function (LAMMPS compute_gf_ik)
    on the half spectrum kz in [0, nz//2]: (nx, ny, nz//2+1) float64.

    G(k) = 4 pi / |k|^2 sum_b W^2(k+b) (k.(k+b)) e^{-(k+b)^2/4g^2} / (k+b)^2
           / [sum_b W^2(k+b)]^2
    with explicit per-axis Brillouin images (nb from the EPS_HOC bound).
    Image triples whose every term provably underflows to 0.0 in float64
    are skipped (exact).  The triple sum runs in float64 on ``device``;
    the result is cached per argument set."""
    key = (nx, ny, nz, tuple(float(b) for b in box_grid), float(g_ewald),
           order, eps_hoc)
    if key in _GREENS_CACHE:
        return _GREENS_CACHE[key]
    xprd, yprd, zprd_g = box_grid
    unitk = 2 * math.pi / np.array([xprd, yprd, zprd_g])
    nbs = [int((g_ewald * L / (math.pi * n)) * ((-math.log(eps_hoc)) ** 0.25)) + 2
           for n, L in ((nx, xprd), (ny, yprd), (nz, zprd_g))]

    def per_axis(n):
        k = np.arange(n)
        return np.where(k <= n // 2, k, k - n)

    mx, my, mz = per_axis(nx), per_axis(ny), per_axis(nz)
    kx1, ky1, kz1 = unitk[0] * mx, unitk[1] * my, unitk[2] * mz
    inv4g2 = 0.25 / g_ewald ** 2

    def build_axis(m1, n, u, nb):
        tabs = []
        for b in range(-nb, nb + 1):
            q = u * (m1 + n * b)
            tabs.append((q, _wk2(m1 + n * b, n, order),
                         np.exp(-inv4g2 * q * q)))
        return tabs

    tx = build_axis(mx, nx, unitk[0], nbs[0])
    ty = build_axis(my, ny, unitk[1], nbs[1])
    tz = build_axis(mz, nz, unitk[2], nbs[2])
    swx = np.sum([t[1] for t in tx], axis=0)
    swy = np.sum([t[1] for t in ty], axis=0)
    swz = np.sum([t[1] for t in tz], axis=0)
    kmax_norm = math.sqrt(max(kx1 ** 2)) + math.sqrt(max(ky1 ** 2)) \
        + math.sqrt(max(kz1 ** 2)) + 1.0
    tiny = np.finfo(np.float64).smallest_subnormal
    nzh = nz // 2 + 1
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=device)
    kx, ky, kz = f64(kx1), f64(ky1), f64(kz1[:nzh])
    num = torch.zeros((nx, ny, nzh), dtype=torch.float64, device=device)
    for qx, wx2, ex in tx:
        gx = wx2 * ex
        for qy, wy2, ey in ty:
            gy = wy2 * ey
            exy_max = gx.max() * gy.max()
            for qz, wz2, ez in tz:
                gz = wz2 * ez
                qmin = math.sqrt(np.abs(qx).min() ** 2 + np.abs(qy).min() ** 2
                                 + np.abs(qz).min() ** 2)
                bound = exy_max * gz.max() * kmax_norm / max(
                    qmin, unitk.min() * 0.5)
                if bound < tiny:
                    continue                       # exact: term rounds to 0
                qxt, qyt, qzt = f64(qx), f64(qy), f64(qz[:nzh])
                qsq = ((qxt ** 2)[:, None, None] + (qyt ** 2)[None, :, None]
                       + (qzt ** 2)[None, None, :])
                dot = ((kx * qxt)[:, None, None] + (ky * qyt)[None, :, None]
                       + (kz * qzt)[None, None, :])
                g3 = (f64(gx)[:, None, None] * f64(gy)[None, :, None]
                      * f64(gz[:nzh])[None, None, :])
                num += torch.where(qsq == 0, 0.0,
                                   g3 * dot / torch.where(qsq == 0, 1.0, qsq))
    num = num.cpu().numpy()
    ksq = ((kx1 ** 2)[:, None, None] + (ky1 ** 2)[None, :, None]
           + (kz1[:nzh] ** 2)[None, None, :])
    den = swx[:, None, None] * swy[None, :, None] * swz[None, None, :nzh]
    ksq_safe = np.where(ksq == 0, 1.0, ksq)
    greens = np.where(ksq == 0, 0.0, 4 * math.pi * num / (ksq_safe * den * den))
    if len(_GREENS_CACHE) >= _GREENS_CACHE_MAX:
        _GREENS_CACHE.pop(next(iter(_GREENS_CACHE)))
    _GREENS_CACHE[key] = greens
    return greens


def setup_pppm(*, box, box_lo, accuracy_abs, natoms, q2, cutoff, order=5,
               slabflag=False, slab_volfactor=1.0, g_ewald=None, grid=None,
               device=None) -> PPPMGrid:
    """The mesh for this accuracy; under slab the z grid is scaled to the
    slab-extended domain (the JAX package's documented deviation).  The
    influence function is built on ``device``."""
    g, lgrid, est = set_grid_and_gewald(
        box=box, accuracy_abs=accuracy_abs, natoms=natoms, q2=q2,
        cutoff=cutoff, order=order, slab_volfactor=slab_volfactor,
        g_ewald=g_ewald, grid=grid)
    nx, ny, nz = lgrid
    zprd_grid = box[2] * (slab_volfactor if slabflag else 1.0)
    if slabflag:
        nz = next_factorable(int(round(nz * slab_volfactor)))
    greens = compute_greens(nx, ny, nz, (box[0], box[1], zprd_grid), g, order,
                            device=device)

    def fk(n, L):
        k = np.arange(n)
        return 2 * math.pi * np.where(k <= n // 2, k, k - n) / L

    return PPPMGrid(
        order=order, nx=nx, ny=ny, nz=nz, box=tuple(float(b) for b in box),
        box_lo=tuple(float(b) for b in box_lo), zprd_grid=zprd_grid,
        volume=box[0] * box[1] * zprd_grid, g_ewald=g, slabflag=slabflag,
        greens=greens, fkx=fk(nx, box[0]), fky=fk(ny, box[1]),
        fkz=fk(nz, zprd_grid), coeffs=rho_coeffs(order), lammps_grid=lgrid,
        est_accuracy=est)


# ---------------------------------------------------------------------------
# stencils
# ---------------------------------------------------------------------------

def _dev_greens(grid: PPPMGrid, dtype, device):
    """Half-spectrum influence function on the device."""
    return _devconst(grid, "greens", lambda: grid.greens, dtype, device)


def _coeffs(grid: PPPMGrid, dtype, device):
    return _devconst(grid, "coeffs", lambda: grid.coeffs, dtype, device)


def _horner_w(dx, cf):
    """rho1d[i] = sum_l coeff[i, l] dx^l (LAMMPS compute_rho1d, Horner).
    dx (...,) -> (..., p)."""
    p = cf.shape[0]
    w = torch.zeros(dx.shape + (p,), dtype=dx.dtype, device=dx.device)
    for l in range(p - 1, -1, -1):
        w = w * dx[..., None] + cf[:, l]
    return w


def _horner_dw(dx, cf):
    """d(rho1d)/d(dx) = sum_{l>=1} l coeff[i, l] dx^(l-1) (LAMMPS
    compute_drho1d)."""
    p = cf.shape[0]
    dw = torch.zeros(dx.shape + (p,), dtype=dx.dtype, device=dx.device)
    for l in range(p - 1, 0, -1):
        dw = dw * dx[..., None] + l * cf[:, l]
    return dw


def _stencil_full(grid: PPPMGrid, x):
    """Per-atom stencils: ((ix, iy, iz) (N, p) wrapped indices, (wx, wy, wz)
    (N, p) weights, (dxx, dxy, dxz) (N,) fractional offsets, (cx, cy, cz)
    (N,) wrapped centre nodes, mz_raw (N,) unwrapped z centre nodes).  The
    binning must agree with the JAX package bit for bit in float32: the
    same order of operations, Python floats that never promote."""
    p = grid.order
    dtype = x.dtype
    out_idx, out_w, out_dx, out_c = [], [], [], []
    mz_raw = None
    cf = _coeffs(grid, dtype, x.device)
    offs = torch.arange(p, device=x.device) - (p - 1) // 2
    for ax, (n, L, lo) in enumerate((
            (grid.nx, grid.box[0], grid.box_lo[0]),
            (grid.ny, grid.box[1], grid.box_lo[1]),
            (grid.nz, grid.zprd_grid, grid.box_lo[2]))):
        u = (x[:, ax] - float(lo)) * float(n / L)
        if p % 2 == 1:
            m = torch.floor(u + 0.5).to(torch.int64)
            dx = m.to(dtype) - u                # in [-1/2, 1/2]
        else:
            m = torch.floor(u).to(torch.int64)
            dx = m.to(dtype) + 0.5 - u
        out_idx.append(torch.remainder(m[:, None] + offs[None, :], n))
        out_w.append(_horner_w(dx, cf))
        out_dx.append(dx)
        out_c.append(torch.remainder(m, n))
        if ax == 2:
            mz_raw = m
    return out_idx, out_w, out_dx, out_c, mz_raw


def _stencil(grid: PPPMGrid, x):
    idx, w, _, _, _ = _stencil_full(grid, x)
    return idx, w


# mesh-size bound below which the dense per-axis weight matrices are used
DENSE_XY_LIMIT = 8192


def _use_dense(grid: PPPMGrid, n: int) -> bool:
    """The dense path when the xy mesh is small or N is small."""
    return (grid.nx * grid.ny <= DENSE_XY_LIMIT
            or n * (grid.nx * grid.ny + grid.nz) <= 32 * 1024 * 1024)


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------

def _pick_tile(n: int, lo: int = 8, hi: int = 40, target: int = 16) -> int:
    """Best divisor of n in [lo, hi]: multiples of 8 first, then closeness
    to target, then the larger tile; falls back to n itself."""
    best = None

    def score(t):
        return (0 if t % 8 == 0 else 1, abs(t - target), -t)

    for t in range(lo, min(hi, n) + 1):
        if n % t == 0 and (best is None or score(t) < score(best)):
            best = t
    return best if best is not None else n


TILE_TARGET_XY = 16
TILE_TARGET_Z = 32
# drift margin (mesh cells per axis per side) built into every tile patch: a
# tile assignment stays exact while atoms drift up to TILE_DM cells
TILE_DM = 1


class TileGeom(NamedTuple):
    p: int
    hw: int
    tlx: int
    tly: int
    tlz: int
    ntx: int
    nty: int
    ntz: int      # number of z bins (span mode: occupied z + guards)
    t_tiles: int
    cap: int
    z_span: bool  # z bins cover only the occupied slab span (no z wrap)
    dm: int       # drift margin baked into every patch


def _occupied_nz(grid: PPPMGrid) -> int:
    """z mesh nodes the atoms can touch (slab grids leave the top empty)."""
    return min(grid.nz,
               int(math.ceil(grid.nz * grid.box[2] / grid.zprd_grid)) + 1)


def _tile_geometry(grid: PPPMGrid, natoms: int) -> TileGeom:
    p = grid.order
    if p % 2 == 0:
        raise NotImplementedError(
            "tiled PPPM spread/gather supports odd interpolation orders "
            f"only (got order={p}); use the dense path for even orders")
    hw = (p - 1) // 2
    dm = TILE_DM
    bw = hw + dm                     # patch border width
    hixy = max(40, 2 * TILE_TARGET_XY)
    tlx = _pick_tile(grid.nx, lo=max(8, 2 * bw), hi=hixy,
                     target=TILE_TARGET_XY)
    tly = _pick_tile(grid.ny, lo=max(8, 2 * bw), hi=hixy,
                     target=TILE_TARGET_XY)
    ntx, nty = grid.nx // tlx, grid.ny // tly
    nz_occ = _occupied_nz(grid)
    z_span = nz_occ < grid.nz
    if z_span:
        # guard bin 0 (unwrapped nodes [-tlz, 0)), bins up to the top atom
        # centre, one empty bin above; shrink tlz until the ring maps into
        # [0, nz)
        lo = max(8, 2 * bw, bw + 3)
        tlz = max(lo, min(TILE_TARGET_Z, nz_occ))
        while tlz >= lo:
            ntz = (nz_occ + tlz) // tlz + 2
            if (ntz - 1) * tlz <= grid.nz:
                break
            tlz -= 1
        else:
            z_span, tlz, ntz = False, grid.nz, 1
    else:
        tlz = _pick_tile(grid.nz, lo=max(8, 2 * bw, bw + 3), hi=grid.nz,
                         target=min(TILE_TARGET_Z, grid.nz))
        ntz = grid.nz // tlz
    t_tiles = ntx * nty * ntz
    occ_bins = max(1, nz_occ // tlz) if ntz > 1 else 1
    cap = int(math.ceil(natoms / (ntx * nty * occ_bins)
                        * (1.8 if ntz == 1 else 2.5))) + 32
    if grid.tile_cap is not None:
        cap = int(grid.tile_cap)
    cap = min(cap, natoms + 1)
    return TileGeom(p, hw, tlx, tly, tlz, ntx, nty, ntz, t_tiles, cap,
                    z_span, dm)


@dataclasses.dataclass
class TileSlots:
    """Per-step tile binning of the atoms.  ``rows`` (T, 8, cap) holds per
    slot [lx, ly, lz, dxx, dxy, dxz, q, 0]: the stencil origin's patch
    coordinates (small integers, exact in float), the B-spline fractional
    offsets and the charge; empty slots are all zero.  It is the operand
    of the spread and gather kernels (the JAX package's _pack_slot_rows)."""
    rows: torch.Tensor       # (T, 8, cap)
    table: torch.Tensor      # (T, cap) atom ids (n = empty slot)
    slot: torch.Tensor       # (N,) slot index per atom (tile * cap + rank)
    overflow: torch.Tensor   # () bool


@dataclasses.dataclass
class TileAssign:
    """Persistent atom -> tile-slot assignment, rebuilt with the Verlet
    list: exact while every atom stays within TileGeom.dm mesh cells of
    its binning position; drift beyond that sets the overflow flag."""
    slot: torch.Tensor       # (N,) slot index = tile * cap + rank
    table: torch.Tensor      # (T, cap) atom ids (n = empty slot)
    overflow: torch.Tensor   # () bool: capacity overflow at build time
    x_ref: torch.Tensor      # (N, 3) positions the assignment was built at


def _tile_ids(grid: PPPMGrid, geom: TileGeom, x):
    """Per-atom tile index and the z out-of-ring flag."""
    p, hw, tlx, tly, tlz, ntx, nty, ntz, t_tiles, cap, z_span, dm = geom
    _, _, _, (cx, cy, cz), mz = _stencil_full(grid, x)
    if z_span:
        zt = (mz + tlz) // tlz
        zoob = (zt < 0) | (zt >= ntz - 1) | (mz < hw - tlz)
        zt = torch.clamp(zt, 0, ntz - 1)
    else:
        zt = cz // tlz
        zoob = torch.zeros_like(zt, dtype=torch.bool)
    return ((cx // tlx) * nty + (cy // tly)) * ntz + zt, zoob


def tile_occupancy(grid: PPPMGrid, x) -> int:
    """Max atoms in any mesh tile at positions x."""
    geom = _tile_geometry(grid, x.shape[0])
    tid, _ = _tile_ids(grid, geom, x)
    return int(torch.bincount(tid, minlength=geom.t_tiles).max())


def with_tile_cap(grid: PPPMGrid, x0, *, headroom=1.25) -> PPPMGrid:
    """Bake an occupancy-measured tile slot capacity (1.25x the max at x0,
    rounded to 8) into the grid; ``Engine.run`` grows it on overflow."""
    if _use_dense(grid, len(x0)) or grid.tile_cap is not None:
        return grid
    occ = tile_occupancy(grid, torch.as_tensor(np.asarray(x0),
                                               dtype=torch.float64))
    cap = int(math.ceil(max(occ, 8) * headroom / 8.0) * 8)
    return dataclasses.replace(grid, tile_cap=min(cap, len(x0) + 1))


def with_shared_cache(grid: PPPMGrid, **changes) -> PPPMGrid:
    """``dataclasses.replace(grid, **changes)`` that shares ``grid``'s
    device constants (the influence function is not copied); the keys
    that depend on the tile geometry carry it."""
    out = dataclasses.replace(grid, **changes)
    object.__setattr__(out, "_dev", grid._dev)
    return out


def tile_assign(grid: PPPMGrid, x) -> TileAssign:
    """Bin atoms by 3-D mesh tile: one sort of packed (tile << shift | i)
    keys, the rank in each tile by cummax of the segment starts, two
    scatters."""
    n = x.shape[0]
    dev = x.device
    geom = _tile_geometry(grid, n)
    cap = geom.cap
    tid, zoob = _tile_ids(grid, geom, x)
    shift = max(1, int(n - 1).bit_length()) if n > 1 else 1
    iota = torch.arange(n, device=dev)
    key = torch.sort((tid << shift) | iota).values
    ts = key >> shift
    order = key & ((1 << shift) - 1)
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    changed[1:] = ts[1:] != ts[:-1]
    rank = iota - torch.cummax(torch.where(changed, iota, 0), dim=0).values
    overflow = (torch.max(rank) >= cap) | torch.any(zoob)
    slot_sorted = ts * cap + torch.clamp(rank, max=cap - 1)
    table = torch.full((geom.t_tiles * cap,), n, dtype=torch.int64,
                       device=dev)
    table[slot_sorted] = order
    slot = torch.empty(n, dtype=torch.int64, device=dev)
    slot[order] = slot_sorted
    return TileAssign(slot, table.reshape(geom.t_tiles, cap), overflow, x)


def tile_drift_exceeded(grid: PPPMGrid, asg: TileAssign, x):
    """() bool: whether any atom moved more than 90% of the TILE_DM-cell
    patch margin on an axis since ``asg`` was built (JAX pppm.py:664): the
    rebuild trigger of the persistent assignment where no Verlet skin
    bounds the drift (the tile pair path).  The 10% absorbs one step's
    motion between the check and the rebuild; a margin still exceeded
    sets the slots' overflow flag."""
    geom = _tile_geometry(grid, x.shape[0])
    cells = (grid.box[0] / grid.nx, grid.box[1] / grid.ny,
             grid.zprd_grid / grid.nz)
    d = torch.abs(x - asg.x_ref)
    out = d[:, 0] > 0.9 * geom.dm * cells[0]
    for ax in (1, 2):
        out = out | (d[:, ax] > 0.9 * geom.dm * cells[ax])
    return torch.any(out)


def refresh_tile_slots(grid: PPPMGrid, asg: TileAssign, x, q) -> TileSlots:
    """TileSlots for the current (x, q) under a (possibly stale)
    assignment: local coordinates are taken relative to each atom's
    assigned tile (wrap-aware), so a drifted atom lands in the patch
    margin; drift beyond it sets the overflow flag."""
    n = x.shape[0]
    dtype = x.dtype
    geom = _tile_geometry(grid, n)
    p, hw, tlx, tly, tlz, ntx, nty, ntz, t_tiles, cap, z_span, dm = geom
    _, _, (dxx, dxy, dxz), (cx, cy, cz), mz = _stencil_full(grid, x)
    tid = asg.slot // cap
    txi = tid // (nty * ntz)
    tyi = (tid // ntz) % nty
    tzi = tid % ntz

    def rel(c, t0, tl, nt, nper):
        d = torch.remainder(c - t0, nper)
        if nt > 1:
            d = torch.where(d >= tl + dm, d - nper, d)
        return d

    lx = rel(cx, txi * tlx, tlx, ntx, grid.nx) + dm
    ly = rel(cy, tyi * tly, tly, nty, grid.ny) + dm
    if z_span:
        lz = mz - (tzi - 1) * tlz + dm
    else:
        lz = rel(cz, tzi * tlz, tlz, ntz, grid.nz) + dm

    def oob(o, tl):
        return (o < 0) | (o > tl + 2 * dm - 1)

    overflow = asg.overflow | torch.any(oob(lx, tlx) | oob(ly, tly)
                                        | oob(lz, tlz))
    # the slot rows stay inside their patch even past the margin (or at
    # NaN positions after an overflow elsewhere): K2a and K3 index the
    # patch with them, and the flag already poisons what they compute
    lx = torch.clamp(lx, 0, tlx + 2 * dm - 1)
    ly = torch.clamp(ly, 0, tly + 2 * dm - 1)
    lz = torch.clamp(lz, 0, tlz + 2 * dm - 1)
    packed = torch.stack([lx.to(dtype), ly.to(dtype), lz.to(dtype), dxx, dxy,
                          dxz, q.to(dtype), torch.zeros_like(dxx)], dim=0)
    packed = torch.cat([packed, torch.zeros((8, 1), dtype=dtype,
                                            device=x.device)], dim=1)
    rows = packed[:, asg.table.reshape(-1)].reshape(8, t_tiles, cap)
    return TileSlots(rows.transpose(0, 1).contiguous(), asg.table, asg.slot,
                     overflow)


def tile_slots(grid: PPPMGrid, x, q) -> TileSlots:
    """One-shot binning: tile_assign + refresh_tile_slots."""
    return refresh_tile_slots(grid, tile_assign(grid, x), x, q)


def _axis_onehot(ls, ws, *, e):
    """(..., cap, e) weights: stencil point a of a slot with origin patch
    coordinate l sits at l + a."""
    io = torch.arange(e, device=ls.device)
    out = torch.zeros(ls.shape + (e,), dtype=ws.dtype, device=ws.device)
    for a in range(ws.shape[-1]):
        out = out + ws[..., a, None] * (io == (ls + a)[..., None])
    return out


def _merge_axis(pt, bin_ax: int, ext_ax: int, til: int, hw: int,
                periodic: bool):
    """Overlap-add one tiled axis: the hw-wide borders on ``ext_ax`` shift
    into the neighbouring bin on ``bin_ax`` (roll if periodic, zero-fill
    shift otherwise); returns ext_ax reduced to length til."""
    core = pt.narrow(ext_ax, hw, til)
    lb = pt.narrow(ext_ax, 0, hw)
    rb = pt.narrow(ext_ax, hw + til, hw)
    if periodic:
        rbs = torch.roll(rb, 1, dims=bin_ax)
        lbs = torch.roll(lb, -1, dims=bin_ax)
    else:
        nt = pt.shape[bin_ax]
        rbs = torch.cat([torch.zeros_like(rb.narrow(bin_ax, 0, 1)),
                         rb.narrow(bin_ax, 0, nt - 1)], dim=bin_ax)
        lbs = torch.cat([lb.narrow(bin_ax, 1, nt - 1),
                         torch.zeros_like(lb.narrow(bin_ax, 0, 1))],
                        dim=bin_ax)
    return torch.cat([core.narrow(ext_ax, 0, hw) + rbs,
                      core.narrow(ext_ax, hw, til - 2 * hw),
                      core.narrow(ext_ax, til - hw, hw) + lbs], dim=ext_ax)


def _patch_dims(geom: TileGeom):
    bw = geom.hw + geom.dm
    return bw, geom.tlx + 2 * bw, geom.tly + 2 * bw, geom.tlz + 2 * bw


def _overlap_add(patches, geom: TileGeom, nz: int):
    """(T, ex*ey, ez) per-tile patches -> the (nx, ny, nz) mesh, one tiled
    axis at a time.  x and y are periodic; in span mode the z bin axis is
    not, and the extended z ring (bin 0 starts at unwrapped node -tlz) maps
    into [0, nz): ring nodes [tlz, ntz*tlz) onto [0, (ntz-1)*tlz), the
    guard bin [0, tlz) onto [nz - tlz, nz)."""
    bw, ex, ey, ez = _patch_dims(geom)
    ntx, nty, ntz = geom.ntx, geom.nty, geom.ntz
    tlx, tly, tlz = geom.tlx, geom.tly, geom.tlz
    pt = patches.reshape(ntx, nty, ntz, ex, ey, ez)
    pt = _merge_axis(pt, 2, 5, tlz, bw, periodic=not geom.z_span)
    pt = _merge_axis(pt, 1, 4, tly, bw, periodic=True)
    pt = _merge_axis(pt, 0, 3, tlx, bw, periodic=True)
    brick = pt.permute(0, 3, 1, 4, 2, 5).reshape(ntx * tlx, nty * tly,
                                                 ntz * tlz)
    if not geom.z_span:
        return brick
    pad = torch.nn.functional.pad
    main = pad(brick[:, :, tlz:], (0, nz - (ntz - 1) * tlz))
    low = pad(brick[:, :, :tlz], (nz - tlz, 0))
    return main + low


def _pad_brick(b, geom: TileGeom, nz: int):
    """Wrap-pad a (nx, ny, nz) mesh for the tiled readout: bw on x and y; in
    span mode bin tz's patch starts at unwrapped node (tz-1)*tlz - bw, i.e.
    padded index tz*tlz with a (tlz + bw) low wrap pad, the high pad
    covering the top guard bins; otherwise bw on z too."""
    bw, _, _, ez = _patch_dims(geom)
    if geom.z_span:
        zpad = (geom.tlz + bw,
                max(0, (geom.ntz - 1) * geom.tlz + ez - (nz + geom.tlz + bw)))
    else:
        zpad = (bw, bw)
    for ax, (lo, hi) in enumerate(((bw, bw), (bw, bw), zpad)):
        n = b.shape[ax]
        idx = torch.remainder(torch.arange(-lo, n + hi, device=b.device), n)
        b = torch.index_select(b, ax, idx)
    return b


# ---------------------------------------------------------------------------
# z-binned path
# ---------------------------------------------------------------------------

_ZBIN_DFT_CACHE = {}


def _zbin_dft(grid: PPPMGrid, geom: TileGeom):
    """(ntz*ez, nzh) shifted half-spectrum z-DFT matrices (float64) for the
    z-binned mesh: row (zt, e) carries the phases of the unwrapped global
    node the patch row lands on under the overlap-add, so the z-DFT of the
    binned mesh equals the DFT of the merged mesh by linearity."""
    bw, _, _, ez = _patch_dims(geom)
    key = (grid.nz, geom.ntz, geom.tlz, ez, geom.z_span)
    if key not in _ZBIN_DFT_CACHE:
        nz = grid.nz
        nzh = nz // 2 + 1
        zt = np.arange(geom.ntz, dtype=np.int64)[:, None]
        e = np.arange(ez, dtype=np.int64)[None, :]
        g = (zt - (1 if geom.z_span else 0)) * geom.tlz - bw + e
        k = np.arange(nzh, dtype=np.int64)
        ang = 2.0 * np.pi * ((g.reshape(-1, 1) * k[None, :]) % nz) / nz
        _ZBIN_DFT_CACHE[key] = (np.cos(ang), np.sin(ang))
    return _ZBIN_DFT_CACHE[key]


_ZBIN_IDFT_CACHE = {}


def _zbin_idft(grid: PPPMGrid, geom: TileGeom):
    """(nzh, ntz*ez) inverse half-spectrum z-DFT matrices onto the z-binned
    rows, with the Hermitian doubling weights and 1/nz folded in."""
    _, _, _, ez = _patch_dims(geom)
    key = (grid.nz, geom.ntz, geom.tlz, ez, geom.z_span)
    if key not in _ZBIN_IDFT_CACHE:
        C, S = _zbin_dft(grid, geom)
        nz = grid.nz
        w = np.full(nz // 2 + 1, 2.0)
        w[0] = 1.0
        if nz % 2 == 0:
            w[-1] = 1.0
        _ZBIN_IDFT_CACHE[key] = ((C * w / nz).T, (S * w / nz).T)
    return _ZBIN_IDFT_CACHE[key]


def _nan_where(flag, t):
    return torch.where(flag, torch.full_like(t, float("nan")), t)


def spread_rhok(grid: PPPMGrid, x, q=None, slots: TileSlots = None):
    """Half-spectrum density rhok = rfft3(spread(...)): the dense path on
    small meshes, the z-binned tiled path otherwise."""
    if _use_dense(grid, x.shape[0]):
        return rfft3(grid, spread(grid, x, q))
    return _spread_rhok_tiled(grid, x, q, slots)


def _spread_rhok_tiled(grid: PPPMGrid, x, q=None, slots: TileSlots = None):
    """rhok from the slot rows: K2a spreads straight into the z-binned mesh
    (nx, ny, ntz, ez), a shifted z-DFT matmul contracts its rows, an xy FFT
    finishes.  NaN on tile overflow."""
    if slots is None:
        slots = tile_slots(grid, x, q)
    geom = _tile_geometry(grid, x.shape[0])
    dtype, dev = x.dtype, x.device
    m = pppm_spread.spread_mesh(slots.rows, _coeffs(grid, dtype, dev), geom)
    m = m.reshape(grid.nx, grid.ny, -1)
    C = _devconst(grid, ("zbin_C", tuple(geom)),
                  lambda: _zbin_dft(grid, geom)[0], dtype, dev)
    S = _devconst(grid, ("zbin_S", tuple(geom)),
                  lambda: _zbin_dft(grid, geom)[1], dtype, dev)
    rhok = torch.fft.fftn(torch.complex(m @ C, -(m @ S)), dim=(0, 1))
    return _nan_where(slots.overflow, rhok)


def _half_weights(grid: PPPMGrid, dtype, device):
    """Spectrum-doubling weights of the z half spectrum (kz = 0 and the
    even-nz Nyquist plane appear once)."""
    def make():
        w = np.full(grid.nz // 2 + 1, 2.0)
        w[0] = 1.0
        if grid.nz % 2 == 0:
            w[-1] = 1.0
        return w

    return _devconst(grid, "half_weights", make, dtype, device)


def _real_dtype(rhok):
    return torch.float32 if rhok.dtype == torch.complex64 else torch.float64


def pppm_energy_u_zbin(grid: PPPMGrid, rhok, natoms: int):
    """(energy, u (nx, ny, ntz, ez)): the inverse z transform lands directly
    on the z-binned rows the tiled gather reads; the dense potential mesh is
    never built."""
    rdt, dev = _real_dtype(rhok), rhok.device
    geom = _tile_geometry(grid, natoms)
    gk = _dev_greens(grid, rdt, dev)
    e = 0.5 * torch.sum(_half_weights(grid, rdt, dev) * gk
                        * torch.abs(rhok) ** 2) / grid.volume
    v = torch.fft.ifftn(rhok * gk, dim=(0, 1))
    iC = _devconst(grid, ("zbin_iC", tuple(geom)),
                   lambda: _zbin_idft(grid, geom)[0], rdt, dev)
    iS = _devconst(grid, ("zbin_iS", tuple(geom)),
                   lambda: _zbin_idft(grid, geom)[1], rdt, dev)
    u = (v.real @ iC - v.imag @ iS) * (grid.nx * grid.ny * grid.nz
                                       / grid.volume)
    return e, u.reshape(grid.nx, grid.ny, geom.ntz, -1)


def _zbin_patches(up, geom: TileGeom):
    """(T, ez, ex*ey) patch blocks from the xy-wrap-padded z-binned mesh
    ``up`` (nx+2bw, ny+2bw, ntz, ez): overlapping x/y windows."""
    _, ex, ey, ez = _patch_dims(geom)
    xw = torch.stack([up[i * geom.tlx:i * geom.tlx + ex]
                      for i in range(geom.ntx)])
    yw = torch.stack([xw[:, :, k * geom.tly:k * geom.tly + ey]
                      for k in range(geom.nty)], dim=1)
    return yw.permute(0, 1, 4, 5, 2, 3).reshape(geom.t_tiles, ez, ex * ey)


def _delinv(grid: PPPMGrid):
    return (grid.nx / grid.box[0], grid.ny / grid.box[1],
            grid.nz / grid.zprd_grid)


def _dev_delinv(grid: PPPMGrid, dtype, device):
    """``_delinv`` as a (3,) device constant: a host-built tensor on the
    step path would be a pageable copy, which a CUDA graph cannot hold."""
    return _devconst(grid, "delinv", lambda: _delinv(grid), dtype, device)


def _wrap_pad_xy(u, bw):
    """Periodic pad of the first two axes by bw."""
    u = torch.cat([u[-bw:], u, u[:bw]], dim=0)
    return torch.cat([u[:, -bw:], u, u[:, :bw]], dim=1)


def gather3_ad_zbin(grid: PPPMGrid, uz, x, slots: TileSlots = None):
    """E = -grad(phi) at the atoms (ad differentiation of the B-spline
    interpolant) from the z-binned potential rows: K3 per slot, then the
    slot -> atom gather and the delinv scale.  NaN on tile overflow."""
    n = x.shape[0]
    if slots is None:
        slots = tile_slots(grid, x, torch.zeros((n,), dtype=x.dtype,
                                                device=x.device))
    geom = _tile_geometry(grid, n)
    bw = geom.hw + geom.dm
    up = _wrap_pad_xy(uz.to(x.dtype), bw).contiguous()
    vals = pppm_gather.gather3(up, slots.rows,
                               _coeffs(grid, x.dtype, x.device), geom)
    e = vals[slots.slot] * _dev_delinv(grid, x.dtype, x.device)
    return _nan_where(slots.overflow, e)


# ---------------------------------------------------------------------------
# real-mesh tiled path
# ---------------------------------------------------------------------------

def spread_tiled(grid: PPPMGrid, x, q=None, slots: TileSlots = None):
    """Charges onto the (nx, ny, nz) mesh for large meshes: per-tile patches
    from the slot rows (K2b), then the x/y/z overlap-add.  NaN on tile
    overflow.  ``slots``: built with the same x and q (else binned here)."""
    if slots is None:
        slots = tile_slots(grid, x, q)
    geom = _tile_geometry(grid, x.shape[0])
    patches = pppm_spread.spread_tiles(slots.rows,
                                       _coeffs(grid, x.dtype, x.device), geom)
    return _nan_where(slots.overflow, _overlap_add(patches, geom, grid.nz))


# atoms per chunk of the tiled readout: bounds the (fields, chunk, 125)
# stencil transient
GATHER_CHUNK = 16384


def _tiled_stencil_chunks(grid: PPPMGrid, geom: TileGeom, slots: TileSlots,
                          n: int, ys: int, zs: int, cf, deriv: bool):
    """Per chunk of ``GATHER_CHUNK`` atoms: (i0, flat node ids (c p^3,) in
    the padded brick of row strides ``ys``/``zs``, the three (c, p) axis
    weights, and with ``deriv`` their three derivative weights) at each
    atom's tile window, from its slot row; a node outside the patch has
    no weight (one-hot semantics)."""
    bw, ex, ey, ez = _patch_dims(geom)
    p, cap = geom.p, geom.cap
    a = torch.arange(p, device=slots.rows.device)
    for i0 in range(0, n, GATHER_CHUNK):
        slot = slots.slot[i0:i0 + GATHER_CHUNK]
        t = slot // cap
        r = slots.rows[t, :, slot % cap]                 # (c, 8)
        origin = ((t // (geom.nty * geom.ntz)) * geom.tlx,
                  ((t // geom.ntz) % geom.nty) * geom.tly,
                  (t % geom.ntz) * geom.tlz)
        idx, w, dw = [], [], []
        for ax, e in enumerate((ex, ey, ez)):
            loc = r[:, ax].to(torch.int64)[:, None] + a[None, :]  # (c, p)
            inside = (loc >= 0) & (loc < e)
            wa = _horner_w(r[:, 3 + ax], cf)
            w.append(torch.where(inside, wa, torch.zeros_like(wa)))
            if deriv:
                da = _horner_dw(r[:, 3 + ax], cf)
                dw.append(torch.where(inside, da, torch.zeros_like(da)))
            idx.append(origin[ax][:, None] + loc.clamp(0, e - 1))
        node = ((idx[0][:, :, None, None] * ys + idx[1][:, None, :, None])
                * zs + idx[2][:, None, None, :]).reshape(-1)
        yield i0, node, w, dw


def _padded_bricks(grid: PPPMGrid, geom: TileGeom, bricks, dtype):
    """(nb, X Y Z) flat wrap-padded bricks and their strides (Y, Z)."""
    bp = torch.stack([_pad_brick(b.to(dtype), geom, grid.nz)
                      for b in bricks])                  # (nb, X, Y, Z)
    nb, _, ys, zs = bp.shape
    return bp.reshape(nb, -1), ys, zs


def gather_tiled(grid: PPPMGrid, bricks, x, slots: TileSlots = None):
    """Stencil readout of one or more (nx, ny, nz) meshes at the atoms
    through their tile slots: each atom's p^3 nodes are read from its
    tile's window of the wrap-padded mesh at the slot's local stencil
    origin and weighted by the B-spline weights of its slot row.  Returns a
    list of (N,) values, NaN on tile overflow.  ``slots``: built with the
    same x (charges are not read), else binned here."""
    n = x.shape[0]
    dtype, dev = x.dtype, x.device
    if slots is None:
        slots = tile_slots(grid, x, torch.zeros((n,), dtype=dtype,
                                                device=dev))
    geom = _tile_geometry(grid, n)
    p = geom.p
    flat, ys, zs = _padded_bricks(grid, geom, bricks, dtype)
    nb = flat.shape[0]
    outs = []
    for _, node, w, _ in _tiled_stencil_chunks(
            grid, geom, slots, n, ys, zs, _coeffs(grid, dtype, dev), False):
        vals = flat[:, node].reshape(nb, -1, p, p, p)
        outs.append(torch.einsum("bcxyz,cx,cy,cz->bc", vals, *w))
    out = _nan_where(slots.overflow, torch.cat(outs, dim=1))
    return list(out)


def gather3_ad_tiled(grid: PPPMGrid, u, x, slots: TileSlots = None):
    """E = -grad(phi) at the atoms by differentiating the B-spline
    interpolant of ONE potential mesh (the ad scheme, JAX
    ``gather3_ad_tiled``) through the atoms' tile windows, as
    ``gather_tiled`` reads them: E_x = delinv_x sum w'(dxx) w(dxy) w(dxz)
    u over the p^3 nodes, likewise y and z.  Returns (N, 3), NaN on tile
    overflow."""
    n = x.shape[0]
    dtype, dev = x.dtype, x.device
    if slots is None:
        slots = tile_slots(grid, x, torch.zeros((n,), dtype=dtype,
                                                device=dev))
    geom = _tile_geometry(grid, n)
    p = geom.p
    flat, ys, zs = _padded_bricks(grid, geom, [u], dtype)
    outs = []
    for _, node, (wx, wy, wz), (dwx, dwy, dwz) in _tiled_stencil_chunks(
            grid, geom, slots, n, ys, zs, _coeffs(grid, dtype, dev), True):
        vals = flat[0, node].reshape(-1, p, p, p)
        outs.append(torch.stack([
            torch.einsum("cxyz,cx,cy,cz->c", vals, dwx, wy, wz),
            torch.einsum("cxyz,cx,cy,cz->c", vals, wx, dwy, wz),
            torch.einsum("cxyz,cx,cy,cz->c", vals, wx, wy, dwz)], dim=1))
    e = torch.cat(outs, dim=0) * _dev_delinv(grid, dtype, dev)
    return _nan_where(slots.overflow, e)


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------


def _weight_matrix(m, i, w):
    """(N, m) rows of stencil weights: w (N, p) added at columns i (N, p).
    A row's p columns wrap onto m mesh nodes, so they are distinct when m
    >= p and one scatter adds each once; on a coarser mesh the columns are
    added one at a time, in stencil order (a scatter onto a repeated column
    would add in an order that changes from run to run on the card)."""
    out = torch.zeros((i.shape[0], m), dtype=w.dtype, device=w.device)
    if m >= i.shape[1]:
        return out.scatter_add_(1, i, w)
    for s in range(i.shape[1]):
        out.scatter_add_(1, i[:, s:s + 1], w[:, s:s + 1])
    return out


def _axis_weight_matrices(grid: PPPMGrid, x):
    """Dense per-axis B-spline weight matrices Wx (N,nx), Wy (N,ny),
    Wz (N,nz); each row has ``order`` nonzeros."""
    (ix, iy, iz), (wx, wy, wz) = _stencil(grid, x)
    return (_weight_matrix(grid.nx, ix, wx), _weight_matrix(grid.ny, iy, wy),
            _weight_matrix(grid.nz, iz, wz))


def _wxy(WX, WY):
    return (WX[:, :, None] * WY[:, None, :]).reshape(WX.shape[0], -1)


def spread(grid: PPPMGrid, x, q, slots: TileSlots = None):
    """Charges onto the mesh (LAMMPS make_rho): (nx, ny, nz); the tiled
    path above the dense bound."""
    if not _use_dense(grid, x.shape[0]):
        return spread_tiled(grid, x, q, slots=slots)
    WX, WY, WZ = _axis_weight_matrices(grid, x)
    rho = _wxy(WX, WY).T @ (q[:, None] * WZ)
    return rho.reshape(grid.nx, grid.ny, grid.nz)


def gather(grid: PPPMGrid, brick, x, slots: TileSlots = None):
    """Stencil readout of a mesh field at atom positions: (N,)."""
    if not _use_dense(grid, x.shape[0]):
        return gather_tiled(grid, [brick], x, slots=slots)[0]
    WX, WY, WZ = _axis_weight_matrices(grid, x)
    t = WZ @ brick.reshape(grid.nx * grid.ny, grid.nz).T
    return torch.sum(_wxy(WX, WY) * t, dim=1)


def gather3(grid: PPPMGrid, bricks, x, slots: TileSlots = None):
    """Three mesh fields at once (the ik force path): (N, 3)."""
    if not _use_dense(grid, x.shape[0]):
        return torch.stack(gather_tiled(grid, list(bricks), x, slots=slots),
                           dim=1)
    WX, WY, WZ = _axis_weight_matrices(grid, x)
    wxy = _wxy(WX, WY)
    return torch.stack([torch.sum(
        wxy * (WZ @ b.reshape(grid.nx * grid.ny, grid.nz).T), dim=1)
        for b in bricks], dim=1)


def gather3_ad(grid: PPPMGrid, u, x):
    """E = -grad(phi) at the atoms from one potential mesh (ad scheme;
    exactly -d/dx of the discrete mesh energy): (N, 3); through the tile
    windows (``gather3_ad_tiled``) above the dense bound.  The engines read
    ad forces through the z-binned ``gather3_ad_zbin`` on a tiled mesh."""
    if not _use_dense(grid, x.shape[0]):
        return gather3_ad_tiled(grid, u, x)
    (ix, iy, iz), (wx, wy, wz), (dxx, dxy, dxz), _, _ = _stencil_full(grid, x)
    cf = _coeffs(grid, x.dtype, x.device)
    mk = _weight_matrix
    WX, WY, WZ = mk(grid.nx, ix, wx), mk(grid.ny, iy, wy), mk(grid.nz, iz, wz)
    DWX = mk(grid.nx, ix, _horner_dw(dxx, cf))
    DWY = mk(grid.ny, iy, _horner_dw(dxy, cf))
    DWZ = mk(grid.nz, iz, _horner_dw(dxz, cf))
    bf = u.reshape(grid.nx * grid.ny, grid.nz).T
    t, tz = WZ @ bf, DWZ @ bf
    gx = torch.sum(_wxy(DWX, WY) * t, dim=1)
    gy = torch.sum(_wxy(WX, DWY) * t, dim=1)
    gz = torch.sum(_wxy(WX, WY) * tz, dim=1)
    return torch.stack([gx, gy, gz], dim=1) * _dev_delinv(grid, x.dtype,
                                                          x.device)


def rfft3(grid: PPPMGrid, rho):
    """Half-spectrum 3-D transform of a real mesh (== numpy rfftn)."""
    return torch.fft.rfftn(rho)


def irfft3(grid: PPPMGrid, vk):
    """Real inverse of rfft3."""
    return torch.fft.irfftn(vk, s=grid.shape)


def poisson_u_from_k(grid: PPPMGrid, rhok):
    """Potential mesh from the half-spectrum density."""
    gk = _dev_greens(grid, _real_dtype(rhok), rhok.device)
    return irfft3(grid, rhok * gk) * (grid.nx * grid.ny * grid.nz
                                      / grid.volume)


def poisson_u(grid: PPPMGrid, rho):
    """Potential mesh u = IRFFT(G * RFFT(rho)) / V of a real density mesh."""
    return poisson_u_from_k(grid, rfft3(grid, rho))


def pppm_energy_u_from_k(grid: PPPMGrid, rhok):
    """(energy, u mesh) from the half-spectrum density: one inverse FFT."""
    rdt, dev = _real_dtype(rhok), rhok.device
    gk = _dev_greens(grid, rdt, dev)
    e = 0.5 * torch.sum(_half_weights(grid, rdt, dev) * gk
                        * torch.abs(rhok) ** 2) / grid.volume
    return e, poisson_u_from_k(grid, rhok)


def _deriv_fk(grid: PPPMGrid):
    """Per-axis ik wavenumbers under the z half spectrum, with the x/y
    Nyquist modes zeroed (-ik phik is not Hermitian there)."""
    fkx = np.array(grid.fkx, copy=True)
    fky = np.array(grid.fky, copy=True)
    if grid.nx % 2 == 0:
        fkx[grid.nx // 2] = 0.0
    if grid.ny % 2 == 0:
        fky[grid.ny // 2] = 0.0
    return fkx, fky, np.asarray(grid.fkz[:grid.nz // 2 + 1])


def pppm_energy_efield_from_k(grid: PPPMGrid, rhok):
    """(energy, (ex, ey, ez) meshes) from the half-spectrum density (the ik
    branch): one inverse FFT per field component."""
    rdt, dev = _real_dtype(rhok), rhok.device
    gk = _dev_greens(grid, rdt, dev)
    e = 0.5 * torch.sum(_half_weights(grid, rdt, dev) * gk
                        * torch.abs(rhok) ** 2) / grid.volume
    phik = rhok * gk
    scale = grid.nx * grid.ny * grid.nz / grid.volume
    out = []
    for ax, fkv in enumerate(_deriv_fk(grid)):
        shape = [1, 1, 1]
        shape[ax] = -1
        ik = 1j * _devconst(grid, ("deriv_fk", ax), lambda: fkv, rdt,
                            dev).reshape(shape)
        out.append(irfft3(grid, -ik * phik) * scale)
    return e, tuple(out)


# ---------------------------------------------------------------------------
# electrode z-plane path
# ---------------------------------------------------------------------------

def electrode_zplanes(grid: PPPMGrid, xe) -> np.ndarray:
    """Sorted unique (wrapped) z mesh nodes the electrode stencils touch,
    padded by one guard node each side.  Host-side, from the set-up
    positions (electrodes are frozen)."""
    xe = np.asarray(xe)
    p = grid.order
    u = (xe[:, 2] - grid.box_lo[2]) * (grid.nz / grid.zprd_grid)
    m = np.floor(u + 0.5 if p % 2 == 1 else u).astype(np.int64)
    offs = np.arange(-(p - 1) // 2 - 1, p - (p - 1) // 2 + 1)  # +-1 guard
    return np.unique((m[:, None] + offs[None, :]) % grid.nz).astype(np.int32)


def zplane_inverse(grid: PPPMGrid, zp: np.ndarray) -> np.ndarray:
    """(nz,) int32 map from z node to plane slot, -1 outside the set."""
    inv = np.full(grid.nz, -1, np.int32)
    inv[zp] = np.arange(len(zp), dtype=np.int32)
    return inv


def _zplane_wz(grid: PPPMGrid, x, zp_inv):
    """(N, P) z weights restricted to the plane set, and the fail-loud
    flag: a stencil node outside the set would silently lose charge."""
    p = grid.order
    n = grid.nz
    dtype = x.dtype
    u = (x[:, 2] - float(grid.box_lo[2])) * float(n / grid.zprd_grid)
    if p % 2 == 1:
        m = torch.floor(u + 0.5).to(torch.int64)
        dx = m.to(dtype) - u
    else:
        m = torch.floor(u).to(torch.int64)
        dx = m.to(dtype) + 0.5 - u
    offs = torch.arange(p, device=x.device) - (p - 1) // 2
    iz = torch.remainder(m[:, None] + offs[None, :], n)
    zpi = _devconst(grid, ("zp_slot", np.asarray(zp_inv).tobytes()),
                    lambda: zp_inv, torch.int64, x.device)
    slot = zpi[iz]                                   # (N, p)
    w = _horner_w(dx, _coeffs(grid, dtype, x.device))
    nplanes = int((np.asarray(zp_inv) >= 0).sum())
    WZ = torch.zeros((x.shape[0], nplanes), dtype=dtype, device=x.device)
    WZ.scatter_add_(1, torch.clamp(slot, min=0), w)
    return WZ, torch.any(slot < 0)


def _xy_weights(grid: PPPMGrid, x):
    (ix, iy, _), (wx, wy, _) = _stencil(grid, x)
    return _wxy(_weight_matrix(grid.nx, ix, wx),
                _weight_matrix(grid.ny, iy, wy))


def spread_zplanes(grid: PPPMGrid, x, q, zp_inv):
    """Spread charges that live on the z-plane set: (nx, ny, P).  NaN if any
    stencil node falls outside the set."""
    WZ, bad = _zplane_wz(grid, x, zp_inv)
    rho = (_xy_weights(grid, x).T @ (q[:, None] * WZ)).reshape(
        grid.nx, grid.ny, -1)
    return _nan_where(bad, rho)


def rhok_from_zplanes(grid: PPPMGrid, rho_planes, zp):
    """Forward half-spectrum transform of a z-sparse density:
    FFT2_xy(planes) @ exp(-2 pi i kz zp / nz)."""
    v = torch.fft.fftn(rho_planes, dim=(0, 1))          # (nx, ny, P)
    cdt = v.dtype
    ez = _devconst(
        grid, ("zp_fwd", np.asarray(zp).tobytes()),
        lambda: np.exp(-2j * math.pi * np.outer(np.asarray(zp),
                                                np.arange(grid.nz // 2 + 1))
                       / grid.nz), cdt, v.device)
    return (v.reshape(grid.nx * grid.ny, -1) @ ez).reshape(
        grid.nx, grid.ny, -1)


def u_on_zplanes(grid: PPPMGrid, rhok, zp):
    """u[:, :, zp] of the potential mesh from the half-spectrum density,
    without the full inverse FFT: per (x, y) the z signal is real, so
    u(z) = 2 Re[sum_kz c_kz phik e^{+2 pi i kz z/nz}]/nz (c = 1/2 at kz = 0
    and the even-nz Nyquist plane)."""
    nzh = grid.nz // 2 + 1
    phik = rhok * _dev_greens(grid, _real_dtype(rhok), rhok.device)

    def make():
        c = np.ones(nzh)
        c[0] = 0.5
        if grid.nz % 2 == 0:
            c[-1] = 0.5
        return (c[:, None] * np.exp(2j * math.pi * np.outer(
            np.arange(nzh), np.asarray(zp)) / grid.nz) / grid.nz)

    ez = _devconst(grid, ("zp_inv", np.asarray(zp).tobytes()), make,
                   phik.dtype, phik.device)
    a = (phik.reshape(grid.nx * grid.ny, nzh) @ ez).reshape(
        grid.nx, grid.ny, -1)
    u = 2.0 * torch.fft.ifftn(a, dim=(0, 1)).real
    return u * (grid.nx * grid.ny * grid.nz / grid.volume)


def gather_zplanes(grid: PPPMGrid, u_planes, x, zp_inv):
    """Stencil readout of a z-plane-restricted mesh (NaN if a stencil node
    leaves the plane set)."""
    WZ, bad = _zplane_wz(grid, x, zp_inv)
    t = WZ @ u_planes.reshape(grid.nx * grid.ny, WZ.shape[1]).T
    return _nan_where(bad, torch.sum(_xy_weights(grid, x) * t, dim=1))
