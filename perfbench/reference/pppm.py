"""PPPM's mesh in plain PyTorch, from LAMMPS ``pppm.cpp``'s equations, at
order 5: the charges assigned to the mesh with B-spline weights, the
mesh's Poisson equation solved in k-space with the optimal influence
function, and the field read back at the atoms by ik differentiation
(three field meshes, ``compute_gf_ik``) or by ad (the gradient of the
interpolated potential, ``compute_gf_ad``, less the self-force that
``compute_sf_precoeff`` and ``fieldforce_ad`` subtract).

Nothing here imports the program.  The weights are the centred cardinal
B-spline evaluated by its recursion (LAMMPS tabulates the same
polynomials in ``compute_rho_coeff``); the transforms are full complex
FFTs whose real part is kept, as LAMMPS keeps it.  Where LAMMPS truncates
the influence function's aliasing sum at its ``EPS_HOC`` bound, this sum
runs ``EXTRA_IMAGES`` images further; its denominator is LAMMPS's closed
form (``gf_denom``), the whole sum.  The derivative and the self-force's
phases use the mesh's own spacing (the slab-extended one along z) from
the box's lower corner.

``Mesh(box, box_lo, g_ewald, dims, diff, device, dtype)``: ``dims`` the
mesh over the (slab-extended) box, ``diff`` "ik" or "ad".  With ``tf32``
the operands of the mesh's products (charge x weight in the assignment,
influence function x density in k-space, weight x mesh value in the
read-back) are rounded to TF32's 10 mantissa bits: the control.
"""

from __future__ import annotations

import math

import torch

ORDER = 5
EPS_HOC = 1e-7
# images of the influence function's numerator past LAMMPS's bound: a
# further image changes no value of G by 1e-13 of the largest (tests)
EXTRA_IMAGES = 2
# images of W in the self-force's pre-coefficients (compute_sf_precoeff)
SF_IMAGES = 5


def bspline(t, p: int = ORDER):
    """The centred cardinal B-spline of order p at t (support |t| < p/2)."""
    if p == 1:
        return ((t >= -0.5) & (t < 0.5)).to(t.dtype)
    return ((0.5 * p + t) * bspline(t + 0.5, p - 1)
            + (0.5 * p - t) * bspline(t - 0.5, p - 1)) / (p - 1)


def dbspline(t, p: int = ORDER):
    """d/dt of ``bspline(t, p)``."""
    return bspline(t + 0.5, p - 1) - bspline(t - 0.5, p - 1)


def gf_b(p: int = ORDER) -> list:
    """LAMMPS compute_gf_denom's coefficients: sum over images of W^2 =
    sum_l b_l sin^(2l)(pi k / n)."""
    b = [1.0] + [0.0] * (p - 1)
    for m in range(1, p):
        for l in range(m, 0, -1):
            b[l] = 4.0 * (b[l] * (l - m) * (l - m - 0.5)
                          - b[l - 1] * (l - m - 1) * (l - m - 1))
        b[0] = 4.0 * (b[0] * (0 - m) * (0 - m - 0.5))
    fact = math.factorial(2 * p - 1)
    return [v / fact for v in b]


def sinc_pow(arg, p):
    """(sin(arg) / arg)^p, 1 at arg 0 (LAMMPS powsinxx)."""
    safe = torch.where(arg == 0, torch.ones_like(arg), arg)
    return torch.where(arg == 0, torch.ones_like(arg),
                       (torch.sin(safe) / safe) ** p)


def tf32_round(t):
    """t with its mantissa rounded to TF32's 10 bits (round half even)."""
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


class Mesh:
    """One deck's PPPM mesh on ``device``: set up in float64, computed in
    ``dtype``."""

    def __init__(self, box, box_lo, g_ewald, dims, diff, device,
                 dtype=torch.float64, tf32=False):
        if diff not in ("ik", "ad"):
            raise ValueError(f"kspace_modify diff is ik or ad, not {diff!r}")
        self.box = tuple(float(b) for b in box)
        self.lo = tuple(float(b) for b in box_lo)
        self.g = float(g_ewald)
        self.dims = tuple(int(n) for n in dims)
        self.diff = diff
        self.dev = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self.volume = self.box[0] * self.box[1] * self.box[2]
        self.delinv = [n / L for n, L in zip(self.dims, self.box)]
        f64 = dict(dtype=torch.float64, device=self.dev)
        # the wave numbers per axis, as LAMMPS's fkx (the upper half
        # negative)
        self.kper = [torch.arange(n, **f64) - n * (2 * torch.arange(
            n, device=self.dev) // n) for n in self.dims]
        self.k = [2.0 * math.pi / L * m for m, L in zip(self.kper, self.box)]
        greens = (self._greens_ik() if diff == "ik" else self._greens_ad())
        self.greens = greens.to(dtype)
        self.sf = self._sf_coeff(greens) if diff == "ad" else None
        self.fk = [k.to(dtype) for k in self.k]
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.cdtype = cdt

    # ------------------------------------------------------------ set-up
    def _grid(self, per_axis):
        """(nx, ny, nz) from per-axis (n_a,) vectors multiplied together."""
        a, b, c = per_axis
        return a[:, None, None] * b[None, :, None] * c[None, None, :]

    def _denominator(self):
        """(sum over images of W^2)^2, LAMMPS gf_denom."""
        coef = gf_b()
        out = []
        for m, n in zip(self.kper, self.dims):
            s2 = torch.sin(math.pi * m / n) ** 2
            acc = torch.zeros_like(s2)
            for c in reversed(coef):
                acc = c + acc * s2
            out.append(acc)
        return self._grid(out) ** 2

    def _ksq(self):
        kx, ky, kz = self.k
        return (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                + kz[None, None, :] ** 2)

    def _images(self, axis, b):
        """(q, exp(-q^2/4g^2) W(q)^2) of image b along one axis."""
        n, L, m = self.dims[axis], self.box[axis], self.kper[axis]
        q = 2.0 * math.pi / L * (m + n * b)
        w2 = sinc_pow(0.5 * q * L / n, 2 * ORDER)
        return q, torch.exp(-0.25 * (q / self.g) ** 2) * w2

    def _greens_ik(self):
        """LAMMPS compute_gf_ik: 4 pi / k^2 sum_b (k.q_b / q_b^2)
        exp(-q_b^2/4g^2) W(q_b)^2 / denominator, k = 0 set to 0."""
        nb = [int(self.g * L / (math.pi * n) * (-math.log(EPS_HOC)) ** 0.25)
              + EXTRA_IMAGES for n, L in zip(self.dims, self.box)]
        kx, ky, kz = self.k
        ims = [[self._images(a, b) for b in range(-nb[a], nb[a] + 1)]
               for a in range(3)]
        num = torch.zeros(self.dims, dtype=torch.float64, device=self.dev)
        for qx, sx in ims[0]:
            for qy, sy in ims[1]:
                sxy = sx[:, None] * sy[None, :]
                dxy = (kx * qx)[:, None] + (ky * qy)[None, :]
                qxy = (qx * qx)[:, None] + (qy * qy)[None, :]
                for qz, sz in ims[2]:
                    dot2 = qxy[:, :, None] + (qz * qz)[None, None, :]
                    dot1 = dxy[:, :, None] + (kz * qz)[None, None, :]
                    term = dot1 / torch.where(dot2 == 0, 1.0, dot2) * (
                        sxy[:, :, None] * sz[None, None, :])
                    num += torch.where(dot2 == 0, 0.0, term)
        return self._finish(num)

    def _greens_ad(self):
        """LAMMPS compute_gf_ad: 4 pi / k^2 exp(-k^2/4g^2) W(k)^2 /
        denominator."""
        return self._finish(self._grid(
            [self._images(a, 0)[1] for a in range(3)]))

    def _finish(self, num):
        ksq = self._ksq()
        safe = torch.where(ksq == 0, 1.0, ksq)
        return torch.where(ksq == 0, 0.0,
                           4.0 * math.pi / safe * num / self._denominator())

    def _sf_coeff(self, greens):
        """LAMMPS compute_sf_precoeff and the sums of compute_gf_ad: the six
        coefficients of the ad self-force, per axis (sin 2 pi s, sin 4 pi
        s)."""
        s0, s1, s2 = [], [], []
        for m, n in zip(self.kper, self.dims):
            w = [sinc_pow(math.pi * (m + n * (i - 2)) / n, ORDER)
                 for i in range(SF_IMAGES + 1)]
            s0.append(sum(w[i] * w[i] for i in range(SF_IMAGES)))
            s1.append(sum(w[i] * w[i + 1] for i in range(SF_IMAGES)))
            s2.append(sum(w[i] * w[i + 2] if i + 2 <= SF_IMAGES else
                          w[i] * sinc_pow(math.pi * (m + n * i) / n, ORDER)
                          for i in range(SF_IMAGES)))
        out = []
        for a in range(3):
            pre = math.pi / self.volume * self.dims[a] / self.box[a]
            for s, mult in ((s1, 1.0), (s2, 2.0)):
                per = [s[b] if b == a else s0[b] for b in range(3)]
                out.append(mult * pre * float(
                    (self._grid(per) * greens).sum()))
        return out

    # ------------------------------------------------------- per state
    def _r(self, t):
        return tf32_round(t) if self.tf32 else t

    def _stencil(self, x):
        """Per axis: the (N, 5) mesh nodes, weights and weight derivatives
        (d/dx of the weight, in 1/A) of positions x."""
        out = []
        offs = torch.arange(ORDER, device=x.device) - (ORDER - 1) // 2
        for a in range(3):
            u = (x[:, a].to(torch.float64) - self.lo[a]) * self.delinv[a]
            m = torch.floor(u + 0.5)
            t = (m - u)[:, None] + offs[None, :].to(torch.float64)
            idx = torch.remainder(m.to(torch.int64)[:, None] + offs[None, :],
                                  self.dims[a])
            w = bspline(t).to(self.dtype)
            dw = (-self.delinv[a] * dbspline(t)).to(self.dtype)
            out.append((idx, w, dw))
        return out

    def _flat(self, st):
        (ix, _, _), (iy, _, _), (iz, _, _) = st
        ny, nz = self.dims[1], self.dims[2]
        return ((ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
                + iz[:, None, None, :]).reshape(ix.shape[0], -1)

    @staticmethod
    def _outer(a, b, c):
        return (a[:, :, None, None] * b[:, None, :, None]
                * c[:, None, None, :]).reshape(a.shape[0], -1)

    def density_k(self, x, q):
        """The transform of the charges q at x assigned to the mesh
        (unnormalised forward FFT of sum q W)."""
        st = self._stencil(x)
        w = self._outer(*(self._r(s[1]) for s in st))
        rho = torch.zeros(math.prod(self.dims), dtype=self.dtype,
                          device=self.dev)
        rho.index_add_(0, self._flat(st).reshape(-1),
                       (self._r(q)[:, None] * w).reshape(-1))
        return torch.fft.fftn(rho.reshape(self.dims).to(self.cdtype))

    def _to_mesh(self, fk):
        """Real part of the normalised inverse FFT, times M / V."""
        return torch.fft.ifftn(fk).real * (math.prod(self.dims)
                                           / self.volume)

    def _solved(self, rhok):
        g = self._r(self.greens)
        if self.tf32:
            rhok = torch.complex(tf32_round(rhok.real), tf32_round(rhok.imag))
        return rhok * g

    def _read(self, mesh, st, ws):
        """sum over each atom's stencil of (weight product) x mesh."""
        vals = self._r(mesh).reshape(-1)[self._flat(st)]
        return (self._outer(*(self._r(w) for w in ws)) * vals).sum(1)

    def potential(self, x, q, xp):
        """The mesh's potential at the points xp from charges q at x."""
        u = self._to_mesh(self._solved(self.density_k(x, q)))
        st = self._stencil(xp)
        return self._read(u, st, [s[1] for s in st])

    def energy_forces(self, x, q):
        """(energy, forces) of the mesh without qqr2e: E = 1/2V sum_k G
        |rho_k|^2; F = q E(x) by ik or ad, ad less the self-force."""
        rhok = self.density_k(x, q)
        e = 0.5 / self.volume * (self.greens * (
            rhok.real ** 2 + rhok.imag ** 2)).sum()
        phik = self._solved(rhok)
        st = self._stencil(x)
        w = [s[1] for s in st]
        if self.diff == "ik":
            field = []
            for a in range(3):
                shape = [1, 1, 1]
                shape[a] = -1
                ik = torch.complex(torch.zeros_like(self.fk[a]), self.fk[a])
                field.append(self._read(
                    self._to_mesh(-ik.reshape(shape) * phik), st, w))
            return e, q[:, None] * torch.stack(field, 1)
        u = self._to_mesh(phik)
        field = []
        for a in range(3):
            ws = list(w)
            ws[a] = -st[a][2]
            field.append(self._read(u, st, ws))
        f = q[:, None] * torch.stack(field, 1)
        s = [(x[:, a] - self.lo[a]) * self.delinv[a] for a in range(3)]
        sf = torch.stack([
            self.sf[2 * a] * torch.sin(2 * math.pi * s[a])
            + self.sf[2 * a + 1] * torch.sin(4 * math.pi * s[a])
            for a in range(3)], 1)
        return e, f - 2.0 * (q * q)[:, None] * sf
