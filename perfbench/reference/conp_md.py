"""The plain reference of a constant-potential MD step (LAMMPS USER-CONP2,
``fix conp`` with the INV solver, the NORMAL slab or FFIELD, Ewald
k-space), in plain PyTorch, from a ``Deck`` alone.  Under a PPPM deck it
computes the exact Ewald sum that the mesh approximates to the deck's
stated accuracy; where the configuration states the mesh's
differentiation (``Deck.pppm_diff``, ``kspace_modify diff``), it computes
PPPM's mesh itself (``reference.pppm``) for the b vector's k-space part,
the k-space forces and the energy, with A still the exact Ewald sum
(pppm_conp.cpp:91-101).

It works out everything itself: g_ewald by LAMMPS's PPPM rule (the decks'
host kspace style), the half-space k-vectors, the A matrix from the direct
Ewald sum, its projected inverse, the d vector; then per state the b
vector, the charges, the forces and energy (LJ + Coulomb/long with
special_bonds 0, harmonic bonds and angles, Ewald, the EW3DC slab term,
the electrodes' Gaussian correction and self energy), the thermo row, and
one velocity-Verlet step with Nose-Hoover chains, SHAKE and RATTLE (twelve
Gauss-Seidel sweeps in fix shake's slot order).  Every sum over k-vectors
is a direct sum over cos/sin tables in chunks; every pair sum runs over
blocks of rows, so that no tensor grows with N^2 (the exclusions are
set per block from ``Deck.excl``, and each block's pair terms computed for
the atoms in the cells next to its rows alone, then summed over every
column as the sweep over all atoms summed them).

``Reference(deck, device)`` computes in float64.  ``Reference(deck,
device, tf32=True)`` is the control: the same steps in float32 with every
k-space product's operands rounded to TF32 (10 mantissa bits), as the
card's tensor cores round them when TF32 is switched on (on the mesh: the
assignment's, the influence function's and the read-back's products); the
set-up stays float64, as the configuration states it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .deck import BOLTZ, EVSCALE, FTM2V, MVV2E, QE2F, QQR2E, Deck
from .pppm import Mesh, tf32_round

# Abramowitz & Stegun 7.1.26, the constants of fix_conp.cpp:53-60, and
# its argument clamp
EWALD_F = 1.12837917
EWALD_P = 0.3275911
A1, A2, A3, A4, A5 = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
                      1.061405429)
ERFC_MAX = 5.8
SHAKE_SWEEPS = 12
KCHUNK = 4096
# rows of the pair sweep's blocks, and the elements (rows x N) of a block
# of electrode rows against every atom
ROWS = 512
ROW_ELEMS = 1 << 24
# the pair sweep's cells are at least this many cutoffs wide
CELL_MARGIN = 1.001

# Deserno & Holm's ik error coefficients at order 5 (LAMMPS pppm.cpp acons)
ACONS5 = (1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
          517231.0 / 106536960.0, 106640677.0 / 11737571328.0)


# --------------------------------------------------------------- set-up
def _ik_error(h, prd, natoms, q2, g):
    s = sum(a * (h * g) ** (2 * m) for m, a in enumerate(ACONS5))
    return (q2 * (h * g) ** 5 * math.sqrt(
        g * prd * math.sqrt(2 * math.pi) * s / natoms) / (prd * prd))


def _factorable(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def pppm_grid(box, acc, natoms, q2, cutoff) -> tuple:
    """(g_ewald, [nx, ny, nz]) by LAMMPS pppm.cpp set_grid_global and
    adjust_gewald (order 5, the physical box): the mesh that the first
    estimate of g_ewald asks for, then g_ewald adjusted to it."""
    xprd, yprd, zprd = box
    g = acc * math.sqrt(natoms * cutoff * xprd * yprd * zprd) / (2.0 * q2)
    g = ((1.35 - 0.15 * math.log(acc)) / cutoff if g >= 1.0
         else math.sqrt(-math.log(g)) / cutoff)
    ns = []
    for prd in box:
        n = max(2, int(prd / (4.0 / g)))
        while _ik_error(prd / n, prd, natoms, q2, g) > acc:
            n += 1
        while not _factorable(n):
            n += 1
        ns.append(n)

    def diff(gg):
        rs = (2.0 * q2 * math.exp(-gg * gg * cutoff * cutoff)
              / math.sqrt(natoms * cutoff * xprd * yprd * zprd))
        ks = math.sqrt(sum(_ik_error(p / n, p, natoms, q2, gg) ** 2
                           for p, n in zip(box, ns))) / math.sqrt(3.0)
        return rs - ks

    for _ in range(100):
        f = diff(g)
        g -= f / ((diff(g + 1e-6) - f) / 1e-6)
        if abs(diff(g)) < 1e-5:
            break
    return g, ns


def kvectors(box, acc, natoms, q2, g, slab):
    """(kvecs (K, 3), ug (K,), volume): LAMMPS ewald's accuracy-driven kmax
    per axis and the half-space set within the largest |k|, with
    ug = (4 pi / V) exp(-k^2 / 4g^2) / k^2 over the slab-extended V."""
    xprd, yprd, zprd = box
    zs = zprd * slab if slab else zprd
    vol = xprd * yprd * zs
    unit = [2 * math.pi / p for p in (xprd, yprd, zs)]
    kmax = []
    for prd in (xprd, yprd, zs):
        km = 1
        while (2.0 * q2 * g / prd * math.sqrt(1.0 / (math.pi * km * natoms))
               * math.exp(-(math.pi * km / (g * prd)) ** 2)) > acc:
            km += 1
        kmax.append(km)
    gsq = max((u * k) ** 2 for u, k in zip(unit, kmax)) * 1.00001
    kk = np.stack(np.meshgrid(np.arange(0, kmax[0] + 1),
                              np.arange(-kmax[1], kmax[1] + 1),
                              np.arange(-kmax[2], kmax[2] + 1),
                              indexing="ij"), -1).reshape(-1, 3)
    half = (kk[:, 0] > 0) | ((kk[:, 0] == 0) & (kk[:, 1] > 0)) | (
        (kk[:, 0] == 0) & (kk[:, 1] == 0) & (kk[:, 2] > 0))
    kc = kk * np.array(unit)
    sq = (kc ** 2).sum(1)
    keep = half & (sq <= gsq)
    kc, sq = kc[keep], sq[keep]
    ug = 4.0 * math.pi / vol * np.exp(-0.25 * sq / g ** 2) / sq
    return kc, ug, vol


def _to_columns(t, cols, n):
    """t (rows, len(cols), ...) placed at columns ``cols`` of a zero
    (rows, n, ...) tensor (t itself where cols are all n): a sum over the
    columns then adds what the sweep over every atom added, in its
    order."""
    if cols.shape[0] == n:
        return t
    out = t.new_zeros((t.shape[0], n) + t.shape[2:])
    out[:, cols] = t
    return out


def slab_mesh(dims, slab) -> tuple:
    """The mesh over the slab-extended box: nz scaled by the slab factor
    and raised to the next size of factors 2, 3 and 5."""
    nx, ny, nz = dims
    if slab:
        nz = int(round(nz * slab))
        while not _factorable(nz):
            nz += 1
    return nx, ny, nz


def erfc_as(x):
    t = 1.0 / (1.0 + EWALD_P * x)
    return t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * torch.exp(-x * x)


def erfcr(a, r):
    """erfc(a r) / r, clamped to 0 where a r >= ERFC_MAX
    (FixConp::erfcr_sqrt)."""
    ar = a * r
    return torch.where(ar < ERFC_MAX, erfc_as(ar) / r, torch.zeros_like(r))


def ferfcr(a, r):
    """erfc(a r)/r + (2/sqrt(pi)) a exp(-a^2 r^2), clamped as ``erfcr``
    (FixConp::ferfcr_sqrt)."""
    ar = a * r
    val = erfc_as(ar) / r + EWALD_F * a * torch.exp(-ar * ar)
    return torch.where(ar < ERFC_MAX, val, torch.zeros_like(r))


def clusters(shake) -> list:
    """fix shake's clusters grouped by shape: [(atoms [[row, ...], ...],
    slots [(column i, column j)], squared distances [[d^2 per slot], ...])]
    with the clusters the connected components of the constraints, their
    slots in build order, their columns in order of first appearance."""
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            a = parent[a]
        return a

    for i, j, _ in shake:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    groups = {}
    for c, (i, _, _) in enumerate(shake):
        groups.setdefault(find(i), []).append(c)
    by_shape = {}
    for cons in groups.values():
        local = []
        for c in cons:
            for a in shake[c][:2]:
                if a not in local:
                    local.append(a)
        sig = tuple((local.index(shake[c][0]), local.index(shake[c][1]))
                    for c in cons)
        by_shape.setdefault((len(local), sig), []).append(
            (local, [shake[c][2] ** 2 for c in cons]))
    return [([m[0] for m in members], list(sig), [m[1] for m in members])
            for (_, sig), members in by_shape.items()]


class Reference:
    """The reference of one deck on ``device``."""

    def __init__(self, deck: Deck, device, *, tf32: bool = False):
        self.deck = deck
        self.dev = torch.device(device)
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        d = deck
        q2 = float((d.q0 ** 2).sum()) * QQR2E
        acc = d.accuracy * QQR2E
        self.g, dims = pppm_grid(d.box, acc, d.natoms, q2, d.cutoff)
        kv, ug, self.volume = kvectors(d.box, acc, d.natoms, q2, self.g,
                                       d.slab)
        self.mesh = None
        if d.pppm_diff:
            zs = d.box[2] * (d.slab or 1.0)
            self.mesh = Mesh((d.box[0], d.box[1], zs), d.box_lo, self.g,
                             slab_mesh(dims, d.slab), d.pppm_diff, self.dev,
                             self.dtype, tf32=tf32)
        self.cut_coulsq = min(d.cutoff ** 2, (ERFC_MAX / self.g) ** 2)
        f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                        device=self.dev)
        self.kv64, self.ug64 = f64(kv), f64(ug)
        self.ele = torch.as_tensor(d.ele, device=self.dev)
        self.ele_idx = torch.as_tensor(np.flatnonzero(d.ele), device=self.dev)
        self.elyte = ~self.ele
        self.left = torch.as_tensor(d.left, device=self.dev)
        self.right = torch.as_tensor(d.right, device=self.dev)
        self._setup(f64)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.dev)
        self.t = t
        self.kv, self.ug = self.kv64.to(self.dtype), self.ug64.to(self.dtype)
        self.mass = t(d.mass)
        self.mobile = torch.as_tensor(d.mobile, device=self.dev)
        self.typ = torch.as_tensor(d.type, device=self.dev)
        s6 = d.lj_sig ** 6
        self.lj = [t(48 * d.lj_eps * s6 * s6), t(24 * d.lj_eps * s6),
                   t(4 * d.lj_eps * s6 * s6), t(4 * d.lj_eps * s6)]
        n = d.natoms
        # each excluded pair both ways round, (row, column)
        ex = np.asarray(d.excl, np.int64).reshape(-1, 2)
        self.excl = torch.as_tensor(np.concatenate([ex, ex[:, ::-1]]),
                                    device=self.dev)
        # SHAKE clusters: connected constraints, slots in build order
        self.clusters = []
        for atoms, slots, d2 in clusters(d.shake):
            d2 = t(d2)
            self.clusters.append((torch.as_tensor(atoms, device=self.dev), [
                (i, j, d2[:, s]) for s, (i, j) in enumerate(slots)]))
        ncons = len(d.shake)
        self.ncons = ncons
        in_grp = lambda g: sum(1 for i, j, _ in d.shake if g[i] and g[j])
        self.thermos = [(torch.as_tensor(g, device=self.dev),
                         3.0 * g.sum() - 3.0 - in_grp(g), temp, damp, tch)
                        for g, temp, damp, tch in d.thermostats]
        self.dof_all = 3.0 * n - 3.0 - ncons
        self.sol = torch.as_tensor(d.sol, device=self.dev)
        self.dof_sol = 3.0 * d.sol.sum() - 3.0 - in_grp(d.sol)

    # ------------------------------------------------------------ set-up
    def _trig64(self, x, sl):
        ph = x @ self.kv64[sl].T
        return torch.cos(ph), torch.sin(ph)

    def _setup(self, f64):
        """A (k-space + real-space + Gaussian self terms, slab), its
        inverse projected onto neutral charges, d and A^-1 d; float64."""
        d = self.deck
        xe = f64(d.x0[d.ele])
        ne = xe.shape[0]
        a = torch.zeros((ne, ne), dtype=torch.float64, device=self.dev)
        for k0 in range(0, self.kv64.shape[0], KCHUNK):
            sl = slice(k0, k0 + KCHUNK)
            c, s = self._trig64(xe, sl)
            w = 2.0 * self.ug64[sl]
            a += (c * w) @ c.T + (s * w) @ s.T
        eye = torch.eye(ne, dtype=torch.bool, device=self.dev)
        diag = (2.0 * self.ug64).sum() - 2.0 / math.sqrt(math.pi) * self.g
        a = torch.where(eye, diag, a)
        if d.slab:
            a += 4.0 * math.pi / self.volume * torch.outer(xe[:, 2], xe[:, 2])
        r = self._dist(xe, xe)
        cut = min(self.cut_coulsq, (ERFC_MAX / self.g) ** 2)
        off = ~eye & (r * r < cut)
        rs = torch.where(off, r, torch.ones_like(r))
        eta2 = d.eta / math.sqrt(2.0)
        a += torch.where(off, erfcr(self.g, rs) - erfcr(eta2, rs),
                         torch.zeros_like(r))
        a += torch.diag(torch.full((ne,), math.sqrt(2.0 / math.pi) * d.eta,
                                   dtype=torch.float64, device=self.dev))
        ainv = torch.linalg.inv(a)
        e = ainv.sum(1)
        ainv = ainv - torch.outer(e, e) / e.sum()
        dvec = -0.5 * EVSCALE * f64(np.where(d.left[d.ele], 1.0, -1.0))
        if d.ffield:
            # the z ramp (b_setq_cal): the left electrode in the lower half
            # one box length down
            z = xe[:, 2]
            low = f64(d.left[d.ele]) * (z < d.box_lo[2] + d.box[2] / 2)
            dvec = -EVSCALE * (z / d.box[2] + low)
        self.ainv = ainv
        self.elesetq = ainv @ dvec
        self.totsetq = self.elesetq[f64(d.left[d.ele]) > 0].sum()

    def _dist(self, xa, xb):
        """|minimum image (xa_i - xb_j)| (rows of xa against rows of xb)."""
        return torch.sqrt((self._mi(xa[:, None, :] - xb[None, :, :]) ** 2
                           ).sum(-1))

    def _mi(self, dx):
        box = torch.as_tensor(self.deck.box, dtype=dx.dtype, device=dx.device)
        per = torch.as_tensor(self.deck.periodic, device=dx.device)
        return torch.where(per, dx - box * torch.round(dx / box), dx)

    # ----------------------------------------------------------- k-space
    def _mm(self, a, b):
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def _tables(self, x, sl):
        """cos/sin of k.x in the working dtype: phases in float64."""
        c, s = self._trig64(x.to(torch.float64), sl)
        return c.to(self.dtype), s.to(self.dtype)

    def _sfac(self, x, q):
        """Re and Im of S(k) = sum_j q_j exp(i k.x_j), over all k."""
        re, im = [], []
        for k0 in range(0, self.kv.shape[0], KCHUNK):
            c, s = self._tables(x, slice(k0, k0 + KCHUNK))
            re.append(self._mm(q[None, :], c)[0])
            im.append(self._mm(q[None, :], s)[0])
        return torch.cat(re), torch.cat(im)

    def kspace(self, x, q):
        """(energy, forces) of the Ewald sum without qqr2e: E = sum_half ug
        |S|^2, F_j = 2 q_j sum ug k (sin_j Re S - cos_j Im S); or of the
        mesh, where the deck states it."""
        if self.mesh is not None:
            return self.mesh.energy_forces(x, q)
        sr, si = self._sfac(x, q)
        e = torch.sum(self.ug * (sr * sr + si * si))
        f = torch.zeros_like(x)
        for k0 in range(0, self.kv.shape[0], KCHUNK):
            sl = slice(k0, k0 + KCHUNK)
            c, s = self._tables(x, sl)
            w = (self.ug[sl] * self.kv[sl].T).T                 # (Kc, 3)
            f += self._mm(s, sr[sl, None] * w) - self._mm(c, si[sl, None] * w)
        return e, 2.0 * q[:, None] * f

    # ------------------------------------------------------------- solve
    def solve(self, x, q):
        """(q with the electrode charges of positions x, the fix scalar):
        b from the electrolyte, then q_ele = A^-1 b + V A^-1 d."""
        d = self.deck
        qe = torch.where(self.elyte, q, torch.zeros_like(q))
        xe = x[self.ele_idx]
        if self.mesh is not None:
            b = -self.mesh.potential(x, qe, xe)
        else:
            sr, si = self._sfac(x, qe)
            b = torch.zeros(xe.shape[0], dtype=self.dtype, device=self.dev)
            for k0 in range(0, self.kv.shape[0], KCHUNK):
                sl = slice(k0, k0 + KCHUNK)
                c, s = self._tables(xe, sl)
                w = 2.0 * self.ug[sl]
                b -= self._mm(c, (w * sr[sl])[:, None])[:, 0] + self._mm(
                    s, (w * si[sl])[:, None])[:, 0]
        for e0 in self._ele_blocks(x.shape[0]):
            r = self._dist(xe[e0], x)
            m = self.elyte[None, :] & (r * r < self.cut_coulsq)
            rs = torch.where(m, r, torch.ones_like(r))
            pot = erfcr(self.g, rs) - erfcr(d.eta, rs)
            b[e0] -= torch.sum(torch.where(m, pot, torch.zeros_like(r))
                               * qe[None, :], dim=1)
        if d.slab:
            b -= xe[:, 2] * (4.0 * math.pi / self.volume) * torch.sum(
                qe * x[:, 2])
        eleallq = (self.ainv @ b.to(torch.float64)).to(self.dtype)
        scalar = d.volts * self.totsetq.to(self.dtype) + eleallq[
            self.left[self.ele_idx]].sum()
        qn = q.clone()
        qn[self.ele_idx] = eleallq + d.volts * self.elesetq.to(self.dtype)
        return qn, scalar

    # ------------------------------------------------------------ forces
    def forces(self, x, q):
        """(forces, potential energy) at positions x and charges q."""
        d = self.deck
        n = x.shape[0]
        f = torch.zeros_like(x)
        evdwl = ecoul = torch.zeros((), dtype=self.dtype, device=self.dev)
        cell, ncell = self._cells(x)
        for i0 in range(0, n, ROWS):
            rows = torch.arange(i0, min(i0 + ROWS, n), device=self.dev)
            cols = self._reach(cell, ncell, rows)
            dx = self._mi(x[rows, None, :] - x[None, cols, :])
            rsq = (dx * dx).sum(-1)
            on = (rsq < d.cutoff ** 2) & (rows[:, None] != cols[None, :])
            r2 = torch.where(on, rsq, torch.ones_like(rsq))
            r = torch.sqrt(r2)
            sp = self._special(i0, rows.shape[0], cols)
            tij = (self.typ[rows, None], self.typ[None, cols])
            r6 = 1.0 / (r2 * r2 * r2)
            lj = on & (sp > 0.0)
            zero = torch.zeros_like(r2)
            flj = torch.where(lj, sp * r6 * (self.lj[0][tij] * r6
                                             - self.lj[1][tij]) / r2, zero)
            elj = torch.where(lj, sp * r6 * (self.lj[2][tij] * r6
                                             - self.lj[3][tij]), zero)
            gr = self.g * r
            erfc = erfc_as(gr)
            pre = QQR2E * q[rows, None] * q[None, cols] / r
            fc = pre * (erfc + EWALD_F * gr * torch.exp(-gr * gr)) - (
                1.0 - sp) * pre
            ec = pre * erfc - (1.0 - sp) * pre
            fpair = flj + torch.where(on, fc, zero) / r2
            wide = lambda t: _to_columns(t, cols, n)
            f[rows] = wide(fpair[..., None] * dx).sum(1)
            evdwl = evdwl + 0.5 * wide(elj).sum()
            ecoul = ecoul + 0.5 * wide(torch.where(on, ec, zero)).sum()
        pe = evdwl + ecoul
        fb, eb = self._bonded(x)
        f, pe = f + fb, pe + eb
        ek, fk = self.kspace(x, q)
        qsum = q.sum()
        pe = pe + QQR2E * ek - QQR2E * self.g / math.sqrt(math.pi) * (
            q * q).sum() - QQR2E * math.pi / (2 * self.g ** 2 * self.volume
                                              ) * qsum * qsum
        f = f + QQR2E * fk
        if d.slab:
            mz = (q * x[:, 2]).sum()
            pe = pe + QQR2E * 2.0 * math.pi / self.volume * mz * mz
            f[:, 2] += -QQR2E * 4.0 * math.pi / self.volume * q * mz
        # the electrodes' Gaussian correction on electrode-electrolyte pairs
        for e0 in self._ele_blocks(n):
            ei = self.ele_idx[e0]
            dx = self._mi(x[ei][:, None, :] - x[None, :, :])
            rsq = (dx * dx).sum(-1)
            m = self.elyte[None, :] & (rsq < d.cutoff ** 2)
            r = torch.sqrt(torch.where(m, rsq, torch.ones_like(rsq)))
            pre = QQR2E * q[ei, None] * q[None, :]
            zero = torch.zeros_like(rsq)
            fpair = torch.where(m, -pre * ferfcr(d.eta, r), zero) / (r * r)
            fe = (fpair[..., None] * dx)
            f = f - fe.sum(0)
            f[ei] += fe.sum(1)
            pe = pe + torch.where(m, -pre * erfcr(d.eta, r), zero).sum()
        pe = pe + QQR2E * d.self_fac * math.sqrt(2.0 / math.pi) * d.eta * (
            q[self.ele_idx] ** 2).sum()
        if d.ffield:
            # the external field -V/Lz along z: F = qe2f q E
            f[:, 2] += QE2F * q * (-d.volts / d.box[2])
        return f, pe

    def _special(self, i0, rows, cols):
        """(rows, len(cols)) special_bonds factors of rows i0.. against the
        atoms ``cols`` (ascending): 0 on the deck's excluded pairs, 1
        elsewhere."""
        sp = torch.ones((rows, cols.shape[0]), dtype=self.dtype,
                        device=self.dev)
        e = self.excl
        e = e[(e[:, 0] >= i0) & (e[:, 0] < i0 + rows)]
        at = torch.full((self.deck.natoms,), -1, dtype=torch.int64,
                        device=self.dev)
        at[cols] = torch.arange(cols.shape[0], device=self.dev)
        j = at[e[:, 1]]
        sp[e[j >= 0, 0] - i0, j[j >= 0]] = 0.0
        return sp

    def _cells(self, x):
        """(each atom's cell, cells per axis): a grid of cells wider than
        the cutoff, periodic axes wrapped, the others clamped to the box's
        cells (which keeps atoms within the cutoff in neighbouring
        cells)."""
        d = self.deck
        cell = torch.zeros(x.shape[0], dtype=torch.int64, device=self.dev)
        ncell = []
        for a in range(3):
            nc = max(1, int(d.box[a] // (d.cutoff * CELL_MARGIN)))
            u = (x[:, a].to(torch.float64) - d.box_lo[a]) / d.box[a]
            if d.periodic[a]:
                u = u - torch.floor(u)
            c = torch.clamp(torch.floor(u * nc), 0, nc - 1).to(torch.int64)
            cell = cell * nc + c
            ncell.append(nc)
        return cell, ncell

    def _reach(self, cell, ncell, rows):
        """The atoms (ascending) in the cells next to those of ``rows``: a
        superset of every atom within the cutoff of one of them."""
        d = self.deck
        own = torch.unique(cell[rows])
        per = [own // (ncell[1] * ncell[2]), (own // ncell[2]) % ncell[1],
               own % ncell[2]]
        near = torch.zeros(math.prod(ncell), dtype=torch.bool,
                           device=self.dev)
        for off in np.ndindex(3, 3, 3):
            flat = torch.zeros_like(own)
            ok = torch.ones_like(own, dtype=torch.bool)
            for a in range(3):
                c = per[a] + (off[a] - 1)
                if d.periodic[a]:
                    c = torch.remainder(c, ncell[a])
                else:
                    ok &= (c >= 0) & (c < ncell[a])
                flat = flat * ncell[a] + c
            near[flat[ok]] = True
        return torch.nonzero(near[cell]).squeeze(1)

    def _ele_blocks(self, n):
        """Slices of the electrode rows, each block at most ``ROW_ELEMS``
        elements against n atoms."""
        step = max(1, ROW_ELEMS // n)
        return [slice(e0, e0 + step)
                for e0 in range(0, self.ele_idx.shape[0], step)]

    def _bonded(self, x):
        """Harmonic bonds K (r - r0)^2 and angles K (theta - theta0)^2."""
        d = self.deck
        f = torch.zeros_like(x)
        e = torch.zeros((), dtype=self.dtype, device=self.dev)
        if len(d.bonds):
            b = torch.as_tensor(d.bonds, device=self.dev)
            k, r0 = self.t(d.bond_coeffs)[b[:, 0]].T
            dx = self._mi(x[b[:, 1]] - x[b[:, 2]])
            r = torch.sqrt((dx * dx).sum(-1))
            e = e + (k * (r - r0) ** 2).sum()
            fij = (-2.0 * k * (r - r0) / r)[:, None] * dx
            f.index_add_(0, b[:, 1], fij)
            f.index_add_(0, b[:, 2], -fij)
        if len(d.angles):
            a = torch.as_tensor(d.angles, device=self.dev)
            ka, t0 = self.t(d.angle_coeffs)[a[:, 0]].T
            d1 = self._mi(x[a[:, 1]] - x[a[:, 2]])
            d2 = self._mi(x[a[:, 3]] - x[a[:, 2]])
            r1s, r2s = (d1 * d1).sum(-1), (d2 * d2).sum(-1)
            r1, r2 = torch.sqrt(r1s), torch.sqrt(r2s)
            c = torch.clamp((d1 * d2).sum(-1) / (r1 * r2), -1.0, 1.0)
            s = torch.clamp(torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)),
                            min=0.001)
            dth = torch.arccos(c) - t0 * (math.pi / 180.0)
            e = e + (ka * dth * dth).sum()
            aa = -2.0 * ka * dth / s
            f1 = (aa * c / r1s)[:, None] * d1 - (aa / (r1 * r2))[:, None] * d2
            f3 = (aa * c / r2s)[:, None] * d2 - (aa / (r1 * r2))[:, None] * d1
            f.index_add_(0, a[:, 1], f1)
            f.index_add_(0, a[:, 3], f3)
            f.index_add_(0, a[:, 2], -(f1 + f3))
        return f, e

    # ------------------------------------------------------- integrator
    def _shake(self, x_new, x_old):
        x = x_new.clone()
        invm = 1.0 / self.mass
        for atoms, slots in self.clusters:
            xc, xo = x_new[atoms].clone(), x_old[atoms]
            im = invm[atoms]
            r_old = [self._mi(xo[:, i] - xo[:, j]) for i, j, _ in slots]
            for _ in range(SHAKE_SWEEPS):
                for s, (i, j, d2) in enumerate(slots):
                    rn = self._mi(xc[:, i] - xc[:, j])
                    den = 2.0 * (im[:, i] + im[:, j]) * (rn * r_old[s]).sum(-1)
                    lam = ((rn * rn).sum(-1) - d2) / torch.where(
                        den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
                    corr = lam[:, None] * r_old[s]
                    xc[:, i] -= im[:, i, None] * corr
                    xc[:, j] += im[:, j, None] * corr
            x[atoms.reshape(-1)] = xc.reshape(-1, 3)
        return x

    def _rattle(self, x, v):
        v = v.clone()
        invm = 1.0 / self.mass
        for atoms, slots in self.clusters:
            xc, vc = x[atoms], v[atoms].clone()
            im = invm[atoms]
            rs, dens = [], []
            for i, j, _ in slots:
                r = self._mi(xc[:, i] - xc[:, j])
                den = (im[:, i] + im[:, j]) * (r * r).sum(-1)
                rs.append(r)
                dens.append(torch.where(den > 1e-12, den,
                                        torch.full_like(den, 1e-12)))
            for _ in range(SHAKE_SWEEPS):
                for s, (i, j, _) in enumerate(slots):
                    mu = ((vc[:, i] - vc[:, j]) * rs[s]).sum(-1) / dens[s]
                    corr = mu[:, None] * rs[s]
                    vc[:, i] -= im[:, i, None] * corr
                    vc[:, j] += im[:, j, None] * corr
            v[atoms.reshape(-1)] = vc.reshape(-1, 3)
        return v

    def _ke2(self, v, mask):
        mv2 = (self.mass[:, None] * v * v).sum(1)
        return MVV2E * torch.where(mask, mv2, torch.zeros_like(mv2)).sum()

    def _nhc_half(self, v, xi, vxi):
        """One Nose-Hoover chain half step per thermostat (LAMMPS fix nvt,
        tloop 1: the chain inward, the scaling, the chain outward)."""
        dt = self.deck.dt
        xi, vxi = xi.clone(), vxi.clone()
        for t, (mask, dof, temp, damp, m) in enumerate(self.thermos):
            kt = BOLTZ * temp
            qm = [dof * kt * damp ** 2] + [kt * damp ** 2] * (m - 1)
            ke2 = self._ke2(v, mask)
            w = vxi[t].clone()
            g = [(ke2 - dof * kt) / qm[0]] + [
                (qm[k - 1] * w[k - 1] ** 2 - kt) / qm[k] for k in range(1, m)]
            w[m - 1] = w[m - 1] + g[m - 1] * dt / 4
            for k in range(m - 2, -1, -1):
                ef = torch.exp(-dt / 8 * w[k + 1])
                w[k] = (w[k] * ef + g[k] * dt / 4) * ef
            scale = torch.exp(-dt / 2 * w[0])
            v = torch.where(mask[:, None], v * scale, v)
            ke2 = ke2 * scale * scale
            xi[t] = xi[t] + dt / 2 * w
            g[0] = (ke2 - dof * kt) / qm[0]
            for k in range(m - 1):
                ef = torch.exp(-dt / 8 * w[k + 1])
                w[k] = (w[k] * ef + g[k] * dt / 4) * ef
                g[k + 1] = (qm[k] * w[k] ** 2 - kt) / qm[k + 1]
            w[m - 1] = w[m - 1] + g[m - 1] * dt / 4
            vxi[t] = w
        return v, xi, vxi

    def _kick(self, v, f):
        dtfm = self.deck.dt / 2 * FTM2V / self.mass[:, None]
        return torch.where(self.mobile[:, None], v + dtfm * f, v)

    def step(self, x, v, xi, vxi, q):
        """One step from (x, v, thermostat state, charges): (x, v, xi, vxi,
        q, scalar, f, pe) after it; the forces at the start are the
        reference's own."""
        f0, _ = self.forces(x, self.solve(x, q)[0])
        v, xi, vxi = self._nhc_half(v, xi, vxi)
        v = self._kick(v, f0)
        xn = torch.where(self.mobile[:, None], x + self.deck.dt * v, x)
        if self.clusters:
            xs = self._shake(xn, x)
            v = v + (xs - xn) / self.deck.dt
            xn = xs
        qn, scalar = self.solve(xn, q)
        f, pe = self.forces(xn, qn)
        v = self._kick(v, f)
        if self.clusters:
            v = self._rattle(xn, v)
        v, xi, vxi = self._nhc_half(v, xi, vxi)
        return dict(x=xn, v=v, xi=xi, vxi=vxi, q=qn, scalar=scalar, f=f,
                    pe=pe)

    def thermo(self, v, q, x, scalar, pe):
        """The thermo row: Temp, c_tempsl, c_qleft, c_qright, c_dipole, f_e,
        PotEng."""
        zq = torch.zeros_like(q)
        return dict(
            temp=self._ke2(v, torch.ones_like(self.sol)) / (
                self.dof_all * BOLTZ),
            tempsl=self._ke2(v, self.sol) / (self.dof_sol * BOLTZ),
            qleft=torch.where(self.left, q, zq).sum(),
            qright=torch.where(self.right, q, zq).sum(),
            dipole=torch.where(self.sol, q * x[:, 2], zq).sum(),
            f_e=scalar, pe=pe)
