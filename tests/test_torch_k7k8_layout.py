"""K7's and K8's layout, emulated on the CPU (the kernels themselves run on
the card only; ``tests/test_torch_gpu.py`` holds them to their plain
versions there, bit for bit).

Each call is one launch that writes every row once: a thread per cluster
writes its valid rows from the packed cluster record
(``shake_kernel.pack_records``), a thread per row of the free-row table
(``shake_kernel.free_rows``) copies the rest.  K7 writes dv as
(x - x_new) times 1 / dt rounded to the dtype, as PyTorch divides a CUDA
tensor by a Python float; at dt = 2 (the decks' 2 fs, a power of two)
the CPU's division rounds the same.  K7 hoists the minimum
image out of
its sweeps: each slot's image shift k0 = rint(d / L) at x_new, the bond
vector d - L k0 in the sweeps, a flag when |d / L - k0| > 1/4 (or
|k0| > 4096) and then the exact loop again from x_new.

* The records round-trip every table of ``ShakeConstraints`` (atom ids with
  their padding, amask bits, slot columns and masks, imi, imj, d^2 exactly
  as float32) and hold 2 (imi + imj) and imi + imj formed in float32; the
  slot code is shared only where every cluster has the same slots (the il
  cell's is ``LINEAR3_CODE``).
* The free rows and the clusters' valid columns cover every atom exactly
  once, at the il cell and for hand-built tables of every LAMMPS cluster
  shape (``torch_cells.SHAKE_SHAPES``); clusters that share an atom are
  refused.
* The emulated launch (records, hoisted sweep, flag, exact rerun, the
  write-out through the free-row table) equals ``shake_positions_plain``
  and ``rattle_velocities_plain`` bit for bit in float32 and float64,
  every float written exactly once and no padding column written: interior
  and straddling clusters run the hoisted sweep alone, the cluster with
  |d / L| within 1e-6 of 1/2 takes the rerun.
"""

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch import workloads
from lammps_user_conp2_tpu_torch.models.shake import (ShakeConstraints,
                                                      build_constraints)
from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as k78
from lammps_user_conp2_tpu_torch.ops.pairs import min_image
from torch_cells import SHAKE_SHAPES, shake_case

torch.set_num_threads(2)

SHAPES = list(SHAKE_SHAPES)
KINDS = ["interior", "straddle", "near_tie"]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def il_cell(tmp_path_factory):
    path = workloads.write_il_data(str(tmp_path_factory.mktemp("il")
                                       / "il.data"))
    system, md, _ = workloads.il_onelayer(0, data_path=path)
    return system, md


def _cons(case, dtype=torch.float32):
    return ShakeConstraints(*case["tables"], natoms=case["natoms"],
                            dtype=dtype, device="cpu")


def unpack(rec, k, c):
    """The fields of the packed records: atoms (M, 4), code and amask bits
    (M,), per slot (M, C, 4) float32 (imi, imj, 2 (imi + imj), d^2) and
    (M, C) imi + imj."""
    m = rec.shape[0]
    r = rec.reshape(m, -1, 4)
    f = r.view(torch.float32)
    isum = f[:, 2 + c:].reshape(m, -1)[:, :c]
    return r[:, 0], r[:, 1, 0], r[:, 1, 1], f[:, 2:2 + c], isum


def _fields(cons, dtype):
    """(atoms, amask, si, sj, cm, imi, imj, isum2, d2, isum) as the kernel
    reads them: from the records in float32, from the tables (formed as
    the plain version forms them) in float64."""
    m, k = cons.atoms.shape
    c = cons.ci.shape[1]
    if dtype == torch.float32:
        atoms, code, bits, sl, isum = unpack(cons.rec, k, c)
        atoms = atoms[:, :k].long()
        amask = ((bits[:, None] >> torch.arange(k)) & 1).bool()
        sh = 5 * torch.arange(c)
        si = (code[:, None] >> sh) & 3
        sj = (code[:, None] >> (sh + 2)) & 3
        cm = ((code[:, None] >> (sh + 4)) & 1).bool()
        return (atoms, amask, si.long(), sj.long(), cm, sl[..., 0],
                sl[..., 1], sl[..., 2], sl[..., 3], isum)
    ci, cj = cons.ci.long(), cons.cj.long()
    imi = torch.gather(cons.invm, 1, ci)
    imj = torch.gather(cons.invm, 1, cj)
    return (cons.atoms.long(), cons.amask, ci, cj, cons.cmask, imi, imj,
            2.0 * (imi + imj), cons.dist2, imi + imj)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _write(cons, atoms, amask, clusters, src, dt=None):
    """The launch's write-out: the free rows from ``src``, the clusters'
    valid rows from ``clusters``; dv beside x when ``dt`` is given, as the
    difference times the reciprocal of dt.  Counts the writes of every
    float."""
    n = src.shape[0]
    out = torch.full_like(src, float("nan")).reshape(-1)
    dv = torch.full_like(out, float("nan"))
    count = torch.zeros(3 * n, dtype=torch.long)
    flat = src.reshape(-1)
    inv_dt = None if dt is None else torch.tensor(1.0 / dt, dtype=src.dtype)
    free = cons.free_rows.long()
    idx = (3 * free[:, None] + torch.arange(3)).reshape(-1)
    out[idx] = flat[idx]
    if dt is not None:
        dv[idx] = (flat[idx] - flat[idx]) * inv_dt
    count.index_add_(0, idx, torch.ones_like(idx))
    x0 = src[atoms]
    for kk in range(atoms.shape[1]):
        rows = atoms[amask[:, kk], kk]
        idx = (3 * rows[:, None] + torch.arange(3)).reshape(-1)
        out[idx] = clusters[amask[:, kk], kk].reshape(-1)
        if dt is not None:
            dv[idx] = ((clusters[amask[:, kk], kk] - x0[amask[:, kk], kk])
                       * inv_dt).reshape(-1)
        count.index_add_(0, idx, torch.ones_like(idx))
    assert torch.equal(count, torch.ones_like(count)), "a float written " \
        "other than once"
    return out.reshape(n, 3), dv.reshape(n, 3)


def emulate_shake(cons, x_new, x_old, dt, box, periodic):
    """K7's launch in PyTorch: (x, dv, flagged clusters)."""
    dtype = x_new.dtype
    atoms, amask, si, sj, cm, imi, imj, isum2, d2, _ = _fields(cons, dtype)
    m = atoms.shape[0]
    rows = torch.arange(m)
    x0 = x_new[atoms]
    xo = x_old[atoms]
    ro = [min_image(xo[rows, si[:, s]] - xo[rows, sj[:, s]], box, periodic)
          for s in range(si.shape[1])]
    per = torch.tensor(periodic)
    length = torch.tensor(box, dtype=dtype)
    inv = torch.ones(3, dtype=dtype) / length
    invp = torch.where(per, inv, torch.zeros_like(inv))
    thr = torch.where(per, torch.full_like(inv, 0.25),
                      torch.full_like(inv, float("inf")))
    k0, lk = [], []
    bad0 = torch.zeros(m, dtype=torch.bool)
    for s in range(si.shape[1]):
        d = x0[rows, si[:, s]] - x0[rows, sj[:, s]]
        k = torch.where(per, torch.round(d * inv), torch.zeros_like(d))
        k0.append(k)
        lk.append(length * k)
        bad0 |= (k.abs() > 4096.0).any(1)

    def sweeps(hoist):
        xc = x0.clone()
        bad = bad0.clone()
        for _ in range(k78.ITERS):
            for s in range(si.shape[1]):
                i, j = si[:, s], sj[:, s]
                d = xc[rows, i] - xc[rows, j]
                if hoist:
                    rn = d - lk[s]
                    bad |= ((d * invp - k0[s]).abs() > thr).any(1)
                else:
                    rn = min_image(d, box, periodic)
                diff = _dot(rn, rn) - d2[:, s]
                denom = isum2[:, s] * _dot(rn, ro[s])
                lam = diff / torch.where(denom.abs() > 1e-12, denom, 1e-12)
                lam = torch.where(cm[:, s], lam, 0.0)
                corr = lam[:, None] * ro[s]
                xc[rows, i] = xc[rows, i] - imi[:, s, None] * corr
                xc[rows, j] = xc[rows, j] + imj[:, s, None] * corr
        return xc, bad

    xh, bad = sweeps(True)
    xe, _ = sweeps(False)
    xc = torch.where(bad[:, None, None], xe, xh)
    x, dv = _write(cons, atoms, amask, xc, x_new, dt)
    return x, dv, bad


def emulate_rattle(cons, x, v, box, periodic):
    """K8's launch in PyTorch."""
    atoms, amask, si, sj, cm, imi, imj, _, _, isum = _fields(cons, v.dtype)
    rows = torch.arange(atoms.shape[0])
    xc = x[atoms]
    vc = v[atoms]
    r, den = [], []
    for s in range(si.shape[1]):
        rs = min_image(xc[rows, si[:, s]] - xc[rows, sj[:, s]], box, periodic)
        r.append(rs)
        d = isum[:, s] * _dot(rs, rs)
        den.append(torch.where(d > 1e-12, d, 1e-12))
    for _ in range(k78.ITERS):
        for s in range(si.shape[1]):
            i, j = si[:, s], sj[:, s]
            mu = _dot(vc[rows, i] - vc[rows, j], r[s]) / den[s]
            mu = torch.where(cm[:, s], mu, 0.0)
            corr = mu[:, None] * r[s]
            vc[rows, i] = vc[rows, i] - imi[:, s, None] * corr
            vc[rows, j] = vc[rows, j] + imj[:, s, None] * corr
    return _write(cons, atoms, amask, vc, v)[0]


def _check_records(cons, tables):
    atoms, amask, ci, cj, dist2, cmask, invm, _ = tables
    m, k = atoms.shape
    c = ci.shape[1]
    ra, code, bits, sl, isum = unpack(cons.rec, k, c)
    np.testing.assert_array_equal(ra[:, :k].numpy(), atoms)
    np.testing.assert_array_equal(ra[:, k:].numpy(),
                                  np.repeat(atoms[:, :1], 4 - k, 1))
    np.testing.assert_array_equal(
        ((bits[:, None] >> torch.arange(k)) & 1).bool().numpy(), amask)
    sh = 5 * np.arange(c)
    code = code.numpy()[:, None]
    np.testing.assert_array_equal((code >> sh) & 3, ci)
    np.testing.assert_array_equal((code >> (sh + 2)) & 3, cj)
    np.testing.assert_array_equal(((code >> (sh + 4)) & 1).astype(bool),
                                  cmask)
    inv32 = np.asarray(invm, np.float32)
    imi = np.take_along_axis(inv32, ci, 1)
    imj = np.take_along_axis(inv32, cj, 1)
    f = sl.numpy()
    np.testing.assert_array_equal(f[..., 0], imi)
    np.testing.assert_array_equal(f[..., 1], imj)
    np.testing.assert_array_equal(f[..., 2], np.float32(2.0) * (imi + imj))
    np.testing.assert_array_equal(f[..., 3], np.asarray(dist2, np.float32))
    np.testing.assert_array_equal(isum.numpy(), imi + imj)
    # the float32 tables' own values, as the earlier kernel read them
    t32 = _cons(dict(tables=tables, natoms=cons.natoms))
    np.testing.assert_array_equal(f[..., 3], t32.dist2.numpy())
    np.testing.assert_array_equal(
        f[..., 0], torch.gather(t32.invm, 1, t32.ci.long()).numpy())


def _check_cover(cons, natoms):
    """Free rows + valid columns = every atom once; free rows ascending."""
    count = np.zeros(natoms, np.int64)
    free = cons.free_rows.numpy().astype(np.int64)
    np.add.at(count, free, 1)
    np.add.at(count, cons.atoms.numpy()[cons.amask.numpy()], 1)
    assert (count == 1).all()
    assert (np.diff(free) > 0).all()
    # a padding column repeats column 0: it is never a row of its own
    pad = ~cons.amask.numpy()
    assert (cons.atoms.numpy()[pad] ==
            np.broadcast_to(cons.atoms.numpy()[:, :1], pad.shape)[pad]).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_records_round_trip(shape):
    case = shake_case(shape, "interior", seed=1)
    cons = _cons(case, torch.float64)
    _check_records(cons, case["tables"])
    same = len(SHAKE_SHAPES[shape]) == 1
    assert (cons.code >= 0) == same
    assert (cons.code == k78.LINEAR3_CODE) == (shape == "linear3")


def test_records_and_free_rows_at_the_il_cell(il_cell):
    system, md = il_cell
    cons = build_constraints(system, md.shake, dtype=torch.float32,
                             device="cpu")
    m, k = cons.atoms.shape
    assert (m, k, cons.ci.shape[1]) == (320, 3, 3)
    assert cons.code == k78.LINEAR3_CODE
    tables = (cons.atoms.numpy(), cons.amask.numpy(), cons.ci.numpy(),
              cons.cj.numpy(), cons.dist2.double().numpy(),
              cons.cmask.numpy(), cons.invm.double().numpy(),
              np.zeros((0, 2), np.int64))
    _check_records(cons, tables)
    _check_cover(cons, system.natoms)
    assert cons.free_rows.shape[0] == system.natoms - int(cons.amask.sum())
    assert cons.free_rows.shape[0] == 2816


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_free_rows_cover_every_atom_once(shape, kind):
    case = shake_case(shape, kind, seed=2)
    cons = _cons(case)
    _check_cover(cons, case["natoms"])
    assert cons.free_rows.shape[0] > 0


def test_overlapping_clusters_are_refused():
    case = shake_case("shake2", "interior", seed=3)
    atoms = case["tables"][0].copy()
    atoms[1, 1] = atoms[0, 0]
    tables = (atoms,) + case["tables"][1:]
    with pytest.raises(ValueError, match="disjoint"):
        ShakeConstraints(*tables, natoms=case["natoms"], dtype=torch.float32,
                         device="cpu")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_launch_equals_plain(shape, kind, dtype):
    case = shake_case(shape, kind, seed=4)
    cons = _cons(case, dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    kw = dict(box=case["box"], periodic=case["periodic"])
    xn, xo, v = t(case["x_new"]), t(case["x_old"]), t(case["v"])
    x, dv, bad = emulate_shake(cons, xn, xo, 2.0, **kw)
    px, pdv = k78.shake_positions_plain(cons, xn, xo, 2.0, **kw)
    assert torch.equal(x, px) and torch.equal(dv, pdv)
    if kind == "near_tie":
        assert bad[-1] and int(bad.sum()) == 1
    else:
        assert not bad.any()
    pv = k78.rattle_velocities_plain(cons, px, v, **kw)
    assert torch.equal(emulate_rattle(cons, px, v, **kw), pv)


def test_emulated_launch_equals_plain_at_the_il_cell(il_cell):
    """Phase 11's inputs: a drift step with noise, the cation most along x
    moved across the periodic x face."""
    system, md = il_cell
    cons = build_constraints(system, md.shake, dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(11)
    x_old = np.array(system.x0)
    cats = np.flatnonzero(system.groups["bmi"]).reshape(-1, 3)
    dx = x_old[cats[:, 2], 0] - x_old[cats[:, 0], 0]
    dx -= system.box[0] * np.round(dx / system.box[0])
    cat = cats[np.argmax(np.abs(dx))]
    x_old[cat, 0] = (x_old[cat, 0] - x_old[cat[1], 0] + 0.2) % system.box[0]
    v_np = system.v0 + rng.normal(0.0, 0.005, x_old.shape)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    xo, xn = t(x_old), t(x_old + md.dt * v_np)
    v = t(v_np + rng.normal(0.0, 0.005, x_old.shape))
    kw = dict(box=system.box, periodic=system.periodic)
    x, dv, bad = emulate_shake(cons, xn, xo, md.dt, **kw)
    px, pdv = k78.shake_positions_plain(cons, xn, xo, md.dt, **kw)
    assert torch.equal(x, px) and torch.equal(dv, pdv) and not bad.any()
    assert torch.equal(emulate_rattle(cons, px, v, **kw),
                       k78.rattle_velocities_plain(cons, px, v, **kw))
