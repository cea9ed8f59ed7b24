"""Port vs JAX package: the cell-list pair path (``ops/cells.py``,
``pair_path="cell"``), float64 on both sides.

* ``cell_pair_forces`` against JAX ``cells.cell_pair_forces`` on the JAX
  test's 600-atom random box (periodic z and a slab), and on the
  test-size ionic-liquid file (two cells per lateral axis, so the
  duplicate neighbor cells are masked; the cations' special bonds) against
  JAX ``dense_pair_forces``: f to rtol 1e-9 and atol 1e-9 of max|f| (the
  JAX test_cells.py tolerance, scaled: its random pairs reach 1e10
  kcal/mol/A), the energies to rtol 1e-11.  The JAX cell sweep is held to
  its dense sweep only where every axis has 3 cells or more: a duplicate
  neighbor cell's slots keep their charges there (its mask tests the row
  id, not the column's), so its Coulomb terms count twice; the port masks
  them by id, as the dense sweep counts each pair.
* Exclusions per pair inside the sweep (the port) against the JAX
  package's s = 1 sweep plus ``exclusion_correction``, and the port's
  ``exclusion_correction`` against the JAX one, to the same bounds.
* The ``overflow`` flag at a cap below the occupancy, in both packages.
* 3 engine steps on ``pair_path="cell"`` (CONP under EWALD and under
  PPPM on S3, a box four cutoffs wide) against JAX ``build_engine(...,
  pair_path="cell")``, and on the il file with SHAKE against the JAX
  engine's dense path (2 cells per lateral axis, see above): q to 1e-10
  e, f to 1e-7 + 1e-9 max|f| (JAX test_sharded.py's bounds), pe to 1e-10
  relative.
* ``run`` recovering from a forced cell overflow: the run with half the
  cap ends bit for bit where the run with the cap doubled back ends.
* Two CPU runs bit-identical, and the chunked sweep equal to one chunk.
* The sharded step's split in one process: d = 3 slices of the cells
  (two pad cells) swept apart, their slot forces in atom order, summed,
  equal to the whole sweep bit for bit (each atom's force comes from one
  slice), the energies to 1e-13.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.models.system import exclusion_lists as jexcl
from lammps_user_conp2_tpu.ops import cells as jcells
from lammps_user_conp2_tpu.ops.pairs import dense_pair_forces as jdense
from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import cells as tcells
from lammps_user_conp2_tpu_torch.ops.neighbors import _max_cell_occupancy
from lammps_user_conp2_tpu_torch.ops.pairs import (exclusions_tensors,
                                                   make_pair_tables)
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import (CPU64, S3, SOLVE64, il_small, il_small_file,
                         pppm_cell, x_near)

torch.set_num_threads(2)

KW = dict(g_ewald=0.35, qqr2e=332.06371)
F_RTOL = 1e-9        # JAX test_cells.py: rtol 1e-9, atol 1e-9
E_RTOL = 1e-11
Q_TOL = 1e-10        # JAX test_sharded.py: q atol 1e-10
F_ABS, F_REL = 1e-7, 1e-9    # f atol 1e-7, rtol 1e-9 of max|f|


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _random_system(n=600, box=(40.0, 36.0, 52.0), seed=0):
    """The JAX test_cells.py system: random atoms of 3 types, charges,
    20 listed pairs with factor 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)) * np.array(box)
    q = rng.normal(size=n)
    q -= q.mean()
    typ = 1 + rng.integers(0, 3, n)
    eps = np.zeros((4, 4))
    sig = np.zeros((4, 4))
    for i in range(1, 4):
        for j in range(1, 4):
            eps[i, j] = 0.05 * (i + j)
            sig[i, j] = 2.5 + 0.2 * (i + j)
    exi = np.full((n, 2), n, np.int64)
    exv = np.zeros((n, 2))
    for k in range(0, 40, 2):
        exi[k, 0] = k + 1
        exi[k + 1, 0] = k
    return dict(x=x, q=q, typ=typ, eps=eps, sig=sig, excl=(exi, exv),
                box=box, cutoff=8.0)


def _il_system(il_path):
    system, md, _ = il_small(twl, il_path)
    exi, exv = jexcl(system)
    q = system.q0 + 0.01 * np.random.default_rng(2).standard_normal(
        system.natoms)
    return dict(x=system.x0, q=q, typ=system.type, eps=system.lj_eps,
                sig=system.lj_sigma, excl=(np.asarray(exi, np.int64),
                                           np.asarray(exv)),
                box=system.box, cutoff=md.cutoff, periodic=system.periodic,
                box_lo=tuple(system.box_lo))


def _both(c, periodic, cap=None, dense=False):
    """(JAX (f, ev, ec, overflow), port (f, ev, ec, overflow), the port's
    grid); with ``dense`` the JAX side is ``dense_pair_forces`` (overflow
    False)."""
    n = len(c["x"])
    lo = c.get("box_lo", (0.0, 0.0, 0.0))
    jg = jcells.build_cell_grid(c["box"], lo, c["cutoff"], n,
                                periodic=periodic, cap=cap)
    tg = tcells.build_cell_grid(c["box"], lo, c["cutoff"], n,
                                periodic=periodic, cap=cap)
    exi, exv = c["excl"]
    jargs = (jnp.asarray(c["x"]), jnp.asarray(c["q"]), jnp.asarray(c["typ"]),
             jtables(c["eps"], c["sig"], c["typ"]),
             (jnp.asarray(exi), jnp.asarray(exv)))
    if dense:
        j = jdense(*jargs, box=c["box"], periodic=periodic,
                   cutoff=c["cutoff"], **KW) + (False,)
    else:
        j = jcells.cell_pair_forces(jg, *jargs, **KW)
    t = tcells.cell_pair_forces(
        tg, torch.as_tensor(c["x"]), torch.as_tensor(c["q"]),
        torch.as_tensor(c["typ"]), make_pair_tables(c["eps"], c["sig"]),
        exclusions_tensors((exi, exv)), **KW)
    return j, t, tg


def _assert_forces(t, j):
    ft, fj = t[0].numpy(), np.asarray(j[0])
    scale = np.abs(fj).max()
    np.testing.assert_allclose(ft, fj, rtol=F_RTOL, atol=F_RTOL * scale)
    for k in (1, 2):
        assert float(t[k]) == pytest.approx(float(j[k]), rel=E_RTOL)


@pytest.mark.parametrize("case", ["periodic", "slab", "il"])
def test_cell_pair_forces_match_jax(case, il_path):
    if case == "il":
        c = _il_system(il_path)
        periodic = c["periodic"]
    else:
        c = _random_system(seed=0 if case == "periodic" else 3)
        periodic = (True, True, case == "periodic")
    j, t, grid = _both(c, periodic, dense=case == "il")
    assert not bool(j[3]) and not bool(t[3])
    if case == "il":
        # two cells on the lateral axes: the ±1 neighbors repeat
        assert min(grid.ncells[:2]) == 2
        assert not tcells._neighbor_cells(grid)[1].all()
    _assert_forces(t, j)


def test_per_pair_exclusions_match_correction(il_path):
    """The port's factors per pair inside the sweep against the s = 1
    sweep plus ``exclusion_correction`` (the JAX package's convention;
    ``test_cell_pair_forces_match_jax`` holds the JAX cell sweep with it
    on the random box); the port's ``exclusion_correction`` against the
    JAX one."""
    c = _il_system(il_path)
    n = len(c["x"])
    exi, exv = c["excl"]
    grid = tcells.build_cell_grid(c["box"], c["box_lo"], c["cutoff"], n,
                                  periodic=c["periodic"])
    args = (torch.as_tensor(c["x"]), torch.as_tensor(c["q"]),
            torch.as_tensor(c["typ"]), make_pair_tables(c["eps"], c["sig"]))
    per_pair = tcells.cell_pair_forces(grid, *args, exclusions_tensors(
        (exi, exv)), **KW)
    s1 = tcells.cell_pair_forces(grid, *args, None, **KW)
    ckw = dict(box=c["box"], periodic=c["periodic"],
               cutsq=c["cutoff"] ** 2, qqr2e=KW["qqr2e"])
    jd = jcells.exclusion_correction(
        jnp.asarray(c["x"]), jnp.asarray(c["q"]), jnp.asarray(c["typ"]),
        jtables(c["eps"], c["sig"], c["typ"]),
        (jnp.asarray(exi), jnp.asarray(exv)), **ckw)
    td = tcells.exclusion_correction(*args, exclusions_tensors((exi, exv)),
                                     **ckw)
    _assert_forces(td, jd)
    corrected = (s1[0] + td[0], s1[1] + td[1], s1[2] + td[2])
    _assert_forces(per_pair, tuple(np.asarray(v) for v in corrected))
    # the bonded pairs are excluded: the per-pair sweep differs from s = 1
    assert float((per_pair[0] - s1[0]).abs().max()) > 1.0


def test_overflow_flag():
    c = _random_system(n=300)
    j, t, _ = _both(c, (True,) * 3, cap=1)
    assert bool(j[3]) and bool(t[3])
    c = _random_system(n=300)
    j, t, _ = _both(c, (True,) * 3)
    assert not bool(j[3]) and not bool(t[3])


def test_chunked_sweep_equals_one_chunk():
    """The chunks cut only the row cells: each atom's force is the same sum
    whatever the chunk, and the energies agree to rounding."""
    c = _random_system(seed=5)
    grid = tcells.build_cell_grid(c["box"], (0, 0, 0), c["cutoff"], 600,
                                  periodic=(True, True, False))
    args = (grid, torch.as_tensor(c["x"]), torch.as_tensor(c["q"]),
            torch.as_tensor(c["typ"]), make_pair_tables(c["eps"], c["sig"]),
            exclusions_tensors(c["excl"]))
    one = tcells.cell_pair_forces(*args, chunk=grid.total, **KW)
    for chunk in (1, 7):
        got = tcells.cell_pair_forces(*args, chunk=chunk, **KW)
        assert torch.equal(got[0], one[0])
        for k in (1, 2):
            assert float(got[k]) == pytest.approx(float(one[k]), rel=1e-13)


def _cell_engines(case, il_path):
    jpath = "cell"
    if case == "il":
        # two cells per lateral axis: the JAX cell sweep double-counts
        # there (see the module docstring), so the JAX engine is the dense
        js, jmd, jcfg = il_small(jwl, il_path)
        ts, tmd, tcfg = il_small(twl, il_path)
        x0 = None
        jpath = "dense"
    elif case == "PPPM":
        js, jmd, jcfg = pppm_cell(jwl, JK)
        ts, tmd, tcfg = pppm_cell(twl, TK)
        x0 = x_near(ts)
    else:
        js, jmd, jcfg = jwl.synthetic(**S3)
        ts, tmd, tcfg = twl.synthetic(**S3)
        x0 = x_near(ts)
    jmd = dataclasses.replace(jmd, pair_path=jpath)
    tmd = dataclasses.replace(tmd, pair_path="cell")
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    return jeng, teng, x0


@pytest.mark.parametrize("case", ["EWALD", "PPPM", "il"])
def test_engine_cell_steps_match_jax(case, il_path):
    jeng, teng, x0 = _cell_engines(case, il_path)
    assert teng.ncfg is None and teng.cell_grid is not None
    if case != "il":
        assert jeng.cell_grid is not None
        for k in ("ncells", "cap", "cutoff"):
            assert getattr(teng.cell_grid, k) == getattr(jeng.cell_grid, k)
    jst, tst = jeng.init_state(x0=x0), teng.init_state(x0=x0)
    for _ in range(3):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        assert float(np.abs(tst.q.numpy() - np.asarray(jst.q)).max()) <= Q_TOL
        fj = np.asarray(jst.f)
        df = float(np.abs(tst.f.numpy() - fj).max())
        assert df <= F_ABS + F_REL * np.abs(fj).max()
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-10)
    assert abs(float(tst.q[:teng.conp.ne].sum())) < 1e-10


def test_run_recovers_from_cell_overflow():
    """The cap set to half the occupancy (rounded up) overflows: ``run``
    doubles it, rebuilds the derived state and reruns, and ends where the
    run at the doubled cap ends, bit for bit."""
    ts, tmd, tcfg = twl.synthetic(**S3)
    tmd = dataclasses.replace(tmd, pair_path="cell")
    conp = tsetup(ts, tmd, tcfg, **SOLVE64)
    x0 = x_near(ts)
    ref_eng, eng = (tbuild(ts, tmd, conp, **CPU64) for _ in range(2))
    occ = _max_cell_occupancy(eng.cell_grid, np.asarray(x0))
    k = -(-occ // 2)
    assert k < occ
    eng.cell_grid = dataclasses.replace(eng.cell_grid, cap=k)
    ref_eng.cell_grid = dataclasses.replace(ref_eng.cell_grid, cap=2 * k)
    st0 = eng.init_state(x0=x0)
    assert not np.isfinite(float(st0.energy))
    ref, _ = ref_eng.run(ref_eng.init_state(x0=x0), 3, thermo_every=1)
    got, th = eng.run(st0, 3, thermo_every=1)
    assert eng.cell_grid.cap == 2 * k
    assert np.isfinite(float(got.energy))
    for name in ("x", "v", "q", "f", "energy"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.isfinite(th["pe"]).all()


def test_two_cpu_runs_bit_identical():
    ts, tmd, tcfg = twl.synthetic(**S3)
    tmd = dataclasses.replace(tmd, pair_path="cell")
    eng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    x0 = x_near(ts)
    a, _ = eng.run(eng.init_state(x0=x0), 3, thermo_every=0)
    b, _ = eng.run(eng.init_state(x0=x0), 3, thermo_every=0)
    for name in ("x", "v", "q", "f", "energy"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_cell_slices_sum_to_whole():
    c = _random_system(n=500, box=(40.0, 40.0, 35.0), seed=4)
    n = 500
    grid = tcells.build_cell_grid(c["box"], (0, 0, 0), 8.0, n,
                                  periodic=(True, True, False))
    assert grid.total % 3 == 1
    x, q = torch.as_tensor(c["x"]), torch.as_tensor(c["q"])
    typ = torch.as_tensor(c["typ"])
    tables = make_pair_tables(c["eps"], c["sig"])
    excl = exclusions_tensors(c["excl"])
    whole = tcells.cell_pair_forces(grid, x, q, typ, tables, excl, **KW)
    table, xq, pt, _ = tcells.cell_slab_tables(grid, x, q, typ)
    cl = -(-grid.total // 3)
    padc = 3 * cl - grid.total
    xq, pt, nb, uq = tcells.pad_slab_tables(grid, xq, pt, padc, n)
    table = torch.cat([table, table.new_full((padc, grid.cap), n)])
    f = torch.zeros_like(x)
    ev = ec = 0.0
    for r in range(3):
        e1, e2, fs = tcells.sweep_cell_slabs(
            grid, tables, xq, pt, nb, uq, r * cl, cl, n=n,
            excl=tcells.slot_exclusions(table, excl, n), **KW)
        f = f + tcells.slot_forces_to_atoms(table[r * cl:(r + 1) * cl], fs, n)
        ev, ec = ev + float(e1), ec + float(e2)
    assert torch.equal(f, whole[0])
    assert ev == pytest.approx(float(whole[1]), rel=1e-13)
    assert ec == pytest.approx(float(whole[2]), rel=1e-13)
