"""The bonded forces' fixed-order sum, on the CPU in float64.

``ops/bonded.bonded_forces`` sums each atom's bond and angle terms through
``term_table`` (the terms of each atom in term order, padded with a zero
row) instead of an ``index_add``, which on the card adds with atomics in an
order that changes from run to run.  Here the sum is held to the
``index_add`` of the same terms (1e-12 relative) and to the JAX package's
``bonded_forces`` (1e-12, as ``test_torch_system.test_bonded_forces_match``)
on a hub atom in many terms, atoms in no term, bonds only, angles only and
the ionic-liquid topology of ``write_il_data`` (IL_SMALL); the table lists
every term once, in order; the engine builds it once per topology and
passes it on every step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu.ops.bonded import bonded_forces as jbonded
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.ops import bonded as B
from torch_cells import il_small, il_small_file

BOX = (12.0, 13.0, 14.0)
PERIODIC = (True, True, False)
BOND_COEFFS = np.array([[310.0, 1.2], [95.0, 1.5]])
ANGLE_COEFFS = np.array([[45.0, 109.5], [60.0, 180.0]])


def _hub(rng):
    """Atom 0 bonded to atoms 1-8 and the centre of an angle with every
    pair of them; atoms 9-11 in no term."""
    bonds = [[k % 2, 0, k] for k in range(1, 9)]
    angles = [[(i + k) % 2, i, 0, k] for i in range(1, 9)
              for k in range(i + 1, 9)]
    return 12, bonds, angles


def _bonds_only(rng):
    n = 10
    bonds = [[int(rng.integers(2)), i, (i + 1 + int(rng.integers(3))) % n]
             for i in range(n)]
    return n, bonds, []


def _angles_only(rng):
    angles = [[0, 0, 1, 2], [1, 3, 1, 4], [0, 2, 1, 4], [1, 5, 6, 7]]
    return 9, [], angles


def _topology(name, rng):
    n, bonds, angles = {"hub": _hub, "bonds_only": _bonds_only,
                        "angles_only": _angles_only}[name](rng)
    x = rng.uniform(0.0, 1.0, (n, 3)) * np.array(BOX)
    # partners of each term 1-2 A apart, some across the periodic x face
    for t in bonds + angles:
        for a in t[2:] if len(t) == 3 else (t[1], t[3]):
            centre = t[1] if len(t) == 3 else t[2]
            x[a] = x[centre] + rng.uniform(-1.5, 1.5, 3)
    x[:, 0] %= BOX[0]
    return (x, np.asarray(bonds, np.int64).reshape(-1, 3),
            np.asarray(angles, np.int64).reshape(-1, 4), BOND_COEFFS,
            ANGLE_COEFFS, dict(box=BOX, periodic=PERIODIC))


@pytest.fixture(scope="module")
def il_case(tmp_path_factory):
    path = il_small_file(tmp_path_factory.mktemp("il"))
    system, _, _ = il_small(twl, path)
    rng = np.random.default_rng(5)
    x = system.x0 + 0.05 * rng.standard_normal(system.x0.shape)
    return (x, system.bonds, system.angles, system.bond_coeffs,
            system.angle_coeffs, dict(box=tuple(system.box),
                                      periodic=tuple(system.periodic)))


def _case(name, il_case):
    if name == "il_small":
        return il_case
    return _topology(name, np.random.default_rng(len(name)))


def _torch(case):
    x, bonds, angles, bc, ac, kw = case
    return (torch.from_numpy(np.asarray(x, np.float64)),
            torch.from_numpy(bonds), torch.from_numpy(np.asarray(bc, float)),
            torch.from_numpy(angles), torch.from_numpy(np.asarray(ac, float)),
            kw)


CASES = ["hub", "bonds_only", "angles_only", "il_small"]


@pytest.mark.parametrize("name", CASES)
def test_fixed_order_sum_matches_index_add(name, il_case):
    x, bonds, bc, angles, ac, kw = _torch(_case(name, il_case))
    f, e = B.bonded_forces(x, bonds, bc, angles, ac, **kw)
    vals, e_terms = B.bonded_terms(x, bonds, bc, angles, ac, **kw)
    ref = torch.zeros_like(x).index_add(0, B.term_rows(bonds, angles), vals)
    scale = float(ref.abs().max())
    assert scale > 0.0 and float(e) == float(e_terms) > 0.0
    assert float((f - ref).abs().max()) <= 1e-12 * scale
    # Newton's third law per term: the forces sum to zero
    assert float(f.sum(0).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("name", CASES)
def test_fixed_order_sum_matches_jax(name, il_case):
    case = _case(name, il_case)
    x, bonds, bc, angles, ac, kw = _torch(case)
    tf, te = B.bonded_forces(x, bonds, bc, angles, ac, **kw)
    xs, bs, ags, bcs, acs, _ = case
    jf, je = jbonded(*(jnp.asarray(np.asarray(a))
                       for a in (xs, bs, bcs, ags, acs)), **kw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-12)
    assert float(te) == pytest.approx(float(je), rel=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_term_table_lists_every_term_once_in_order(name, il_case):
    x, bonds, _, angles, _, _ = _torch(_case(name, il_case))
    n = x.shape[0]
    rows = B.term_rows(bonds, angles)
    m = rows.numel()
    table = B.term_table(bonds, angles, n)
    counts = np.bincount(rows.numpy(), minlength=n)
    assert table.dtype == torch.int64
    assert table.shape == (n, max(counts.max(), 1))
    listed = table[table < m]
    assert sorted(listed.tolist()) == list(range(m))
    for a in range(n):
        mine = table[a][table[a] < m].tolist()
        assert mine == np.flatnonzero(rows.numpy() == a).tolist()
        assert (table[a, len(mine):] == m).all()
    if name == "hub":
        assert counts[0] == 8 + 28 and (counts[9:] == 0).all()
        assert (table[9:] == m).all()


def test_no_terms_gives_zero_forces():
    x = torch.randn(4, 3, dtype=torch.float64)
    none = torch.zeros((0, 3), dtype=torch.int64)
    f, e = B.bonded_forces(x, none, torch.from_numpy(BOND_COEFFS),
                           torch.zeros((0, 4), dtype=torch.int64),
                           torch.from_numpy(ANGLE_COEFFS), box=BOX,
                           periodic=PERIODIC)
    assert not f.any() and float(e) == 0.0
    assert B.term_table(none, torch.zeros((0, 4), dtype=torch.int64),
                        4).tolist() == [[0]] * 4


def test_engine_builds_the_table_once(il_case, tmp_path, monkeypatch):
    """The engine builds the table when it is built and passes it to every
    step: ``bonded_forces`` never builds one itself."""
    from lammps_user_conp2_tpu_torch.models import md as tmd
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    built = []
    real = B.term_table

    def counted(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tmd, "term_table", counted)
    monkeypatch.setattr(B, "term_table", counted)
    system, md, cfg = il_small(twl, il_small_file(tmp_path))
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                      device="cpu")
    eng = tmd.build_engine(system, md, conp, dtype=torch.float64,
                           device="cpu")
    assert len(built) == 1
    ref = real(system.bonds, system.angles, system.natoms)
    assert torch.equal(eng.bonded_tab, ref)
    st = eng.init_state()
    for _ in range(3):
        st = eng.step(st)
    assert len(built) == 1 and np.isfinite(float(st.energy))
