"""Port vs JAX package: the ``dilute`` deck on the file that
``workloads.write_dilute_data`` writes (432 atoms; the doubled cells 864),
float64 on both sides.

* The writer: the deck's counts, types and molecule ids, net neutral, no
  Velocities section, the same file from the same seed; the port's parser
  and the JAX package's Python parser read it alike.
* Every trial 0-5 of the port's ``dilute(n, data_path=...)`` against JAX
  ``workloads.dilute(n, data_path=...)``: the System, MDConfig and
  ConpConfig exactly; the set-up (A^-1, elesetq, totsetq) to 1e-10
  relative; 5 engine steps of x, v, q and pe within test_torch_decks.py's
  bounds (atol 1e-8, pe 1e-9 relative, the fix scalar 1e-8 relative).
* On the port alone, the cross-mode relations of JAX tests/test_modes.py:27-49
  (FFIELD = slab to 1e-5 e; each half of the doubled cells = slab to 1e-5
  e and neutral to 1e-9 e) and the A-matrix properties of JAX
  tests/test_conp_dilute.py:32-52 (symmetric, positive definite, the
  projected inverse annihilating the uniform vector).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.utils import data_io as jdata_io
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.electrodes import assemble_amatrix
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils import data_io as tdata_io
from test_torch_decks import _same_config
from test_torch_system import _assert_same_system
from torch_cells import CPU64, SOLVE64

torch.set_num_threads(2)

NSTEPS = 5
TRIALS = range(6)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def dilute_path(tmp_path_factory):
    return twl.write_dilute_data(tmp_path_factory.mktemp("dilute") / "data")


_SOLVED = {}


def _solved(path, n):
    """(port system, port solver, JAX system, JAX solver) of trial n."""
    if n not in _SOLVED:
        ts, tmd, tcfg = twl.dilute(n, data_path=path)
        js, jmd, jcfg = jwl.dilute(n, data_path=path)
        _SOLVED[n] = (ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64),
                      js, jmd, jsetup(js, jmd, jcfg))
    return _SOLVED[n]


def test_written_file(dilute_path, tmp_path):
    d = tdata_io.parse_data_file(dilute_path)
    assert d.natoms == 432 and d.natomtypes == 4
    assert len(d.bonds) == 0 and len(d.angles) == 0
    ele = d.type == 3
    assert (d.mol[ele & (d.mol == 81)].size, d.mol[ele & (d.mol == 82)].size) \
        == (180, 180)
    assert set(d.mol[ele]) == {81, 82}
    ely = d.mol[~ele]
    assert sorted(ely) == list(range(1, 73))       # one molecule each
    assert set(d.type[~ele]) == {1, 2, 4}
    assert abs(d.q.sum()) < 1e-12 and np.abs(d.q).sum() == 12.0
    assert np.all(d.mass_by_type[1:] > 0)
    assert np.all(d.pair_coeffs[1:] > 0) and d.pair_coeffs_ij is None
    text = open(dilute_path).read()
    assert "Velocities" not in text and not d.v.any()
    # the electrolyte between the walls, no two atoms closer than 4.5 A
    z = d.x[:, 2]
    assert z[~ele].min() > z[d.mol == 81].max() + 3.0
    assert z[~ele].max() < z[d.mol == 82].min() - 3.0
    box = np.asarray(d.box)
    dx = d.x[:, None] - d.x[None]
    dx[..., :2] -= box[:2] * np.round(dx[..., :2] / box[:2])
    r = np.sqrt((dx ** 2).sum(-1)) + 1e9 * np.eye(d.natoms)
    assert r[~ele][:, ~ele].min() > 4.5
    # the same seed writes the same file, another seed another
    again = twl.write_dilute_data(tmp_path / "again")
    other = twl.write_dilute_data(tmp_path / "other", seed=1)
    assert open(again).read() == text
    assert open(other).read() != text
    # the JAX package's Python parser reads it alike
    j = jdata_io.parse_data_file_py(str(dilute_path))
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(d, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


def test_trials_out_of_range(dilute_path):
    with pytest.raises(ValueError, match="trials 0-5"):
        twl.dilute(6, data_path=dilute_path)


@pytest.mark.parametrize("n", TRIALS)
def test_dilute_builds_and_sets_up_as_jax(dilute_path, n):
    ts, tmd, t, js, jmd, j = _solved(dilute_path, n)
    _, _, tcfg = twl.dilute(n, data_path=dilute_path)
    _, _, jcfg = jwl.dilute(n, data_path=dilute_path)
    _assert_same_system(ts, js)
    _same_config(tmd, jmd)
    _same_config(tcfg, jcfg)
    assert ts.natoms == (864 if n in (3, 4) else 432)
    assert ts.ele_mask[:int(ts.ele_mask.sum())].all()
    assert t.ksp.g_ewald == pytest.approx(j.ksp.g_ewald, rel=1e-14)
    assert rel_err(t.ainv.numpy(), j.ctx.ainv) < 1e-10
    assert rel_err(t.elesetq.numpy(), j.ctx.elesetq) < 1e-10
    assert float(t.totsetq) == pytest.approx(float(j.ctx.totsetq), rel=1e-10)


@pytest.mark.parametrize("n", TRIALS)
def test_dilute_5_steps_match_jax(dilute_path, n):
    ts, tmd, t, js, jmd, j = _solved(dilute_path, n)
    teng = tbuild(ts, tmd, t, **CPU64)
    jeng = jbuild(js, jmd, j)
    ne = t.ne
    tst, jst = teng.init_state(), jeng.init_state()
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                               atol=1e-8)
    for _ in range(NSTEPS):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        for k in ("x", "v", "q"):
            np.testing.assert_allclose(getattr(tst, k).numpy(),
                                       np.asarray(getattr(jst, k)), rtol=0,
                                       atol=1e-8, err_msg=k)
        assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
        assert float(tst.scalar_out) == pytest.approx(
            float(jst.scalar_out), rel=1e-8, abs=1e-10)
        assert abs(float(tst.q[:ne].sum())) < 1e-8
    assert tst.step == NSTEPS
    assert not np.array_equal(tst.x.numpy(), ts.x0)


def _charges(path, n):
    """(system, electrode charges at x0 solved by the port)."""
    ts, _, t, *_ = _solved(path, n)
    q, _, _ = t.solve_full(torch.as_tensor(ts.x0), torch.as_tensor(ts.q0),
                           step=torch.zeros((), dtype=torch.int64))
    return ts, q.numpy()


def test_ffield_matches_slab(dilute_path):
    s0, q0 = _charges(dilute_path, 0)
    s2, q2 = _charges(dilute_path, 2)
    slab = q0[s0.ele_left_mask].sum()
    assert abs(q2[s2.ele_left_mask].sum() - slab) < 1e-5
    assert abs(slab) > 1e-3


@pytest.mark.parametrize("n", [3, 4])
def test_doubled_halves_match_slab(dilute_path, n):
    s0, q0 = _charges(dilute_path, 0)
    slab = q0[s0.ele_left_mask].sum()
    s, q = _charges(dilute_path, n)
    pos = s.x0[:, 2] > 0
    # trial 3 (sym): both halves; trial 4 (anti): the unmodified lower half
    for half in ((pos, ~pos) if n == 3 else (~pos,)):
        ql = q[s.ele_left_mask & half].sum()
        qr = q[s.ele_right_mask & half].sum()
        assert abs(ql - slab) < 1e-5
        assert abs(ql + qr) < 1e-9


def test_amatrix_properties(dilute_path):
    ts, _, t, *_ = _solved(dilute_path, 0)
    ele = np.asarray(t.ele_idx)
    a = assemble_amatrix(ts.x0[ele], ts.type[ele], t.kernels.self_diag[ele],
                         t.ksp, t.kernels, box=ts.box, periodic=ts.periodic,
                         cut_coulsq=t.cut_coulsq).numpy()
    np.testing.assert_allclose(a, a.T, atol=1e-12)
    assert np.linalg.eigvalsh(a).min() > 0
    ainv = t.ainv.numpy()
    assert np.abs(ainv @ np.ones(len(a))).max() < 1e-10
    assert abs(ainv.sum(axis=1).sum()) < 1e-10
