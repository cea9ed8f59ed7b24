"""Port vs JAX package: the decks' charge and field modes on the test-size
ionic-liquid file (IL_SMALL, 352 atoms; the doubled cells 704), float64 on
both sides.

* Every trial of ``cond`` (0-4) and ``zmirror`` (0-3) builds the same
  System, MDConfig, ConpConfig and exclusion tables as the JAX deck
  (test_torch_il.py holds the il decks' trials).
* ``data_io``'s deck transforms and ``workloads._doubled_cell`` give the
  JAX package's arrays bit for bit.
* One trial per il deck runs 20 engine steps against the JAX engine
  (il_onelayer 4: EHGO, FFIELD, PPPM, a callable target; il_twolayer 3:
  the NOSLAB doubled cell): x and q to atol 1e-8, pe to 1e-9 relative, the
  fix scalar to 1e-8 relative, as test_torch_il.py holds trials 0-1
  (``deck_20_steps_match``; test_torch_charge_modes.py runs cond 4 and
  test_torch_zmirror.py zmirror 3 through it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import system as jsystem
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.utils import data_io as jdata_io
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import system as tsystem
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils import data_io as tdata_io
from test_torch_system import _assert_same_system
from torch_cells import CPU64, SOLVE64, il_small, il_small_file

torch.set_num_threads(2)

NSTEPS = 20
# the decks this port opened beside the il decks (whose trials
# test_torch_il.py builds)
OPENED = [("cond", n) for n in range(5)] + [("zmirror", n) for n in range(4)]


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _plain(cfg):
    return {k: getattr(v, "value", v) for k, v in
            dataclasses.asdict(cfg).items()}


def _same_config(t, j):
    """Equal dataclass fields; a callable target is compared at steps."""
    pt, pj = _plain(t), _plain(j)
    tt, jt = pt.pop("target", None), pj.pop("target", None)
    assert pt == pj
    assert callable(tt) == callable(jt)
    if callable(tt):
        for s in (0, 1, 7, 1000):
            assert float(tt(torch.tensor(float(s)))) == float(jt(s))
    else:
        assert tt == jt


@pytest.mark.parametrize("deck,n", OPENED)
def test_deck_builds_as_jax(il_path, deck, n):
    js, jmd, jcfg = getattr(jwl, deck)(n, data_path=il_path)
    ts, tmd, tcfg = getattr(twl, deck)(n, data_path=il_path)
    _assert_same_system(ts, js)
    _same_config(tmd, jmd)
    _same_config(tcfg, jcfg)
    for a, b in zip(tsystem.exclusion_lists(ts), jsystem.exclusion_lists(js)):
        np.testing.assert_array_equal(a, b)
    doubled = (deck == "zmirror" or (deck == "il_onelayer" and n in (5, 6))
               or (deck == "il_twolayer" and n in (3, 4)))
    assert ts.natoms == (704 if doubled else 352)
    assert ts.ele_mask[:int(ts.ele_mask.sum())].all()


@pytest.mark.parametrize("n", [0, 1])
def test_il_trials_0_1_unchanged(il_path, n):
    """The decks' rewrite keeps trials 0 and 1 as they were: the JAX
    package's configuration, CONP slab with EWALD and ETA."""
    ts, tmd, tcfg = twl.il_onelayer(n, data_path=il_path)
    js, jmd, jcfg = jwl.il_onelayer(n, data_path=il_path)
    _assert_same_system(ts, js)
    _same_config(tmd, jmd)
    _same_config(tcfg, jcfg)
    assert tmd.slab == 3.0 and tcfg.kspace.name == "EWALD"


def test_data_io_transforms_match(il_path):
    """replicate_z2, change_box_z_centered, mirror_group_z and set_mol
    give the JAX package's arrays bit for bit."""
    jd = jdata_io.parse_data_file_py(il_path)
    td = tdata_io.parse_data_file(il_path)
    steps = [
        (lambda m, d: m.replicate_z2(d)),
        (lambda m, d: m.change_box_z_centered(d)),
        (lambda m, d: m.mirror_group_z(d, d.x[:, 2] > 0.0, flip_vz=True)),
        (lambda m, d: m.mirror_group_z(d, d.x[:, 2] < 1.0)),
        (lambda m, d: m.set_mol(d, 641 + 642, 641)),
    ]
    for fn in steps:
        jd, td = fn(jdata_io, jd), fn(tdata_io, td)
        for f in dataclasses.fields(jd):
            a, b = getattr(jd, f.name), getattr(td, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert a == b, f.name
    assert td.natoms == 704 and (td.mol == 641).sum() == 2 * 96


@pytest.mark.parametrize("sym,flip", [(True, True), (True, False),
                                      (False, False)])
def test_doubled_cell_matches(il_path, sym, flip):
    jd = jwl._doubled_cell(jdata_io.parse_data_file_py(il_path), 641, 642,
                           sym=sym, flip_vz=flip)
    td = twl._doubled_cell(tdata_io.parse_data_file(il_path), 641, 642,
                           sym=sym, flip_vz=flip)
    for f in dataclasses.fields(jd):
        a, b = getattr(jd, f.name), getattr(td, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("deck,n", [("il_onelayer", 4), ("il_twolayer", 3)])
def test_deck_20_steps_match(il_path, deck, n):
    deck_20_steps_match(il_path, deck, n)


def _engines(il_path, deck, n):
    js, jmd, jcfg = il_small(jwl, il_path, deck, n)
    ts, tmd, tcfg = il_small(twl, il_path, deck, n)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    return jeng, teng


def deck_20_steps_match(il_path, deck, n):
    """20 steps of the deck's trial on both packages, held step by step."""
    jeng, teng = _engines(il_path, deck, n)
    ne = teng.conp.ne
    jst = jeng.init_state()
    tst = teng.init_state()
    assert teng.cons is not None
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                               atol=1e-8)
    for _ in range(NSTEPS):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
        assert float(tst.scalar_out) == pytest.approx(
            float(jst.scalar_out), rel=1e-8, abs=1e-10)
        assert abs(float(tst.q[:ne].sum())) < 1e-8
    assert int(tst.step_t) == tst.step == NSTEPS
    assert not np.array_equal(tst.x.numpy(), teng.system.x0)
