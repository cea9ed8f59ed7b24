"""Port vs JAX package: the ionic-liquid deck path on the test-size cell
(IL_SMALL), float64 on both sides.

* The data-file parser gives identical LammpsData fields (the JAX package's
  Python parser vs the port's).
* ``il_onelayer`` and ``il_twolayer``, trials 0 and 1, build identical
  Systems, MDConfigs, ConpConfigs and exclusion tables from the file, and
  so do the other trials (CONQ, FFIELD, EHGO with a callable target, the
  NOSLAB doubled cell; test_torch_decks.py runs them).
* 20 engine steps with SHAKE/RATTLE (setup_conp -> build_engine ->
  init_state -> step): x to atol 1e-8 A, q to atol 1e-8 e, pe to 1e-9
  relative, thermo temp/tempsl (with the constraint DOF) to 1e-8
  relative, sum q_ele < 1e-10, as test_torch_engine.py holds the
  synthetic cell.
* The full-size file has the decks' counts (3,776 atoms, Ne = 2,496, 320
  clusters of 3 atoms and 3 constraints) and satisfies its constraints.
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
from lammps_user_conp2_tpu_torch.models.shake import (build_constraints,
                                                      constraint_residuals)
from lammps_user_conp2_tpu_torch.utils import data_io as tdata_io
from test_torch_decks import _same_config
from test_torch_system import _assert_same_system
from torch_cells import il_small, il_small_file

torch.set_num_threads(2)

NSTEPS = 20
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def test_parser_matches(il_path):
    j = jdata_io.parse_data_file_py(il_path)
    t = tdata_io.parse_data_file(il_path)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name
    assert t.pair_coeffs_ij is not None and t.natoms == 352
    assert len(t.bonds) == 80 and len(t.angles) == 40


def test_parser_refuses_dihedrals(tmp_path, il_path):
    """Dihedrals with entries raise, as in the JAX parser; an empty
    Dihedral Coeffs section is skipped."""
    text = open(il_path).read().replace("1 angle types\n",
                                        "1 angle types\n1 dihedrals\n")
    bad = tmp_path / "bad.data"
    bad.write_text(text + "\nDihedral Coeffs\n\nDihedrals\n\n1 1 1 2 3 4\n")
    for parse in (tdata_io.parse_data_file, jdata_io.parse_data_file_py):
        with pytest.raises(ValueError, match="Dihedrals present"):
            parse(str(bad))


def _plain(cfg):
    return {k: getattr(v, "value", v) for k, v in
            dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("deck,n", [("il_onelayer", 0), ("il_onelayer", 1),
                                    ("il_twolayer", 0), ("il_twolayer", 1)])
def test_il_system_matches(il_path, deck, n):
    js, jmd, jcfg = getattr(jwl, deck)(n, data_path=il_path)
    ts, tmd, tcfg = getattr(twl, deck)(n, data_path=il_path)
    _assert_same_system(ts, js)
    assert _plain(tmd) == _plain(jmd)
    assert _plain(tcfg) == _plain(jcfg)
    for a, b in zip(tsystem.exclusion_lists(ts), jsystem.exclusion_lists(js)):
        np.testing.assert_array_equal(a, b)
    assert ts.ele_mask[:192].all() and not ts.ele_mask[192:].any()
    assert tmd.shake.group == "bmi" and tmd.dt == 2.0 and tmd.cutoff == 16.0


@pytest.mark.parametrize("deck,n,part", [
    ("il_onelayer", 2, "CONQ"), ("il_onelayer", 3, "FFIELD"),
    ("il_onelayer", 4, "EHGO"), ("il_onelayer", 5, "NOSLAB"),
    ("il_onelayer", 6, "NOSLAB"), ("il_onelayer", 7, "FFIELD"),
    ("il_twolayer", 2, "FFIELD"), ("il_twolayer", 3, "NOSLAB"),
    ("il_twolayer", 4, "NOSLAB"), ("il_twolayer", 5, "FFIELD")])
def test_il_trial_builds_as_jax_deck(il_path, deck, n, part):
    """The trials the port once refused build what the JAX deck builds:
    the same System (the doubled cell's 704 atoms for NOSLAB), exclusion
    tables and configurations, the part each needs among them; a callable
    target is compared at several steps."""
    js, jmd, jcfg = getattr(jwl, deck)(n, data_path=il_path)
    ts, tmd, tcfg = getattr(twl, deck)(n, data_path=il_path)
    _assert_same_system(ts, js)
    for a, b in zip(tsystem.exclusion_lists(ts), jsystem.exclusion_lists(js)):
        np.testing.assert_array_equal(a, b)
    _same_config(tmd, jmd)
    _same_config(tcfg, jcfg)
    has = {"CONQ": tcfg.mode.name == "CONQ", "FFIELD": tcfg.ff.name
           == "FFIELD" and tmd.efield is not None,
           "EHGO": tcfg.pairmode.name == "EHGO" and callable(tcfg.target),
           "NOSLAB": tcfg.ff.name == "NOSLAB" and ts.natoms == 704
           and len(tmd.thermostats) == 2}
    assert has[part]


@pytest.fixture(scope="module")
def engines(il_path):
    js, jmd, jcfg = il_small(jwl, il_path)
    ts, tmd, tcfg = il_small(twl, il_path)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, solve_dtype=torch.float64,
                                  device="cpu"), **F64)
    return jeng, teng


def test_il_engine_20_steps_match(engines):
    jeng, teng = engines
    ne = teng.conp.ne
    jst = jeng.init_state()
    tst = teng.init_state()
    assert teng.cons is not None and teng.ncfg is None
    for i in range(NSTEPS):
        jst, jth = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        tth = teng.thermo(tst)
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-9)
        for key in ("temp", "tempsl"):
            assert float(tth[key]) == pytest.approx(
                float(np.asarray(jth[key])[0]), rel=1e-8)
        assert abs(float(tst.q[:ne].sum())) < 1e-10
    # the electrodes hold opposite charges under the 2 V step, and the
    # constrained cations moved
    assert float(tth["qleft"]) > 1e-3 > -1e-3 > float(tth["qright"])
    assert not np.array_equal(tst.x.numpy(), teng.system.x0)
    # the 180-degree angle makes the 1-3 distance degenerate with the two
    # bonds: the 12 sweeps hold the last slot (the 1-3 distance) but leave
    # the bonds of a bent rotor long, in both packages alike
    # (test_torch_shake_residual.py follows it over 800 steps)
    kw = dict(box=teng.system.box, periodic=teng.system.periodic)
    res = constraint_residuals(teng.cons, tst.x, **kw)
    jres = constraint_residuals(teng.cons, torch.tensor(np.asarray(jst.x)),
                                **kw)
    np.testing.assert_allclose(res, jres, rtol=1e-6)
    assert res[2] < 1e-6 and 1e-4 < max(res) < 1e-2


def test_list_path_refuses_float32_exclusions(il_path):
    """The refusal this test held is lifted: the Verlet-list sweeps apply
    the special-bond exclusions per pair (no s = 1 sweep and subtraction,
    which cancelled in float32 at bonded distances), so a float32 list
    engine with bonds is built on both list paths, and its first forces
    agree with the float64 engine's to 1e-4 of the largest."""
    ts, tmd, tcfg = il_small(twl, il_path)
    for path in ("nlist", "block"):
        md = dataclasses.replace(tmd, pair_path=path)
        out = {}
        for dt in (torch.float32, torch.float64):
            eng = tbuild(ts, md, tsetup(ts, md, tcfg, solve_dtype=dt,
                                        device="cpu"), dtype=dt, device="cpu")
            assert eng.ncfg is not None and eng.exclusions is not None
            out[dt] = eng.init_state().f.double()
        ref = out[torch.float64]
        err = float((out[torch.float32] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), path


def test_full_size_il_file(tmp_path):
    """The default fixture has the il decks' counts and cluster shape; its
    cations satisfy the three constraints at x0."""
    path = twl.write_il_data(tmp_path / "il.data")
    system, md, cfg = twl.il_onelayer(0, data_path=path)
    assert system.natoms == 3776 and int(system.ele_mask.sum()) == 2496
    assert system.box[:2] == pytest.approx((31.98, 34.08), rel=1e-12)
    cons = build_constraints(system, md.shake, **F64)
    assert (cons.nclusters, cons.ncons) == (320, 960)
    assert tuple(cons.atoms.shape) == (320, 3) and cons.ci.shape[1] == 3
    assert max(constraint_residuals(cons, torch.from_numpy(system.x0),
                                    box=system.box,
                                    periodic=system.periodic)) < 1e-12
    # ions at least 3 A from the inner sheets, the liquid at ~1.3 g/cm^3
    z = system.x0[:, 2]
    ele_z = np.unique(np.round(z[system.ele_mask], 6))
    inner = ele_z[[2, 3]]
    ion = ~system.ele_mask
    assert z[ion].min() > inner[0] + 1.5 and z[ion].max() < inner[1] - 1.5
    mass = system.mass[ion].sum() / 6.02214076e23
    vol = system.box[0] * system.box[1] * (inner[1] - inner[0] - 3.4) * 1e-24
    assert mass / vol == pytest.approx(1.3, rel=1e-6)
    v = system.v0
    assert np.all(v[system.ele_mask] == 0.0) and np.any(v[ion] != 0.0)
