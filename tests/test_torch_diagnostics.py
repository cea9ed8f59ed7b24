"""Port vs JAX package: the diagnostics (``models/diagnostics.py``).

* ``potential_atom`` on S1 (factored-Ewald cell, the direct Ewald sum),
  S3 (PPPM mesh readout) and the 352-atom ionic-liquid fixture, with the
  Gaussian correction on and off and the slab term on and off, for all
  atoms and for the left electrode; ``group_potential`` of each
  electrode; ``nghosts``: float64, to 1e-10 of the largest |potential|
  (the port sums the pair term over row blocks of the group, the JAX
  package over one dense (N, N) array);
* the physics oracle (tests/test_diagnostics.py's, on S2): after a CONP
  solve the potential within each electrode is constant to 2e-4 V and the
  right electrode sits the applied 1 V above the left to 1e-3 V.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import diagnostics as jd
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import diagnostics as td
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import (CPU64, S1, S2, SOLVE64, charges_with_electrodes,
                         il_small, il_small_file, pppm_cell, x_near)

torch.set_num_threads(2)
TOL = 1e-10


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


@pytest.fixture(scope="module", params=["S1", "S3", "il"])
def cell(request, il_path):
    """(name, system, x, q, JAX solver, port solver) of the cell."""
    name = request.param
    if name == "S1":
        (js, jmd, jcfg), (ts, tmd, tcfg) = jwl.synthetic(**S1), \
            twl.synthetic(**S1)
    elif name == "S3":
        (js, jmd, jcfg), (ts, tmd, tcfg) = pppm_cell(jwl, JK), \
            pppm_cell(twl, TK)
    else:
        (js, jmd, jcfg), (ts, tmd, tcfg) = il_small(jwl, il_path), \
            il_small(twl, il_path)
    x = x_near(ts) if name != "il" else ts.x0
    q = charges_with_electrodes(ts)
    return (name, ts, tmd.cutoff, x, q, jsetup(js, jmd, jcfg),
            tsetup(ts, tmd, tcfg, **SOLVE64))


def _kw(system, cutoff, sol, jax_side, eta, slab):
    kw = dict(box=system.box, periodic=system.periodic, cutoff=cutoff,
              g_ewald=sol.ksp.g_ewald, evscale=system.units().evscale,
              volume=sol.ksp.volume, eta=eta, slabflag=slab)
    arr = jnp.asarray if jax_side else torch.from_numpy
    kw["elecheck"] = arr(system.elecheck)
    if sol.pppm_grid is not None:
        kw["pppm_grid"] = sol.pppm_grid
    else:
        kw["kvecs"] = arr(sol.ksp.kvecs)
        kw["ug"] = arr(sol.ksp.ug)
    return kw


@pytest.mark.parametrize("slab", [True, False], ids=["slab", "noslab"])
@pytest.mark.parametrize("eta", [True, False], ids=["eta", "noeta"])
@pytest.mark.parametrize("group", ["all", "left"])
def test_potential_atom_matches_jax(cell, group, eta, slab):
    name, system, cutoff, x, q, jsol, tsol = cell
    mask = (np.ones(system.natoms, bool) if group == "all"
            else system.ele_left_mask)
    e = tsol.cfg.eta if eta else 0.0
    jp = np.asarray(jd.potential_atom(
        jnp.asarray(x), jnp.asarray(q), group_mask=mask,
        **_kw(system, cutoff, jsol, True, e, slab)))
    tp = td.potential_atom(
        torch.from_numpy(x), torch.from_numpy(q),
        group_mask=torch.from_numpy(mask), block=40,
        **_kw(system, cutoff, tsol, False, e, slab)).numpy()
    assert np.all(tp[~mask] == 0.0)
    assert np.abs(tp - jp).max() <= TOL * np.abs(jp).max()


def test_group_potential_and_nghosts_match_jax(cell):
    name, system, cutoff, x, q, jsol, tsol = cell
    e = tsol.cfg.eta
    for mask in (system.ele_left_mask, system.ele_right_mask):
        jg = float(jd.group_potential(
            jnp.asarray(x), jnp.asarray(q), mask,
            **_kw(system, cutoff, jsol, True, e, True)))
        tg = float(td.group_potential(
            torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(mask),
            **_kw(system, cutoff, tsol, False, e, True)))
        assert tg == pytest.approx(jg, rel=TOL, abs=TOL)
    kw = dict(box=system.box, box_lo=tuple(system.box_lo), cutoff=cutoff,
              periodic=system.periodic)
    np.testing.assert_array_equal(td.nghosts(x, **kw), jd.nghosts(x, **kw))


def test_electrode_potentials_equal_applied_voltage():
    """After a CONP solve on S2 the electrodes are equipotentials 1 V apart
    (README.md:52's sign: the right electrode above the left)."""
    system, md, cfg = twl.synthetic(**S2)
    sol = tsetup(system, md, cfg, **SOLVE64)
    eng = tbuild(system, md, sol, **CPU64)
    st = eng.init_state(x0=x_near(system))
    pot = td.potential_atom(st.x, st.q, group_mask=torch.ones(
        system.natoms, dtype=torch.bool), **td.engine_potential_kw(eng))
    pot = pot.numpy()
    pl = pot[system.ele_left_mask]
    pr = pot[system.ele_right_mask]
    assert pl.std() < 2e-4 and pr.std() < 2e-4
    assert abs(pr.mean() - pl.mean() - cfg.target) < 1e-3
    gl = float(td.group_potential(st.x, st.q, eng.left_mask,
                                  **td.engine_potential_kw(eng)))
    assert gl == pytest.approx(pl.mean(), rel=1e-12)
