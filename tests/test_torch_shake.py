"""Port vs JAX package: SHAKE/RATTLE on the test-size ionic-liquid cell
(IL_SMALL, 40 linear 3-site cations), float64 on both sides.

The cluster tables are identical (atoms, columns, masks exact; dist2 and
invm to 1e-15 relative).  The port's plain ``shake_positions`` matches the
JAX XLA path to atol 1e-12 A on x and 1e-12 A/fs on dv, and the JAX Pallas
kernel run in interpret mode (as tests/test_shake.py runs it);
``rattle_velocities`` matches to atol 1e-13.  Both also on a cluster moved
across the periodic x boundary.  On CPU tensors the wrappers take the plain
versions and launch nothing; the entry points refuse to fall back to the
CPU when no device is given and no card is visible."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import shake as jshake
from lammps_user_conp2_tpu.ops.pallas import shake_kernel as jsk
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import shake as tshake
from lammps_user_conp2_tpu_torch.models.conp import setup_conp
from lammps_user_conp2_tpu_torch.models.integrate import make_nhc_params
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.ops.kernels import shake_kernel as tsk
from lammps_user_conp2_tpu_torch.utils.config import ShakeConfig
from torch_cells import il_small, il_small_file

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
IL_SHAKE = ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,))


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    path = il_small_file(tmp_path_factory.mktemp("il"))
    js, jmd, _ = il_small(jwl, path)
    ts, tmd, _ = il_small(twl, path)
    jcons = jshake.build_constraints(js, jmd.shake)
    tcons = tshake.build_constraints(ts, tmd.shake, **F64)
    return js, ts, jcons, tcons


def _inputs(system, seed, straddle):
    """(x_old, x_new, v): x0, a drift of 0.05 A Gaussian noise, velocities
    of 0.01 A/fs noise (numpy default_rng(seed)); with ``straddle`` the
    cation most aligned with x is moved so that its middle site sits 0.2 A
    inside the periodic x face and an end lies across it."""
    rng = np.random.default_rng(seed)
    x_old = np.array(system.x0)
    if straddle:
        cats = np.flatnonzero(system.groups["bmi"]).reshape(-1, 3)
        dx = x_old[cats[:, 2], 0] - x_old[cats[:, 0], 0]
        dx -= system.box[0] * np.round(dx / system.box[0])
        cat = cats[np.argmax(np.abs(dx))]
        x_old[cat, 0] = (x_old[cat, 0] - x_old[cat[1], 0] + 0.2) % system.box[0]
        assert np.ptp(x_old[cat, 0]) > 0.5 * system.box[0]
    x_new = x_old + rng.normal(0.0, 0.05, x_old.shape)
    x_new[system.ele_mask] = x_old[system.ele_mask]
    v = rng.normal(0.0, 0.01, x_old.shape)
    return x_old, x_new, v


def test_constraint_tables_match(cell):
    js, ts, jcons, tcons = cell
    assert tcons.nclusters == jcons.nclusters == 40
    assert tcons.ncons == jcons.ncons == 120
    for name in ("atoms", "amask", "ci", "cj", "cmask"):
        np.testing.assert_array_equal(getattr(tcons, name).numpy(),
                                      np.asarray(getattr(jcons, name)))
    for name in ("dist2", "invm"):
        np.testing.assert_allclose(getattr(tcons, name).numpy(),
                                   np.asarray(getattr(jcons, name)),
                                   rtol=1e-15, atol=0)
    np.testing.assert_array_equal(tcons.pair_atoms, jcons.pair_atoms)
    for group in ("sol", "bmi", "ele"):
        assert tcons.n_in_group(ts.groups[group]) == jcons.n_in_group(
            js.groups[group])
    assert (tcons.atoms.dtype, tcons.dist2.dtype) == (torch.int32,
                                                      torch.float64)


@pytest.mark.parametrize("straddle", [False, True],
                         ids=["interior", "straddles_x"])
def test_shake_matches_jax(cell, straddle):
    js, ts, jcons, tcons = cell
    x_old, x_new, _ = _inputs(ts, 0, straddle)
    kw = dict(box=ts.box, periodic=ts.periodic)
    jx, jdv = jshake.shake_positions(jcons, jnp.asarray(x_new),
                                     jnp.asarray(x_old), 2.0, **kw)
    tx, tdv = tsk.shake_positions_plain(tcons, torch.from_numpy(x_new),
                                        torch.from_numpy(x_old), 2.0, **kw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=0,
                               atol=1e-12)
    px, pdv = jsk.shake_positions_pallas(
        jcons, jnp.asarray(x_new), jnp.asarray(x_old), 2.0, interpret=True,
        **kw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(px), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(pdv), rtol=0,
                               atol=1e-12)
    # only clustered atoms move, and the last slot (the 1-3 distance)
    # holds after the sweeps
    moved = np.any(tx.numpy() != x_new, axis=1)
    assert not moved[~ts.groups["bmi"]].any() and moved[ts.groups["bmi"]].any()
    a = tcons.atoms.long().numpy()
    d = tx.numpy()[a[:, 0]] - tx.numpy()[a[:, 2]]
    d[:, 0] -= ts.box[0] * np.round(d[:, 0] / ts.box[0])
    d[:, 1] -= ts.box[1] * np.round(d[:, 1] / ts.box[1])
    r13 = np.sqrt((d * d).sum(1))
    np.testing.assert_allclose(r13, 1.8 + 2.5, rtol=1e-5)


@pytest.mark.parametrize("straddle", [False, True],
                         ids=["interior", "straddles_x"])
def test_rattle_matches_jax(cell, straddle):
    js, ts, jcons, tcons = cell
    x_old, _, v = _inputs(ts, 1, straddle)
    kw = dict(box=ts.box, periodic=ts.periodic)
    jv = jshake.rattle_velocities(jcons, jnp.asarray(x_old), jnp.asarray(v),
                                  **kw)
    tv = tsk.rattle_velocities_plain(tcons, torch.from_numpy(x_old),
                                     torch.from_numpy(v), **kw)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-13)
    pv = jsk.rattle_velocities_pallas(jcons, jnp.asarray(x_old),
                                      jnp.asarray(v), interpret=True, **kw)
    np.testing.assert_allclose(tv.numpy(), np.asarray(pv), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(tv.numpy()[~ts.groups["bmi"]],
                                  v[~ts.groups["bmi"]])


def test_wrappers_take_plain_on_cpu(cell):
    _, ts, _, tcons = cell
    x_old, x_new, v = (torch.from_numpy(a) for a in _inputs(ts, 2, True))
    kw = dict(box=ts.box, periodic=ts.periodic)
    tsk.shake_launches.reset()
    tsk.rattle_launches.reset()
    x, dv = tsk.shake_positions(tcons, x_new, x_old, 2.0, **kw)
    px, pdv = tsk.shake_positions_plain(tcons, x_new, x_old, 2.0, **kw)
    assert torch.equal(x, px) and torch.equal(dv, pdv)
    assert torch.equal(tsk.rattle_velocities(tcons, x, v, **kw),
                       tsk.rattle_velocities_plain(tcons, x, v, **kw))
    assert (tsk.shake_launches.count, tsk.rattle_launches.count) == (0, 0)
    # the residual helper reads the same minimum image
    assert max(tshake.constraint_residuals(tcons, torch.from_numpy(ts.x0),
                                           **kw)) < 1e-12


def test_constraint_dof(cell):
    """The thermostat and thermo DOF subtract the constraints inside the
    group (3 per cation here), as the JAX engine's do."""
    _, ts, _, tcons = cell
    sol = ts.groups["sol"]
    p = make_nhc_params(sol, 500.0, 500.0, 100.0,
                        nconstraints=tcons.n_in_group(sol), device="cpu")
    assert p.dof == 3 * int(sol.sum()) - 3 - 120


@pytest.mark.parametrize("entry", ["setup_conp", "build_engine",
                                   "build_constraints", "make_nhc_params",
                                   "context_from_numpy", "state_from_numpy"])
def test_entry_points_need_a_card_by_default(cell, entry, monkeypatch):
    """With no device given the entry points run on the card; with no card
    visible they raise instead of running on the CPU."""
    _, ts, _, _ = cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system, md, cfg = twl.synthetic(n_elyte=8, nele_side=2)
    calls = {
        "setup_conp": lambda: setup_conp(system, md, cfg),
        "build_engine": lambda: build_engine(system, md),
        "build_constraints": lambda: tshake.build_constraints(ts, IL_SHAKE),
        "make_nhc_params": lambda: make_nhc_params(system.groups["sol"],
                                                   300.0, 300.0, 100.0),
        "context_from_numpy": lambda: interop.context_from_numpy({}),
        "state_from_numpy": lambda: interop.state_from_numpy({}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        calls[entry]()
