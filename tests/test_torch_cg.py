"""Port vs JAX package: the CG and matrix-free CG solvers, float64.

* ``cg_solve`` on a random SPD matrix with a neutral right-hand side (numpy
  seed 3), cold, warm-started and capped by ``maxiter``: the same number of
  iterations as the JAX ``lax.while_loop``, x to 1e-12 relative; the
  blocks of ``CG_BLOCK`` iterations leave a converged carry unchanged.
* ``setup_conp`` under CG and CG_MATFREE on S1 and S2: amat, real_block,
  diag_extra and elesetq to 1e-10 relative, the placeholders as the JAX
  package keeps them, ee_diag NaN.
* ``solve_full`` at ``x_near`` with random electrode charges, CONP, CONQ
  and COND (under FFIELD), CG and CG_MATFREE, from the JAX context loaded
  through ``interop``, warm-started: q to 1e-10 e and the fix scalar to
  1e-10 relative; ``cg_iterations`` against the JAX trace.
* 5 engine steps under CG with the warm start on S1, with a constant
  target and a callable (ramped) target at nevery = 2: q to 1e-10 e of the
  JAX engine and the same CG iterations per solve.
* CG_MATFREE with mobile electrodes at perturbed electrode positions (as
  JAX tests/test_modes.py::test_matfree_mobile_electrodes): the live
  operator matches a re-setup at those positions (rms 1e-7 e at dV = 0),
  and the port matches the JAX solve there to 1e-10 e.
* CG under PPPM with the electrodes spread through the box (the full-mesh
  readout): the solve to 1e-10 e of the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import conp as jconp
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.utils.config import Solver as JS
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import conp as tconp
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils.config import Solver as TS
from torch_cells import (CPU64, S1, S2, SOLVE64, charges_with_electrodes,
                         rel_err, x_near)

torch.set_num_threads(2)


def _spd(n=40, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    a = m @ m.T / n + np.diag(rng.uniform(0.5, 2.0, n))
    b = rng.standard_normal(n)
    return a, b - b.mean(), rng.standard_normal(n) * 0.1


@pytest.mark.parametrize("case", ["cold", "x0", "capped"])
def test_cg_solve_matches(case):
    a, b, x0 = _spd()
    tol, maxiter = (1e-10, 100) if case != "capped" else (1e-10, 5)
    x0 = x0 - x0.mean() if case == "x0" else None
    jx, jit = jconp.cg_solve(jnp.asarray(a), jnp.asarray(b), tol, maxiter,
                             x0=None if x0 is None else jnp.asarray(x0))
    tx, tit = tconp.cg_solve(torch.from_numpy(a), torch.from_numpy(b), tol,
                             maxiter,
                             x0=None if x0 is None else torch.from_numpy(x0))
    assert int(tit) == int(jit)
    if case == "capped":
        assert int(tit) == 5
    else:
        assert 5 < int(tit) < maxiter
    assert rel_err(tx.numpy(), jx) < 1e-12
    # a block after convergence changes nothing
    op = tconp.DenseOperator(torch.from_numpy(a))
    cg = tconp.cg_start(op, torch.from_numpy(b), tol, maxiter,
                        None if x0 is None else torch.from_numpy(x0))
    while bool(cg.active):
        cg = tconp.cg_block(op, cg, tol, maxiter)
    again = tconp.cg_block(op, cg, tol, maxiter)
    for f in dataclasses.fields(cg):
        assert torch.equal(getattr(again, f.name), getattr(cg, f.name))


def _setups(cell, solver, **cfg_kw):
    js, jmd, jcfg = jwl.synthetic(**cell)
    ts, tmd, tcfg = twl.synthetic(**cell)
    jcfg = dataclasses.replace(jcfg, solver=JS[solver], **cfg_kw)
    tcfg = dataclasses.replace(tcfg, solver=TS[solver], **cfg_kw)
    return (js, jmd, jcfg), (ts, tmd, tcfg)


@pytest.mark.parametrize("solver", ["CG", "CG_MATFREE"])
@pytest.mark.parametrize("cell", [S1, S2], ids=["S1", "S2"])
def test_setup_matches(cell, solver):
    (js, jmd, jcfg), (ts, tmd, tcfg) = _setups(cell, solver)
    j = jconp.setup_conp(js, jmd, jcfg)
    t = tconp.setup_conp(ts, tmd, tcfg, **SOLVE64)
    for name in ("amat", "real_block", "diag_extra", "ainv"):
        assert tuple(getattr(t, name).shape) == np.asarray(
            getattr(j.ctx, name)).shape
    if solver == "CG":
        assert rel_err(t.amat.numpy(), j.ctx.amat) < 1e-10
        assert t.fksp is not None
    else:
        assert rel_err(t.real_block.numpy(), j.ctx.real_block) < 1e-10
        assert rel_err(t.diag_extra.numpy(), j.ctx.diag_extra) < 1e-10
    assert rel_err(t.elesetq.numpy(), j.ctx.elesetq) < 1e-10
    assert float(t.totsetq) == pytest.approx(float(j.ctx.totsetq), rel=1e-10)
    assert np.isnan(t.ee_diag) and np.isnan(j.ee_diag)


def _mode_case(wl, mode, solver):
    system, md, cfg = wl.synthetic(**S1)
    Mode, FF, Sv = type(cfg.mode), type(cfg.ff), type(cfg.solver)
    cfg = dataclasses.replace(cfg, mode=Mode[mode], solver=Sv[solver],
                              target=1.0 if mode == "CONP" else 0.05)
    if mode == "COND":
        system = dataclasses.replace(system, periodic=(True, True, True))
        cfg = dataclasses.replace(cfg, ff=FF.FFIELD)
        md = dataclasses.replace(md, slab=None, efield_feedback=True)
    return system, md, cfg


def _jax_ctx(jsol):
    return {k: np.asarray(v) for k, v in jsol.ctx._asdict().items()}


@pytest.mark.parametrize("solver", ["CG", "CG_MATFREE"])
@pytest.mark.parametrize("mode", ["CONP", "CONQ", "COND"])
def test_solve_full_matches(mode, solver):
    js, jmd, jcfg = _mode_case(jwl, mode, solver)
    ts, tmd, tcfg = _mode_case(twl, mode, solver)
    jsol = jconp.setup_conp(js, jmd, jcfg)
    tsol = tconp.setup_conp(ts, tmd, tcfg, **SOLVE64)
    tsol.load_context(interop.context_from_numpy(_jax_ctx(jsol), **CPU64))
    x = x_near(ts)
    q = charges_with_electrodes(ts, seed=5)
    prev = 0.3 * float(jsol.ctx.totsetq) if mode == "CONP" else 0.02
    jq, jscal, _ = jsol.solve_full(jnp.asarray(x), jnp.asarray(q), 4,
                                   scalar_prev=jnp.asarray(prev))
    tq, tscal, _ = tsol.solve_full(
        torch.from_numpy(x), torch.from_numpy(q),
        step=torch.tensor(4), scalar_prev=torch.tensor(prev,
                                                       dtype=torch.float64))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-10)
    assert float(tscal) == pytest.approx(float(jscal), rel=1e-10)
    assert tsol.cg_iterations(torch.from_numpy(x), torch.from_numpy(q)) == \
        jsol.cg_iterations(jnp.asarray(x), jnp.asarray(q))


def _recorded(its):
    """A JAX cg_solve that records its iterations (inside jit too)."""
    real = jconp.cg_solve

    def rec(*a, **k):
        x, it = real(*a, **k)
        jax.debug.callback(lambda v: its.append(int(v)), it)
        return x, it

    return rec


@pytest.mark.parametrize("target", ["constant", "ramp"])
def test_engine_steps_match(target, monkeypatch):
    nevery = 1 if target == "constant" else 2
    kw = dict(nevery=nevery)
    (js, jmd, jcfg), (ts, tmd, tcfg) = _setups(S1, "CG", **kw)
    if target == "ramp":
        jcfg = dataclasses.replace(jcfg, target=lambda s: 0.5 + 0.1 * s)
        tcfg = dataclasses.replace(tcfg, target=lambda s: 0.5 + 0.1 * s)
    jits, tits = [], []
    monkeypatch.setattr(jconp, "cg_solve", _recorded(jits))
    real_end = tconp.ConpSolver.solve_end

    def end(self, pend, *a, **k):
        tits.append(int(pend.cg.it))
        return real_end(self, pend, *a, **k)

    monkeypatch.setattr(tconp.ConpSolver, "solve_end", end)
    jsol = jconp.setup_conp(js, jmd, jcfg)
    tsol = tconp.setup_conp(ts, tmd, tcfg, **SOLVE64)
    tsol.load_context(interop.context_from_numpy(_jax_ctx(jsol), **CPU64))
    jeng = jbuild(js, jmd, jsol)
    teng = tbuild(ts, tmd, tsol, **CPU64)
    x0 = x_near(ts)
    del jits[:]                    # the set-up's elesetq solve
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    assert len(jits) == 1 and len(tits) == 1
    for i in range(5):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-10)
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-10)
    assert tits == jits
    assert len(tits) == 1 + 5 // nevery
    # warm-started solves converge in fewer iterations than the cold one
    assert max(tits[1:]) < tsol.cg_iterations(tst.x, tst.q)


def test_matfree_mobile_electrodes():
    kw = dict(mobile_electrodes=True, cg_tolerance=1e-16, cg_maxiter=400)
    (js, jmd, jcfg), (ts, tmd, tcfg) = _setups(S1, "CG_MATFREE", **kw)
    rng = np.random.default_rng(0)
    x2 = ts.x0.copy()
    x2[ts.ele_mask] += rng.normal(scale=0.05,
                                  size=(int(ts.ele_mask.sum()), 3))
    xt = torch.from_numpy(x2)
    qt = torch.from_numpy(ts.q0)
    step = torch.tensor(0)
    # the live operator against a re-setup at the perturbed positions, at
    # dV = 0 (d and elesetq are frozen at the set-up positions)
    zero = dict(target=0.0)
    live = tconp.setup_conp(ts, tmd, dataclasses.replace(tcfg, **zero),
                            **SOLVE64)
    ref = tconp.setup_conp(ts, tmd, dataclasses.replace(
        tcfg, mobile_electrodes=False, **zero), x0=x2, **SOLVE64)
    q_live, _, _ = live.solve_full(xt, qt, step=step)
    q_ref, _, _ = ref.solve_full(xt, qt, step=step)
    ele = ts.ele_mask
    rmse = float(np.sqrt(np.mean((q_live.numpy()[ele]
                                  - q_ref.numpy()[ele]) ** 2)))
    assert rmse < 1e-7
    # the real-space block follows the electrodes
    pend = live.solve_begin(xt, qt, step=step)
    assert not torch.equal(pend.op.real_block, live.real_block)
    assert rel_err(pend.op.real_block.numpy(), ref.real_block.numpy()) < 1e-12
    # and the port's mobile solve is the JAX package's
    jsol = jconp.setup_conp(js, jmd, jcfg)
    tsol = tconp.setup_conp(ts, tmd, tcfg, **SOLVE64)
    tsol.load_context(interop.context_from_numpy(_jax_ctx(jsol), **CPU64))
    jq, _ = jsol.solve(jnp.asarray(x2), jnp.asarray(ts.q0), 0)
    tq, _, _ = tsol.solve_full(xt, qt, step=step)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-10)


def test_pppm_cg_with_electrodes_through_the_box():
    """CG under PPPM with the electrodes spread through the box (no z-plane
    set: the b readout goes through the full mesh), as the port once
    refused it: the solve matches the JAX package's to 1e-10 e."""
    (js, jmd, jcfg), (ts, tmd, tcfg) = _setups(S1, "CG")
    jcfg = dataclasses.replace(jcfg, kspace=type(jcfg.kspace).PPPM)
    tcfg = dataclasses.replace(tcfg, kspace=type(tcfg.kspace).PPPM)
    x0 = np.array(ts.x0)
    ele = ts.ele_mask
    x0[ele, 2] = np.linspace(1.0, ts.box[2] - 1.0, int(ele.sum()))
    jsol = jconp.setup_conp(js, jmd, jcfg, x0=x0)
    tsol = tconp.setup_conp(ts, tmd, tcfg, x0=x0, **SOLVE64)
    assert tsol.pppm_grid is not None and tsol.ele_zplanes is None
    assert jsol.ele_zplanes is None
    tsol.load_context(interop.context_from_numpy(_jax_ctx(jsol), **CPU64))
    q = charges_with_electrodes(ts, seed=9)
    jq, jscal, _ = jsol.solve_full(jnp.asarray(x0), jnp.asarray(q), 1)
    tq, tscal, _ = tsol.solve_full(torch.from_numpy(x0), torch.from_numpy(q),
                                   step=torch.tensor(1))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-10)
    assert float(tscal) == pytest.approx(float(jscal), rel=1e-10)
