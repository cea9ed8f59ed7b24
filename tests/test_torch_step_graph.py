"""The step in segments and the graph runner that replays them, on the CPU.

* ``Engine.step`` as ``_pre`` -> host test of the skin flag -> ``_rebuild``
  -> ``_post`` equals the step as one function (``step_as_one``, the body
  ``step`` had before it was split) bit for bit over several steps, in
  float64, on S1, S2 and S4 (dense; S4 with PPPM, its exact Ewald sum
  has too many xy vectors), S3 with PPPM on the per-atom and the
  block Verlet list (a 0.05 A skin, so the list and the mesh tiles rebuild
  inside the window), the ionic-liquid fixture with SHAKE/RATTLE, S1
  under CG with a ramped target solving every second step, S3 on the
  block list under CG_MATFREE and S4 under EWALD (the chunked sums); the
  rebuild decision of the flag equals the host test of the one-function
  step at every step.  The one-function step solves with ``solve_full``
  (its CG loop inside) on the ``nevery``-th steps and hands the forces the
  electrolyte's cache on the others.
* ``graphs.StepGraphs``, the runner ``Engine.run`` uses on the card, with
  an eager backend in place of CUDA graphs (each segment runs where a graph
  would be captured and replayed, the launch counters put back after it as
  a replay leaves them): bit for bit the eager ``run``, thermo rows and
  rebuild count included, on the dense and the list paths; a counted
  wrapper counts exactly one launch per replayed step (none from the
  warm-up or the captures), and the list build once per rebuild replayed;
  under CG the solve's graphs H, C and T replay as many CG blocks as the
  eager steps ran, and nevery = 2 replays its skip variant;
  ``run``'s overflow recovery regrows the list capacity, captures anew
  under the new key and matches the ample run; a state whose layout
  changed is refused, naming the segment.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import graphs
from lammps_user_conp2_tpu_torch.models import md as tmd
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.models.system import MDState
from lammps_user_conp2_tpu_torch.ops.kernels import build
from lammps_user_conp2_tpu_torch.ops.neighbors import needs_rebuild
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from lammps_user_conp2_tpu_torch.utils.config import Solver as TS
from torch_cells import (CPU64, S1, S2, S3, S4, SOLVE64, il_small,
                         il_small_file, pppm_cell, x_near)

torch.set_num_threads(2)
NSTEPS = 6


def step_as_one(eng, state):
    """``Engine.step`` as one function, the body it had before the split:
    the reference the segments are held to.  Returns (state, rebuilt)."""
    itg = eng.integrator
    v, xi, vxi = itg.thermostat_half(state.v, state.nhc_xi, state.nhc_vxi)
    v = itg.kick(v, state.f)
    x = itg.drift(state.x, v)
    if eng.cons is not None:
        x, dv = tmd.shake_positions(eng.cons, x, state.x, itg.dt,
                                    box=eng.ksp_force.box,
                                    periodic=eng.system.periodic)
        v = v + dv
    nbr, tasg = state.nbr, state.tasg
    rebuilt = False
    if eng.ncfg is not None:
        if bool(needs_rebuild(eng.ncfg, nbr, x)):
            nbr, tasg = eng.derived_state(x)
            rebuilt = True
            nbr.overflow = nbr.overflow | state.nbr.overflow
    step_t = state.step_t + 1
    q, scalar, kcache = state.q, state.scalar_out, None
    if eng.conp is not None and (state.step + 1) % eng.conp.cfg.nevery == 0:
        q, scalar, kcache = eng.conp.solve_full(
            x, q, nbr, eng.ncfg, tasg, step=step_t,
            scalar_prev=state.scalar_out)
    elif eng.conp is not None:
        kcache = eng.conp.elyte_kcache(x, q, tasg)
    f, pe = eng.compute_forces(x, q, kcache, nbr, tasg, scalar)
    v = itg.kick(v, f)
    if eng.cons is not None:
        v = tmd.rattle_velocities(eng.cons, x, v, box=eng.ksp_force.box,
                                  periodic=eng.system.periodic)
    v, xi, vxi = itg.thermostat_half(v, xi, vxi)
    return MDState(x=x, v=v, q=q, f=f, step=state.step + 1, nhc_xi=xi,
                   nhc_vxi=vxi, scalar_out=scalar, energy=pe, nbr=nbr,
                   tasg=tasg, step_t=step_t), rebuilt


def _tensors(obj, out=None):
    """Every tensor of a state, in field order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def assert_same_bits(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for u, w in zip(ta, tb):
        assert u.dtype == w.dtype and torch.equal(u, w)


def _synthetic(cell, cfg_kw=None, **md_kw):
    system, md, cfg = twl.synthetic(**cell)
    md = dataclasses.replace(md, **md_kw)
    cfg = dataclasses.replace(cfg, **(cfg_kw or {}))
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    return eng, x_near(system)


def _pppm(cell=S3, cfg_kw=None, **md_kw):
    ts, tmd_cfg, tcfg = pppm_cell(twl, TK, cell=cell, **md_kw)
    tcfg = dataclasses.replace(tcfg, **(cfg_kw or {}))
    eng = tbuild(ts, tmd_cfg, tsetup(ts, tmd_cfg, tcfg, **SOLVE64), **CPU64)
    return eng, x_near(ts)


def _pppm_list(pair_path, **cfg_kw):
    return _pppm(pair_path=pair_path, neighbor_skin=0.05, **cfg_kw)


def _cg_nevery():
    """S1 under CG with a ramped target, solving every second step."""
    return _synthetic(S1, cfg_kw=dict(solver=TS.CG, nevery=2,
                                      target=lambda s: 0.5 + 0.1 * s))


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _il(il_path):
    system, md, cfg = il_small(twl, il_path)
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    return eng, None


CELLS = {
    "S1": lambda p: _synthetic(S1),
    "S2": lambda p: _synthetic(S2),
    "S4": lambda p: _pppm(S4),
    "S3-nlist": lambda p: _pppm_list("nlist"),
    "S3-block": lambda p: _pppm_list("block"),
    "il": _il,
    "S1-cg-nevery2": lambda p: _cg_nevery(),
    "S3-block-matfree": lambda p: _pppm_list(
        "block", cfg_kw=dict(solver=TS.CG_MATFREE)),
    "S4-ewald": lambda p: _synthetic(S4),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_segments_equal_step_as_one(cell, il_path):
    eng, x0 = CELLS[cell](il_path)
    st = eng.init_state(x0=x0)
    ref = st
    rebuilds = 0
    for _ in range(NSTEPS):
        ref, rebuilt = step_as_one(eng, ref)
        x, v, xi, vxi, flag = eng._pre(st)
        assert (flag is None) == (eng.ncfg is None)
        assert (flag is not None and bool(flag)) == rebuilt
        r0 = eng.rebuilds
        st = eng.step(st)
        assert eng.rebuilds - r0 == int(rebuilt)
        rebuilds += int(rebuilt)
        assert_same_bits(st, ref)
    if eng.ncfg is not None:
        assert rebuilds >= 1
    assert np.isfinite(float(st.energy))


class EagerBackend:
    """Runs each segment where a CUDA graph would be captured and replayed:
    the warm-up and the capture run it once; a replay runs it and puts the
    launch counters back, as a replayed graph leaves them (the runner adds
    the captured counts itself)."""

    def __init__(self, device=None):
        self.captures = 0

    def warm(self, fn):
        fn()

    def capture(self, fn):
        fn()
        self.captures += 1

        def replay():
            counts = [c.count for c in build.COUNTERS]
            fn()
            for c, n in zip(build.COUNTERS, counts):
                c.count = n

        return replay


@pytest.mark.parametrize("cell", ["S2", "S3-nlist", "S3-block", "il",
                                  "S1-cg-nevery2", "S3-block-matfree"])
def test_runner_equals_eager_run(cell, il_path):
    eng, x0 = CELLS[cell](il_path)
    st0 = eng.init_state(x0=x0)
    r0 = eng.rebuilds
    ref, th_ref = eng.run(st0, NSTEPS, thermo_every=2)
    eager_rebuilds = eng.rebuilds - r0
    runner = graphs.step_graphs(eng, st0, EagerBackend())
    r0 = eng.rebuilds
    got, th = runner.run(st0, NSTEPS, 2)
    assert eng.rebuilds - r0 == eager_rebuilds
    if eng.ncfg is not None:
        assert eager_rebuilds >= 1
    assert got.step == ref.step == st0.step + NSTEPS
    assert_same_bits(got, ref)
    assert list(th) == list(th_ref) and th["step"].tolist() == [2, 4, 6]
    for k in th:
        assert torch.equal(th[k], th_ref[k])
    # a second run from the same state replays the same graphs
    b0 = eng.cg_blocks
    again, _ = runner.run(st0, NSTEPS, 0)
    assert_same_bits(again, ref)
    assert graphs.step_graphs(eng, st0, EagerBackend()) is runner
    if eng.conp.cfg.solver is not TS.INV:
        # the CG blocks replayed: as many as the eager steps ran
        eager = eng.cg_blocks
        eng.run(st0, NSTEPS, thermo_every=0)
        assert eng.cg_blocks - eager == eager - b0 > 0
        assert "cg" in runner.replays
    if eng.conp.cfg.nevery > 1:
        assert "step:skip" in runner.replays


def test_runner_counts_one_launch_per_replay(il_path, monkeypatch):
    """A wrapper's counter reads, after a replayed run, what it reads after
    the eager steps: one count per step for SHAKE, one per rebuild for the
    list build, none from the warm-up and the captures."""
    shake = build.LaunchCounter("test_shake")
    lists = build.LaunchCounter("test_list_build")
    real_shake, real_build = tmd.shake_positions, tmd.build_neighbor_list

    def counted_shake(*a, **k):
        shake.count += 1
        return real_shake(*a, **k)

    def counted_build(*a, **k):
        lists.count += 1
        return real_build(*a, **k)

    monkeypatch.setattr(tmd, "shake_positions", counted_shake)
    monkeypatch.setattr(tmd, "build_neighbor_list", counted_build)
    eng, _ = _il(il_path)
    st0 = eng.init_state()
    shake.reset()
    runner = graphs.step_graphs(eng, st0, EagerBackend())
    assert shake.count == 0
    runner.run(st0, 5, 1)
    assert shake.count == 5
    eng, x0 = _pppm_list("nlist")
    st0 = eng.init_state(x0=x0)
    lists.reset()
    runner = graphs.step_graphs(eng, st0, EagerBackend())
    assert lists.count == 0
    r0 = eng.rebuilds
    runner.run(st0, NSTEPS, 0)
    assert eng.rebuilds - r0 >= 1 and lists.count == eng.rebuilds - r0


def test_run_recaptures_after_capacity_growth(monkeypatch):
    """``run`` through the runner: an undersized K NaN-poisons the run,
    the capacity grows, the next run captures under the new key and the
    result matches the ample-capacity eager run."""
    ts, tmd_cfg, tcfg = pppm_cell(twl, TK, pair_path="nlist")
    x0 = x_near(ts)
    ok = tbuild(ts, tmd_cfg, tsetup(ts, tmd_cfg, tcfg, **SOLVE64), **CPU64)
    f_ok, th_ok = ok.run(ok.init_state(x0=x0), 5, thermo_every=5)
    small = tbuild(ts, dataclasses.replace(tmd_cfg, neighbor_kmax=24),
                   tsetup(ts, tmd_cfg, tcfg, **SOLVE64), **CPU64)
    monkeypatch.setattr(graphs, "replayed", lambda st: True)
    monkeypatch.setattr(graphs, "CudaGraphBackend", EagerBackend)
    st0 = small.init_state(x0=x0)
    f_bad, th_bad = small.run(st0, 5, thermo_every=5)
    assert small.ncfg.k_max > 24 and not bool(f_bad.nbr.overflow)
    keys = list(small._step_graphs)
    assert len(keys) == 2 and keys[0] != keys[1]
    assert keys[0][0][0] == 24 and keys[1][0][0] == small.ncfg.k_max
    np.testing.assert_allclose(f_bad.x.numpy(), f_ok.x.numpy(), atol=1e-10)
    assert float(th_bad["temp"][-1]) == pytest.approx(
        float(th_ok["temp"][-1]), rel=1e-10)


def test_copy_state_refuses_a_changed_layout():
    a = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="'post'"):
        graphs.copy_state(a, torch.zeros(4, dtype=a.dtype), "post")
    with pytest.raises(RuntimeError, match="'load'"):
        graphs.copy_state(a, torch.zeros(3, dtype=torch.float32), "load")
    with pytest.raises(RuntimeError, match="'rebuild'"):
        graphs.copy_state(a, None, "rebuild")
    b = torch.ones(3, dtype=a.dtype)
    graphs.copy_state(a, b, "step")
    assert torch.equal(a, b)
