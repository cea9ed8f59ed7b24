"""The port's tracer (``utils/timers``) on the CPU.

* ``cli.build`` and ``init_state`` on the dilute deck record the set-up
  span tree: ``setup.deck``, ``setup.conp`` with ``setup.conp.matrix`` and
  ``setup.conp.inverse``, ``setup.engine``, ``setup.init_state``, each
  child inside its parent (INV and CG);
* outside ``tracing`` a run records no span and no count, eager and on the
  graph runner (an eager backend in place of CUDA graphs), and steps the
  same bits as under it;
* under ``tracing`` a list-path cell counts one rebuild-flag read per step,
  eager and on the graph runner; the graph runner keys its graphs by the
  flag and records ``steploop.run`` and a ``steploop.launch`` per replay;
  ``step_loop`` reads the launches, the loop's own time and the reads per
  step (the end-of-run energy and the thermo columns);
* a span inside a running ``torch.profiler`` is in its events;
* ``cli run --log`` prints the set-up spans before the timing flush.
"""

import argparse

import pytest
import torch

from lammps_user_conp2_tpu_torch import cli
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import graphs
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils import timers
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import CPU64, SOLVE64, EagerBackend, pppm_cell, x_near

torch.set_num_threads(2)
SETUP = ["setup.deck", "setup.conp", "setup.engine", "setup.init_state"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    timers.reset()
    yield
    timers.reset()


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    twl.write_dilute_data(d / "dilute" / "data")
    return d


def _dilute(ref_dir, monkeypatch, solver=None):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    args = argparse.Namespace(workload="dilute", trial=0, cpu=True, f32=False,
                              solver=solver, pair_path=None, kmax=None)
    return cli.build(args)[1]


def _list_cell():
    """S3 on the per-atom Verlet list with a 0.05 A skin and PPPM."""
    ts, md, cfg = pppm_cell(twl, TK, pair_path="nlist", neighbor_skin=0.05)
    eng = tbuild(ts, md, tsetup(ts, md, cfg, **SOLVE64), **CPU64)
    return eng, dict(x0=x_near(ts))


def _graph_runner(monkeypatch):
    monkeypatch.setattr(graphs, "replayed", lambda state: True)
    monkeypatch.setattr(graphs, "CudaGraphBackend", EagerBackend)


@pytest.mark.parametrize("solver,inverses", [(None, 2), ("cg", 1)])
def test_setup_span_tree(ref_dir, monkeypatch, solver, inverses):
    eng = _dilute(ref_dir, monkeypatch, solver)
    eng.init_state()
    rec = timers.spans()
    top = [s["name"] for s in rec if s["parent"] is None]
    assert top == SETUP
    conp = [i for i, s in enumerate(rec) if s["name"] == "setup.conp"]
    assert len(conp) == 1
    kids = [s["name"] for s in rec if s["parent"] == conp[0]]
    assert kids == ["setup.conp.matrix"] + ["setup.conp.inverse"] * inverses
    for s in rec:
        assert s["end_ns"] is not None and s["end_ns"] >= s["start_ns"]
        if s["parent"] is not None:
            p = rec[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p[
                "end_ns"]
    assert timers.counters() == {}


@pytest.mark.parametrize("runner", ["eager", "graphs"])
def test_run_outside_tracing_records_nothing(ref_dir, monkeypatch, runner):
    eng = _dilute(ref_dir, monkeypatch)
    st0 = eng.init_state()
    if runner == "graphs":
        _graph_runner(monkeypatch)
    timers.reset()
    off, th = eng.run(st0, 3, thermo_every=1)
    cli.thermo_rows(th)
    assert timers.spans() == [] and timers.counters() == {}
    with timers.tracing():
        on, _ = eng.run(st0, 3, thermo_every=1)
    assert torch.equal(off.x, on.x) and torch.equal(off.q, on.q)
    assert len(timers.spans()) > 0
    assert len(eng._step_graphs) == (2 if runner == "graphs" else 0)
    # the marks flag keys the graphs, the spans flag does not
    with timers.tracing(marks=False):
        eng.run(st0, 1, thermo_every=0)
    assert len(eng._step_graphs) == (2 if runner == "graphs" else 0)


@pytest.mark.parametrize("runner", ["eager", "graphs"])
def test_list_path_counts_one_flag_read_per_step(monkeypatch, runner):
    eng, kw = _list_cell()
    st0 = eng.init_state(**kw)
    if runner == "graphs":
        _graph_runner(monkeypatch)
    nsteps = 4
    timers.reset()
    with timers.tracing():
        eng.run(st0, nsteps, thermo_every=0)
    c = timers.counters()
    assert c["host_read.rebuild_flag"] == nsteps
    assert c["host_read.energy"] == 1
    names = [s["name"] for s in timers.spans()]
    if runner == "graphs":
        assert names.count("steploop.run") == 1
        # graph A every step, graph B every step, graph R on rebuilds
        assert names.count("steploop.launch") == 2 * nsteps + eng.rebuilds
        assert names.count("integrate.pre") >= 1
    else:
        assert "steploop.run" not in names
        assert names.count("integrate.pre") == nsteps


def test_step_loop_on_graph_runner(ref_dir, monkeypatch):
    eng = _dilute(ref_dir, monkeypatch)
    st0 = eng.init_state()
    _graph_runner(monkeypatch)
    out = timers.step_loop(eng, st0, chunk=4, every=2, steps=2)
    # the end-of-run energy and the seven thermo columns over 4 steps
    assert out["host_reads"] == {"energy": 1, "thermo_rows": 7}
    assert out["host_reads_per_step"] == 2.0
    assert out["launch_us_per_step"] > 0.0
    assert out["host_other_us_per_step"] >= 0.0
    # no device: no marks, no device events
    assert out["layer_ms"] is None and out["idle_launch_share"] is None


def test_span_in_profiler_events():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.span("probe.outer"):
            torch.ones(8).sum()
        with timers.tracing(), timers.layer("probe.layer"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"probe.outer", "probe.layer"} <= names
    # outside tracing a layer records nothing
    n = len(timers.spans())
    with timers.layer("probe.off"):
        pass
    assert len(timers.spans()) == n == 2


def test_idle_share_in_launch_ranges():
    """The idle gaps between device intervals, put down to the host ranges
    of a name by overlap on one clock; the profiler's device-side user
    annotations are left out of the device's work."""
    class Ev:
        def __init__(self, name, dev, s, e, annotation=False):
            self.name = name
            self.device_type = type("D", (), {"name": dev})
            self.time_range = type("T", (), {"start": s, "end": e})
            self.is_user_annotation = annotation
    evs = [Ev("k", "CUDA", 0, 10), Ev("k", "CUDA", 5, 12),
           Ev("k", "CUDA", 20, 30), Ev("k", "CUDA", 40, 41),
           Ev("steploop.launch", "CPU", 15, 25),
           Ev("steploop.launch", "CPU", 24, 35), Ev("other", "CPU", 0, 50),
           # the device's copy of a host range is not device work
           Ev("steploop.run", "CUDA", 0, 41, annotation=True)]
    # gaps (12, 20) and (30, 40): 18 idle, 5 + 5 inside the launches
    assert timers.idle_share_in(evs, "steploop.launch") == pytest.approx(
        100.0 * 10 / 18)
    assert timers.idle_share_in(evs[:1], "steploop.launch") is None


def test_cli_log_prints_setup_spans(ref_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    log = tmp_path / "log.dilute"
    assert cli.main(["run", "dilute", "0", "--cpu", "--steps", "2",
                     "--thermo", "1", "--log", str(log)]) == 0
    lines = log.read_text().splitlines()
    names = [ln[2:].split(":")[0].strip() for ln in lines
             if ln.startswith("# ") and ":" in ln]
    assert [n for n in names if n in SETUP] == SETUP
    assert names.index("setup.init_state") < names.index("full_step")
    assert "setup.conp.matrix" in names
