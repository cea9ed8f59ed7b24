"""The readers of the program's set-up spans (``perfbench/program.py`` and
``metrics/setup.*``) on a hand-built record: each metric from its span,
None where its span, the run or the tracer is missing, and the set-up
accounted for: the spans, the warm chunk and ``setup.outside_s`` add up
to ``setup_s``."""

import sys
import types

import pytest
from conftest import ROOT

from perfbench import harness, program

NEW = ("setup.deck_s", "setup.conp_matrix_s", "setup.conp_inverse_s",
       "setup.engine_s", "setup.init_state_s", "setup.outside_s")
S = 1_000_000_000


def _span(name, parent, start, end):
    return dict(name=name, parent=parent, start_ns=int(start * S),
                end_ns=int(end * S))


# a run that started at t = 100 s: the deck, the solver's set-up with A
# and the inverse in two pieces, the engine, the first state; then the warm
# chunk of 0.5 s from t = 109
RUN = [_span("setup.deck", None, 101.0, 101.5),
       _span("setup.conp", None, 102.0, 106.0),
       _span("setup.conp.matrix", 1, 102.5, 104.5),
       _span("setup.conp.inverse", 1, 104.5, 105.0),
       _span("setup.conp.inverse", 1, 105.0, 105.25),
       _span("setup.engine", None, 106.0, 106.5),
       _span("setup.init_state", None, 107.0, 109.0),
       # a later span of the same name, inside another: not the run's
       _span("setup.engine", 6, 107.1, 107.2)]
WANT = {"setup.deck_s": 0.5, "setup.conp_matrix_s": 2.0,
        "setup.conp_inverse_s": 0.75, "setup.engine_s": 0.5,
        "setup.init_state_s": 2.0,
        # 109 - 100 - (0.5 + 4 + 0.5 + 2)
        "setup.outside_s": 2.0}


@pytest.fixture
def tracer(monkeypatch):
    from lammps_user_conp2_tpu_torch.utils import timers
    recs = list(RUN)
    monkeypatch.setattr(timers, "spans", lambda: recs)
    main = types.ModuleType("__main__")
    main.T_START = 100.0
    monkeypatch.setitem(sys.modules, "__main__", main)
    return recs


def _read(name, ctx):
    return harness.load_module(ROOT / "perfbench" / "metrics"
                               / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_its_span(tracer, name):
    ctx = dict(spans={"warm_run": 0.5, "setup_conp": 4.0}, counters={})
    assert _read(name, ctx) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_none_without_a_run(tracer, name):
    assert _read(name, dict(spans={}, counters={})) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_none_without_its_span(tracer, name):
    missing = {"setup.deck_s": "setup.deck",
               "setup.conp_matrix_s": "setup.conp.matrix",
               "setup.conp_inverse_s": "setup.conp.inverse",
               "setup.engine_s": "setup.engine",
               "setup.init_state_s": "setup.init_state",
               "setup.outside_s": "setup.deck"}[name]
    tracer[:] = [r for r in tracer if r["name"] != missing]
    assert _read(name, dict(spans={"warm_run": 0.5})) is None


def test_reader_none_without_the_tracer(monkeypatch):
    """A program without ``timers.spans`` (a checkout from before the
    tracer) reads None."""
    from lammps_user_conp2_tpu_torch.utils import timers
    monkeypatch.delattr(timers, "spans")
    for name in NEW:
        assert _read(name, dict(spans={"warm_run": 0.5})) is None


def test_setup_adds_up(tracer):
    ctx = dict(spans={"warm_run": 0.5, "setup_conp": 4.0}, counters={})
    outside = _read("setup.outside_s", ctx)
    assert outside >= 0.0
    parts = sum(program.top_s(ctx, n) for n in program.SETUP)
    # the window opens as the warm chunk ends: 109.5 s after the start
    setup_s = 109.5 - 100.0
    assert parts + ctx["spans"]["warm_run"] + outside == pytest.approx(
        setup_s)
    assert (_read("setup.conp_matrix_s", ctx)
            + _read("setup.conp_inverse_s", ctx)
            <= program.top_s(ctx, "setup.conp"))


def test_a_cpu_run_reads_its_setup_spans():
    """A CPU run of the dilute cell in a fresh interpreter, its trace phase
    stood in for: every new reader reads a number from the program's own
    spans, and the set-up
    spans, the warm chunk and the outside share add up to the run's
    set-up time."""
    import subprocess
    script = (
        "import sys, time, torch\n"
        "T_START = time.perf_counter()\n"
        "sys.modules['__main__'].T_START = T_START\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import harness, program\n"
        "c = harness.load_cell('dilute0')\n"
        "c['traffic'] = dict(c['traffic'], chunk_steps=2, thermo_every=2)\n"
        "# the card's trace phase stood in for: the readers run after it\n"
        "harness.traced = lambda eng, st, traffic, roof: dict(\n"
        "    steps=1, window_s=0.0, kernels=0, busy_s=0.0, kernel_s={},\n"
        "    by_name={}, idle={}, calls={k: 0 for k in roof})\n"
        "harness.host_syncs = lambda eng, st, chunk, every: (0, chunk)\n"
        "harness.phase_seconds = lambda eng, st, names: {}\n"
        "logs = []\n"
        "out = harness.run_cell(c, 3, 0.0, True, device='cpu',\n"
        "    dtype=torch.float64, t_start=T_START, log=logs.append)\n"
        "m = {k: v['value'] for k, v in out['metrics'].items()}\n"
        "setup = float(logs[0].split('set-up ')[1].split(' s')[0])\n"
        "parts = sum(m[k] for k in ('setup.deck_s', 'setup.engine_s',\n"
        "            'setup.init_state_s', 'setup.graphs_s',\n"
        "            'setup.outside_s'))\n"
        "from lammps_user_conp2_tpu_torch.utils import timers\n"
        "conp = [s for s in timers.spans() if s['name'] == 'setup.conp']\n"
        "parts += (conp[0]['end_ns'] - conp[0]['start_ns']) * 1e-9\n"
        "print(out['correct'], setup, parts, m['setup.outside_s'],\n"
        "      m['setup.conp_matrix_s'] + m['setup.conp_inverse_s']\n"
        "      <= m['setup.conp_s'],\n"
        f"      all(k in m for k in {NEW!r}))\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ok, setup, parts, outside, conp_ok, all_read = r.stdout.split()[-6:]
    assert ok == "True" and conp_ok == "True" and all_read == "True"
    assert float(outside) >= 0.0
    assert float(parts) == pytest.approx(float(setup), rel=0.01)
