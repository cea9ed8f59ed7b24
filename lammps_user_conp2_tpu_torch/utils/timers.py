"""The port's tracer, and its per-phase timing: the reference's
Btime/Ctime/Ktime accounting (fix_conp.cpp:139-141, 549-567, 698-714).

Spans and counters sit at the program's own layer boundaries and are kept
in memory, in this module, until read (``spans``, ``counters``) or
cleared (``reset``):

* ``span(name)``: a context manager (or a function decorator) that records
  the name, the enclosing span and the start and end on
  ``time.perf_counter_ns``; inside a running ``torch.profiler`` it also
  opens a ``record_function`` range of the same name, so that the
  program's spans lie in the profiler's trace beside the kernels, on its
  clock.  The set-up spans (``setup.deck``, ``setup.conp`` with
  ``setup.conp.matrix`` and ``setup.conp.inverse``, ``setup.engine``,
  ``setup.init_state``) are recorded always;
* ``tracing()`` turns on what lies on the per-step path: the step loop's
  spans (``steploop.run`` around ``StepGraphs.run``, ``steploop.launch``
  around each graph replay), the ``host_read.<site>`` counters of every
  device-to-host read on the run path, and the layers of the step
  (``layer``: ``step``, ``integrate.pre``, ``solve``, ``forces`` with
  ``forces.pair`` and ``forces.kspace``, ``integrate.post``).  A CUDA
  graph captured under it (unless ``marks=False``) records a timing event
  at each layer boundary crossed in the capture (event-record nodes of the
  graph, whose times a replay sets: ``StepGraphs.mark_ms``); the graphs
  are keyed by the marks flag, so those captured without it hold no such
  node.  With tracing off the step loop pays one flag test per replay;
* ``step_loop`` measures the step loop under tracing: each layer's device
  time inside the graphed step, the host's time in the graph launches and
  in the loop's own Python, the host reads per step, and the share of the
  device's idle time that falls inside the launches.

The phases of a step are timed one at a time on the engine's configured
path (the Verlet list or the dense sweep, the mesh or the factored Ewald),
each after one warm-up call: with CUDA events on the card, on the host
clock on the CPU; ``full_step`` is ``Engine.run`` per step (the CUDA-graph
replay on the card).  ``trace`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import time

import torch

from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.kernels import build

# the tracer's state: the per-step path records only while TRACING is set,
# and graphs captured while MARKS is set hold the layers' device marks
TRACING = False
MARKS = False
# [name, parent's index in _SPANS or None, start ns, end ns or None, own
# index in _SPANS]
_SPANS: list = []
_OPEN: list = []            # the open spans' records, innermost last
_COUNTS: dict = {}
_MARKS = None               # the device marks of the capture in progress
_OFF = contextlib.nullcontext()


class span:
    """A span of the program (the module's docstring); as a decorator, one
    span per call of the function."""

    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _OPEN[-1][4] if _OPEN else None
        self.rec = [self.name, parent, time.perf_counter_ns(), None,
                    len(_SPANS)]
        _SPANS.append(self.rec)
        _OPEN.append(self.rec)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec[3] = time.perf_counter_ns()
        if _OPEN and _OPEN[-1] is self.rec:
            _OPEN.pop()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Layer(span):
    """A layer's span, with a pair of timing events around it while a
    capture collects device marks."""

    __slots__ = ("ev",)

    def __enter__(self):
        super().__enter__()
        self.ev = None
        if _MARKS is not None:
            self.ev = torch.cuda.Event(enable_timing=True, external=True)
            self.ev.record()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record()
            _MARKS.append((self.name, self.ev, end))
        return super().__exit__(*exc)


def layer(name: str):
    """The span of one layer of the step, under ``tracing`` only (nothing
    with tracing off)."""
    return _Layer(name) if TRACING else _OFF


@contextlib.contextmanager
def tracing(marks: bool = True):
    """Record the per-step spans and counters in the block, and with
    ``marks`` replay graphs that hold the layers' device marks (captured
    on first use)."""
    global TRACING, MARKS
    prev = TRACING, MARKS
    TRACING, MARKS = True, marks
    try:
        yield
    finally:
        TRACING, MARKS = prev


@contextlib.contextmanager
def marking(marks):
    """The layers crossed in the block append (name, start event, end
    event) to the list ``marks`` (a CUDA graph capture under tracing);
    None records none."""
    global _MARKS
    prev, _MARKS = _MARKS, marks
    try:
        yield
    finally:
        _MARKS = prev


def count(site: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``site``."""
    _COUNTS[site] = _COUNTS.get(site, 0) + n


def host_read(site: str, n: int = 1) -> None:
    """Count ``n`` device-to-host reads at ``site`` (``host_read.<site>``),
    under ``tracing`` only."""
    if TRACING:
        count("host_read." + site, n)


def spans() -> list:
    """The recorded spans, oldest first: dicts of ``name``, ``parent`` (the
    enclosing span's index in this list, or None), ``start_ns`` and
    ``end_ns`` (None while open)."""
    return [dict(name=r[0], parent=r[1], start_ns=r[2], end_ns=r[3])
            for r in _SPANS]


def counters() -> dict:
    """{site: count} of the counters."""
    return dict(_COUNTS)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()


def span_lines(prefix: str) -> list:
    """``name: seconds`` of each closed span whose name starts with
    ``prefix``, in order, indented two spaces per enclosing span."""
    out = []
    for r in _SPANS:
        if r[0].startswith(prefix) and r[3] is not None:
            depth, p = 0, r[1]
            while p is not None:
                depth, p = depth + 1, _SPANS[p][1]
            out.append(f"{'  ' * depth}{r[0]}: {(r[3] - r[2]) * 1e-9:.3f} s")
    return out


def phases(engine, state) -> dict:
    """{phase: callable} of the step's phases at ``state`` on the engine's
    path, in step order: integrate (the integrator's parts of both halves:
    K10, with SHAKE K7 and K8, zmirror), b_vector (K5, or K2a and the
    z-plane readout), charge_solve, pair_forces (K4 or K1), nbr_rebuild,
    pppm_spread (K2a), pppm_fft, pppm_gather (K3), kspace_forces,
    full_step.  The inputs each phase reads are computed here, once."""
    eng = engine
    conp = eng.conp
    x, q, nbr, tasg = state.x, state.q, state.nbr, state.tasg

    def integrate():
        x1, v, xi, vxi = eng._half_pre(state)
        return eng._half_post(x1, v, state.f, xi, vxi)

    out = {"integrate": integrate}
    kcache = None
    if conp is not None:
        xs, qs = x.to(conp.solve_dtype), q.to(conp.solve_dtype)
        out["b_vector"] = lambda: conp.b_vector_full(xs, qs, nbr, eng.ncfg,
                                                     tasg)[0]
        out["charge_solve"] = lambda: conp.solve_full(
            x, q, nbr, eng.ncfg, tasg, step=state.step_t,
            scalar_prev=state.scalar_out)[:2]
        kcache = eng._own_cache(conp.elyte_kcache(x, q, tasg), x)
    out["pair_forces"] = lambda: eng._pair(x, q, kcache, nbr)
    if eng.ncfg is not None:
        out["nbr_rebuild"] = lambda: eng.derived_state(x)
    grid = eng.pppm_grid
    if grid is not None:
        n = x.shape[0]
        tiled = not pppm_ops._use_dense(grid, n)
        slots = eng._slots(x, q, tasg)
        out["pppm_spread"] = lambda: pppm_ops.spread_rhok(grid, x, q, slots)
        rhok = pppm_ops.spread_rhok(grid, x, q, slots)
        diff = eng.md.pppm_diff
        if diff == "ad" or (diff == "auto" and tiled):
            if tiled:
                out["pppm_fft"] = lambda: pppm_ops.pppm_energy_u_zbin(
                    grid, rhok, n)
                uz = pppm_ops.pppm_energy_u_zbin(grid, rhok, n)[1]
                out["pppm_gather"] = lambda: pppm_ops.gather3_ad_zbin(
                    grid, uz, x, slots)
            else:
                out["pppm_fft"] = lambda: pppm_ops.pppm_energy_u_from_k(
                    grid, rhok)
                um = pppm_ops.pppm_energy_u_from_k(grid, rhok)[1]
                out["pppm_gather"] = lambda: pppm_ops.gather3_ad(grid, um, x)
        else:
            out["pppm_fft"] = lambda: pppm_ops.pppm_energy_efield_from_k(
                grid, rhok)
            ef = pppm_ops.pppm_energy_efield_from_k(grid, rhok)[1]
            out["pppm_gather"] = lambda: pppm_ops.gather3(
                grid, ef, x, slots=slots, scale=q)
        out["kspace_forces"] = lambda: eng._pppm(x, q, kcache, tasg)
    elif kcache is not None:
        tabs, sre, sie, _ = kcache
        out["kspace_forces"] = lambda: ewf.energy_forces_cached(
            eng.fksp, q, tabs, sre, sie, conp.ele_rows)
    else:
        out["kspace_forces"] = lambda: ewf.energy_forces_f(eng.fksp, x, q)
    return out


def _seconds(fn, iters: int, device) -> float:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events
    around ``iters`` calls on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def profile_step(engine, state, *, iters: int = 10, log_path=None,
                 launches=None) -> dict:
    """{phase: seconds per call} of ``phases``, plus ``full_step``:
    ``Engine.run`` of ``iters`` steps from ``state``, per step.  With a
    dict ``launches``, each phase's kernel launches in its timed calls
    (the warm-up's included) go there by counter name; ``log_path``
    writes the times in ms as JSON."""
    dev = state.x.device
    calls = dict(phases(engine, state))
    calls["full_step"] = None
    res = {}
    for name, fn in calls.items():
        before = {c.name: c.count for c in build.COUNTERS}
        if fn is None:
            # one run of ``iters`` steps (graph capture in its warm-up run)
            run = lambda: engine.run(state, iters, thermo_every=0)
            res[name] = _seconds(run, 1, dev) / iters
        else:
            res[name] = _seconds(fn, iters, dev)
        if launches is not None:
            launches[name] = {c.name: c.count - before[c.name]
                              for c in build.COUNTERS
                              if c.count != before[c.name]}
    if log_path:
        with open(log_path, "w") as f:
            json.dump({k: round(v * 1e3, 4) for k, v in res.items()}, f)
    return res


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block run under ``tracing`` (the
    card's kernels where there is one, the program's spans beside them),
    written to ``logdir/trace.json`` for Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def union(ivs):
    """The union of the intervals ``ivs`` as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length both lists of sorted disjoint intervals cover."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        tot += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_share_in(events, name: str):
    """% of the device's idle time (the gaps between the union of its
    intervals, first to last) that falls inside the host ranges ``name``
    of a profiler's ``events``, both on the profiler's clock; None without
    a gap.  The device's copies of the host ranges (the profiler's user
    annotations, which span the work launched inside them) are not device
    work."""
    busy = union((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA"
                   and not getattr(e, "is_user_annotation", False))
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    ranges = union((e.time_range.start, e.time_range.end) for e in events
                     if e.name == name and e.device_type.name == "CPU")
    return 100.0 * _overlap(gaps, ranges) / idle


def _closed(recs, name):
    return [r for r in recs if r[0] == name and r[3] is not None]


def _layers(m: dict):
    """The layers of one step from its marks (``StepGraphs.mark_ms``):
    integrate (pre and post), solve, pair, kspace, forces_other (the self
    time of ``forces``), step and step_self (what the copies into the
    static buffers take); None without a ``step`` mark."""
    if "step" not in m:
        return None
    g = lambda k: m.get(k, 0.0)
    out = dict(integrate=g("integrate.pre") + g("integrate.post"),
               solve=g("solve"), pair=g("forces.pair"),
               kspace=g("forces.kspace"),
               forces_other=g("forces") - g("forces.pair") - g("forces.kspace"),
               step=g("step"))
    out["step_self"] = (out["step"] - out["integrate"] - out["solve"]
                        - g("forces"))
    return out


def step_loop(engine, state, *, chunk: int = 500, every: int = 20,
              steps: int = 100) -> dict:
    """The step loop under the tracer from ``state``, in three runs of
    ``Engine.run``, each from the last's end:

    * under ``tracing()``, ``steps`` steps replayed one at a time through
      the marked graphs, each synchronised and its marks read:
      ``layer_ms``, the median device ms per step of each layer of
      ``_layers`` (None where the graphs hold no whole-step marks: off the
      card, on the list and CG paths);
    * under ``tracing(marks=False)`` (the graphs the untraced run replays:
      event nodes slow a graph's launch on the host), one unprofiled
      chunk of ``chunk`` steps with a thermo row every ``every``, read back
      as ``cli run`` reads them: ``launch_us_per_step`` (the host inside
      the graph launches), ``host_other_us_per_step`` (the self time of
      ``steploop.run``), ``host_reads_per_step`` and ``host_reads`` by
      site;
    * as the chunk, one profiled replay of ``steps`` steps, its thermo rows
      read back: ``idle_launch_share`` (``idle_share_in`` of
      ``steploop.launch``; None without device events)."""
    from ..cli import thermo_rows
    from ..models import graphs
    cuda = state.x.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(state.x.device)

    st, per = state, []
    with tracing():
        for _ in range(steps):
            st, _ = engine.run(st, 1, thermo_every=0)
            sync()
            sg = engine._step_graphs.get(graphs.graph_key(engine, st))
            lay = None if sg is None or sg.listed or sg.cg else _layers(
                sg.mark_ms())
            if lay is not None:
                per.append(lay)
    layer_ms = ({k: statistics.median(p[k] for p in per) for k in per[0]}
                if per else None)

    n0, c0 = len(_SPANS), dict(_COUNTS)
    with tracing(marks=False):
        st, th = engine.run(st, chunk, thermo_every=every)
        if th:
            thermo_rows(th)
        sync()
    recs = _SPANS[n0:]
    runs = _closed(recs, "steploop.run")
    launch = _closed(recs, "steploop.launch")
    own = {r[4] for r in runs}
    ns = lambda rs: sum(r[3] - r[2] for r in rs)
    reads = {k[len("host_read."):]: v - c0.get(k, 0)
             for k, v in _COUNTS.items()
             if k.startswith("host_read.") and v != c0.get(k, 0)}
    out = dict(
        layer_ms=layer_ms, layer_steps=len(per), chunk_steps=chunk,
        launch_us_per_step=(ns(launch) * 1e-3 / chunk if runs else None),
        host_other_us_per_step=(
            (ns(runs) - ns(r for r in launch if r[1] in own)) * 1e-3 / chunk
            if runs else None),
        host_reads_per_step=sum(reads.values()) / chunk, host_reads=reads)

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tracing(marks=False), profile(activities=acts) as prof:
        st, th = engine.run(st, steps, thermo_every=every)
        if th:
            thermo_rows(th)
        sync()
    out["idle_launch_share"] = idle_share_in(prof.events(), "steploop.launch")
    return out
