"""The MD step replayed as CUDA graphs: the port's counterpart of the JAX
engine's jitted run loop (``lammps_user_conp2_tpu/models/md.py``
``_make_run``: ``lax.scan`` under ``jax.jit``, the Verlet skin check kept on
the device with ``lax.cond``).

An eager step launches 350-730 kernels from Python; a replayed graph
launches them all with one call.  ``Engine.run`` on a CUDA state replays
the segments of ``Engine.step`` captured here, on static buffers that hold
the state between replays:

* dense and cell paths (no rebuild flag): one graph of the whole step,
  replayed ``nsteps`` times with no host sync in the loop (INV);
* list and tile paths (``Engine.split_step``): graph A (``Engine._pre``:
  thermostat half, kicks, drift, SHAKE, the Verlet skin check or the mesh
  tiles' drift test into a device flag), then one host read of the flag
  (the one sync per step the eager step has too), graph R
  (``Engine._rebuild``: the list, the mesh tiles, the sticky overflow; the
  mesh tiles alone on the tile path) when it is set, then graph B
  (``Engine._post``: the charge solve, the forces, the kick, RATTLE,
  thermostat half).  That is the eager control flow exactly, so the
  replayed step computes what ``step`` computes, op for op;
* the CG solvers split the solve out of the step's last graph: graph H
  (on the dense paths ``_pre`` and) ``Engine._solve_begin`` up to the CG
  carry, graph C (``CG_BLOCK`` CG iterations, ``ConpSolver.cg_block``)
  replayed while the carry's device flag, read on the host after H and
  after each C, says another iteration is due, then graph T
  (``Engine._post_tail``).  A step then reads the host 1 + (CG blocks)
  times on the dense paths and 2 + (CG blocks) times on the list paths,
  as the eager step does;
* ``nevery`` > 1: a second variant of the solve's graph (B, or the dense
  whole step) that skips the solve, replayed on the steps whose host step
  number says so (``Engine.solves``); no host read decides it;
* the thermo row: a small graph that writes the row into preallocated rows
  at a device counter, replayed every ``thermo_every`` steps.

Each segment runs once on a side stream before its capture (the cuFFT
plans, the cuBLAS workspaces, the kernels' build and launch attributes),
and all the graphs of one ``StepGraphs`` share one memory pool.  The graphs
are keyed by the engine's capacities (list K, U and cell cap, the cell
list's cap, the tile path's pair cap, the mesh tile cap): when ``run`` grows
one after an overflow, the next run captures anew.

A kernel wrapper counts its launches in Python (``build.LaunchCounter``),
which a replay does not run: each capture records the counts its segment
added, the counts are put back, and every replay adds them again, so the
counters read as they would after the eager steps.

Under ``utils/timers.tracing`` each replay is a ``steploop.launch`` span
and ``run`` a ``steploop.run`` span, the flag reads count as
``host_read`` (``rebuild_flag``, ``cg_flag``), and, unless its
``marks=False``, the graphs, keyed by the marks flag, are captured with a
timing event at each layer boundary of the step (``mark_ms`` reads them
after a replay); with tracing off a replay pays one flag test.

Nothing falls back: a capture or a replay that fails raises, naming the
segment.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.kernels import build
from ..utils import timers
from ..utils.config import Solver

# thermo rows the first capture of the thermo graph makes room for
THERMO_ROWS = 64


def clone_state(obj):
    """A copy of a state (MDState, NeighborList, TileAssign, a solve's
    carry) with every tensor cloned, in tuples and lists too; other fields
    are shared."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(clone_state(o) for o in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone_state(o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: clone_state(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.init and (isinstance(getattr(obj, f.name), (
                torch.Tensor, list, tuple)) or dataclasses.is_dataclass(
                    getattr(obj, f.name)))})
    return obj


def copy_state(dst, src, segment: str) -> None:
    """Copy every tensor of ``src`` into the same field of ``dst`` (states,
    lists or tuples of tensors); raises, naming ``segment``, where a shape,
    a dtype or the presence of a field differs."""
    if dst is src:
        return
    if isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise RuntimeError(
                f"step segment {segment!r}: a state tensor changed from "
                f"{tuple(dst.shape)} {dst.dtype} to {tuple(src.shape)} "
                f"{src.dtype}")
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)) and isinstance(src, (list, tuple)):
        for d, s in zip(dst, src):
            copy_state(d, s, segment)
    elif dataclasses.is_dataclass(dst) and type(dst) is type(src):
        for f in dataclasses.fields(dst):
            copy_state(getattr(dst, f.name), getattr(src, f.name), segment)
    elif isinstance(dst, torch.Tensor) or isinstance(src, torch.Tensor) or (
            dataclasses.is_dataclass(dst) or dataclasses.is_dataclass(src)):
        raise RuntimeError(f"step segment {segment!r}: the state's layout "
                           f"changed ({type(dst).__name__} <- "
                           f"{type(src).__name__})")


class CudaGraphBackend:
    """Warm-up and capture on one side stream into one memory pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []

    def warm(self, fn) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def capture(self, fn):
        g = torch.cuda.CUDAGraph()
        # thread-local: a CUDA call that another thread makes meanwhile (a
        # profiler's buffer thread) leaves this capture valid; an unsafe
        # call on this thread still fails it
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            fn()
        self.graphs.append(g)
        return g.replay


def _counts():
    return [c.count for c in build.COUNTERS]


def _restore(counts) -> None:
    for c, n in zip(build.COUNTERS, counts):
        c.count = n


class StepGraphs:
    """The captured segments of ``eng.step`` for the capacities and state
    layout of ``state``, on static buffers.  ``backend`` captures and
    replays (``CudaGraphBackend`` on the card)."""

    def __init__(self, eng, state, backend):
        self.eng = eng
        self.backend = backend
        self.listed = eng.split_step
        # the capacities these graphs were captured at; holding them keeps
        # the device constants cached on them alive for the replays
        self.refs = (eng.ncfg, eng.pppm_grid, eng.cell_grid)
        self.s = clone_state(state)
        self.p = [torch.empty_like(state.x), torch.empty_like(state.v),
                  torch.empty_like(state.nhc_xi),
                  torch.empty_like(state.nhc_vxi),
                  torch.empty((), dtype=torch.bool, device=state.x.device)]
        self.keys = [k for k in eng.thermo(state) if k != "step"]
        self.rows = None
        self.ctr = torch.zeros(1, dtype=torch.int64, device=state.x.device)
        self.replays = {}
        # each segment's device marks (captured under tracing), and the
        # segments replayed since ``run`` began (under tracing)
        self.marks = {}
        self.replayed = []
        conp = eng.conp
        # the solve's CG carry between graphs H, C and T (made in the
        # warm-up, outside the captures)
        self.cg = conp is not None and conp.cfg.solver is not Solver.INV
        self.pend = None
        segs = [("pre", self._pre), ("rebuild", self._rebuild)] \
            if self.listed else []
        last = "post" if self.listed else "step"
        for solve in ((True, False) if conp is not None
                      and conp.cfg.nevery > 1 else (True,)):
            if solve and self.cg:
                segs += [("head", self._head), ("cg", self._cg),
                         ("tail", self._tail)]
            else:
                fn = self._post if self.listed else self._step
                segs.append((self._variant(last, solve),
                             lambda fn=fn, solve=solve: fn(solve)))
        counts = _counts()

        def warm():
            for _, fn in segs:
                fn()

        try:
            backend.warm(warm)
        except Exception as e:
            raise RuntimeError(f"warm-up of the step segments failed: {e}"
                               ) from e
        _restore(counts)
        for name, fn in segs:
            self._capture(name, fn)
        self._grow_rows(THERMO_ROWS)

    # ---------------------------------------------------------- segments
    def _pre(self):
        x, v, xi, vxi, flag = self.eng._pre(self.s)
        copy_state(self.p, (x, v, xi, vxi, flag), "pre")

    def _rebuild(self):
        nbr, tasg = self.eng._rebuild(self.p[0], self.s.nbr)
        copy_state(self.s.nbr, nbr, "rebuild")
        copy_state(self.s.tasg, tasg, "rebuild")

    @staticmethod
    def _variant(name, solve: bool) -> str:
        return name if solve else name + ":skip"

    def _post(self, solve):
        with timers.layer("step"):
            x, v, xi, vxi, _ = self.p
            new = self.eng._post(self.s, x, v, xi, vxi, self.s.nbr,
                                 self.s.tasg, solve=solve)
            copy_state(self.s, new, self._variant("post", solve))

    def _step(self, solve):
        with timers.layer("step"):
            x, v, xi, vxi, _ = self.eng._pre(self.s)
            new = self.eng._post(self.s, x, v, xi, vxi, self.s.nbr,
                                 self.s.tasg, solve=solve)
            copy_state(self.s, new, self._variant("step", solve))

    def _head(self):
        if not self.listed:
            x, v, xi, vxi, _ = self.eng._pre(self.s)
            copy_state(self.p[:4], (x, v, xi, vxi), "head")
        pend = self.eng._solve_begin(self.s, self.p[0], self.s.nbr,
                                     self.s.tasg, True)
        if self.pend is None:
            self.pend = clone_state(pend)
        else:
            copy_state(self.pend, pend, "head")

    def _cg(self):
        copy_state(self.pend.cg, self.eng.conp.cg_block(self.pend), "cg")

    def _tail(self):
        x, v, xi, vxi, _ = self.p
        new = self.eng._post_tail(self.s, x, v, xi, vxi, self.s.nbr,
                                  self.s.tasg, self.pend)
        copy_state(self.s, new, "tail")

    def _thermo(self):
        th = self.eng.thermo(self.s)
        row = torch.stack([th[k] for k in self.keys])
        self.rows.index_copy_(0, self.ctr, row[None])
        self.ctr.add_(1)

    # ----------------------------------------------------------- capture
    def _capture(self, name, fn):
        counts = _counts()
        marks = [] if timers.MARKS and self.s.x.is_cuda else None
        try:
            with timers.marking(marks):
                replay = self.backend.capture(fn)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the step segment "
                               f"{name!r} failed: {e}") from e
        added = [(c, c.count - n) for c, n in zip(build.COUNTERS, counts)
                 if c.count != n]
        _restore(counts)
        self.replays[name] = (replay, added)
        if marks:
            self.marks[name] = marks

    def _grow_rows(self, nrows: int) -> None:
        """Rows for ``nrows`` thermo rows, and the thermo graph on them."""
        if self.rows is not None and self.rows.shape[0] >= nrows:
            return
        self.rows = torch.zeros((nrows, len(self.keys)),
                                dtype=self.s.energy.dtype,
                                device=self.s.x.device)
        self.ctr.zero_()
        counts = _counts()
        try:
            self.backend.warm(self._thermo)
        except Exception as e:
            raise RuntimeError(f"warm-up of the thermo segment failed: {e}"
                               ) from e
        _restore(counts)
        self._capture("thermo", self._thermo)

    def _replay(self, name: str) -> None:
        replay, added = self.replays[name]
        try:
            if timers.TRACING:
                self.replayed.append(name)
                with timers.span("steploop.launch"):
                    replay()
            else:
                replay()
        except Exception as e:
            raise RuntimeError(f"CUDA graph replay of the step segment "
                               f"{name!r} failed: {e}") from e
        for c, n in added:
            c.count += n

    # --------------------------------------------------------------- run
    def mark_ms(self) -> dict:
        """{layer: device ms} summed over the marks of the segments the last
        ``run`` under tracing replayed, each as its last replay recorded
        them (after a synchronise; a segment replayed more than once in
        that run counts its last replay once)."""
        out = {}
        for name in dict.fromkeys(self.replayed):
            for layer, a, b in self.marks.get(name, ()):
                out[layer] = out.get(layer, 0.0) + a.elapsed_time(b)
        return out

    def run(self, state, nsteps: int, thermo_every: int):
        """``nsteps`` replayed steps from ``state`` (left as it is):
        (final state, thermo dict as ``Engine.run`` returns it)."""
        if timers.TRACING:
            self.replayed = []
            with timers.span("steploop.run"):
                return self._run(state, nsteps, thermo_every, True)
        return self._run(state, nsteps, thermo_every, False)

    @staticmethod
    def _read(flag, site: str, traced: bool) -> bool:
        """A device flag read on the host, counted under tracing."""
        if traced:
            timers.count("host_read." + site)
        return bool(flag)

    def _run(self, state, nsteps, thermo_every, traced):
        nrows = nsteps // thermo_every if thermo_every else 0
        self._grow_rows(nrows)
        copy_state(self.s, state, "load")
        self.ctr.zero_()
        eng = self.eng
        for i in range(nsteps):
            solve = eng.solves(state.step + i)
            if self.listed:
                self._replay("pre")
                if self._read(self.p[4], "rebuild_flag", traced):
                    self._replay("rebuild")
                    eng.rebuilds += 1
            if solve and self.cg:
                self._replay("head")
                while self._read(self.pend.cg.active, "cg_flag", traced):
                    self._replay("cg")
                    eng.cg_blocks += 1
                self._replay("tail")
            else:
                self._replay(self._variant(
                    "post" if self.listed else "step", solve))
            if thermo_every and (i + 1) % thermo_every == 0:
                self._replay("thermo")
        final = dataclasses.replace(clone_state(self.s),
                                    step=state.step + nsteps)
        th = {}
        if nrows:
            th["step"] = torch.tensor([state.step + thermo_every * (j + 1)
                                       for j in range(nrows)])
            rows = self.rows[:nrows].clone()
            th.update({k: rows[:, j].clone() for j, k in
                       enumerate(self.keys)})
        return final, th


def replayed(state) -> bool:
    """Whether ``Engine.run`` replays graphs for this state: on CUDA."""
    return state.x.is_cuda


def graph_key(eng, state) -> tuple:
    """The capacities (``eng.graph_caps()``) and the state layout a set of
    graphs is valid for: each tensor's shape, dtype and device, and each
    dataclass's type (a sharded rank's mesh-tile assignment is not the
    engine's, whatever its shapes); and ``timers.MARKS``, under which the
    graphs hold the layers' device marks."""
    tensors = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            tensors.append((tuple(o.shape), o.dtype, str(o.device)))
        elif dataclasses.is_dataclass(o):
            tensors.append(type(o).__name__)
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif o is None:
            tensors.append(None)

    walk(state)
    return eng.graph_caps() + (tuple(tensors), timers.MARKS)


def step_graphs(eng, state, backend=None) -> StepGraphs:
    """The engine's graphs for this state, captured on first use (and anew
    after a capacity growth) and cached on the engine."""
    key = graph_key(eng, state)
    if key not in eng._step_graphs:
        eng._step_graphs[key] = StepGraphs(
            eng, state, backend or CudaGraphBackend(state.x.device))
    return eng._step_graphs[key]
