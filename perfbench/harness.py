"""One run of one cell of the benchmark of ``lammps_user_conp2_tpu_torch``.

A cell names a configuration (``perfbench/configs/<config>.json``: the
deck, its data writer, its settings as the reference reads them) and a
traffic mix (``perfbench/traffic/<traffic>.json``: the deck's trial, the
chunk and thermo intervals of the run loop, the steps the trace replays);
``BENCHMARK.json`` pairs them and lists the metrics.  ``run_cell``:

1. set-up (``setup_s``, from the process start): the data file written
   from the seed with the program's writer into a fresh directory under
   ``TMPDIR``, which ``$CONP_REF_TESTS`` points the deck at; ``cli.build``
   (``setup_conp`` in float64, the engine in float32 with A^-1 kept in
   float64, as ``cli run --f32``); ``init_state``; one warm chunk of
   ``Engine.run``, which captures the CUDA graphs;
2. the window: chunks of ``Engine.run`` with their thermo rows read back,
   as ``cli run`` reads them, until ``seconds`` have passed (the last
   chunk counts whole), ended by a synchronise: ``ns_per_day``;
3. with ``trace``: a profiled replay, a chunk under the sync counter, the
   phases of ``utils/timers`` alone, read by ``perfbench/metrics/``;
4. the check: samples of the window's states (the start, the last chunk
   end and two more drawn from the seed as the chunks come), two more
   steps of each through the same graphs, and the plain reference at each
   (``judge``), once the program's state is on the host and freed.  A
   sample made before a list overflow grew the engine's capacities has
   its list and mesh tiles rebuilt at its positions first
   (``steppable``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from . import devtrace, judge, peaks
from .reference.conp_md import Reference, clusters
from .reference.deck import build_deck

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "perfbench"


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell reads, found by its name in BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    listed = lambda m: name in m.get("workloads", [name])
    return dict(
        name=name, chips=cell["chips"], config=load_json(root / cfg["file"]),
        traffic=load_json(root / "perfbench" / "traffic"
                          / f"{cell['traffic']}.json"),
        limits=load_json(root / "perfbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)])


def rooflines(root: Path = ROOT) -> dict:
    """{kernel: module} of ``perfbench/roofline/<kernel>.py``."""
    return {p.stem: load_module(p)
            for p in sorted((root / "perfbench" / "roofline").glob("*.py"))}


def ns_per_day(steps: int, dt_fs: float, wall_s: float) -> float:
    """Simulated nanoseconds per day of wall time: LAMMPS's "Performance"
    figure, over all the steps and all the time of the window."""
    return steps * dt_fs * 1e-6 / wall_s * 86400.0


def card_state() -> str:
    """The card's SM clock, power draw and limit and temperature, as
    nvidia-smi reads them (for the log; empty where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"card {out}"


def device_peak(dev) -> int:
    """Bytes of device memory at the peak since the last reset (0 off the
    card)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def write_data(config: dict, seed: int, directory: str) -> str:
    """The deck's data file from ``seed``, written by the program's own
    writer where the deck reads it (``<directory>/<deck>/data``)."""
    from lammps_user_conp2_tpu_torch import workloads
    w = config["writer"]
    path = os.path.join(directory, config["deck"]["name"], "data")
    getattr(workloads, w["name"])(path, seed=int(seed), **w.get("args", {}))
    return path


def build_program(config, traffic, device, dtype, spans):
    """(system, engine) through ``cli.build``, with the host time of
    ``setup_conp`` inside it in ``spans``."""
    from lammps_user_conp2_tpu_torch import cli
    from lammps_user_conp2_tpu_torch.models import conp as conp_mod
    inner = conp_mod.setup_conp

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        _sync(device)
        spans["setup_conp"] = spans.get("setup_conp", 0.0) + (
            time.perf_counter() - t)
        return out

    conp_mod.setup_conp = timed
    try:
        args = argparse.Namespace(
            workload=config["deck"]["name"], trial=traffic["trial"],
            cpu=device.type == "cpu", f32=dtype == torch.float32,
            solver=None, pair_path=None, kmax=None)
        return cli.build(args)
    finally:
        conp_mod.setup_conp = inner


def host_state(st, to_ref) -> dict:
    """A program state on the host in float64, rows in the reference's
    order."""
    f = lambda t: t.detach().to("cpu", torch.float64).numpy()
    return dict(x=to_ref(f(st.x)), v=to_ref(f(st.v)), q=to_ref(f(st.q)),
                f=to_ref(f(st.f)), pe=float(st.energy),
                scalar=float(st.scalar_out), xi=f(st.nhc_xi),
                vxi=f(st.nhc_vxi))


def _shapes(obj) -> list:
    """The shapes of the tensors in ``obj`` and its dataclass fields."""
    if torch.is_tensor(obj):
        return [tuple(obj.shape)]
    if isinstance(obj, (tuple, list)):
        return [s for o in obj for s in _shapes(o)]
    if dataclasses.is_dataclass(obj):
        return [s for f in dataclasses.fields(obj)
                for s in _shapes(getattr(obj, f.name))]
    return []


def steppable(eng, st):
    """``st`` as the engine can step it now: where a list overflow grew
    the engine's capacities after ``st`` was made (its Verlet list or mesh
    tiles no longer of the engine's shapes), with them rebuilt at its
    positions (``Engine.derived_state``), as the engine rebuilds them;
    otherwise ``st`` itself."""
    if getattr(st, "nbr", None) is None and getattr(st, "tasg", None) is None:
        return st
    nbr, tasg = eng.derived_state(st.x)
    if _shapes((nbr, tasg)) == _shapes((st.nbr, st.tasg)):
        return st
    return dataclasses.replace(st, nbr=nbr, tasg=tasg)


def program_answers(state, after, after2, row) -> dict:
    """A sample's answers as the program gave them: at the state, the
    printed row (or None) and the states one and two steps on."""
    return dict(q=state["q"], scalar=state["scalar"], f=state["f"],
                pe=state["pe"], row=row,
                next={k: after[k] for k in judge.STEP},
                next2={k: after2[k] for k in judge.STEP})


# a chunk slower than this many times the run's fastest ran while the host
# was in its slower speed (PERF.md, section 2)
SLOW = 1.06


def slow_share(per) -> float:
    """% of the window's chunks (seconds each) in the host's slower
    speed."""
    per = np.asarray(per, np.float64)
    return float(100.0 * np.mean(per > SLOW * per.min()))


def count_pairs(x, ele, box, periodic, cutoff, cut_coulsq) -> tuple:
    """(unordered pairs within the cutoff, electrode-electrolyte pairs
    within the Coulomb cutoff) at positions x (a tensor)."""
    n = x.shape[0]
    boxt = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    per = torch.as_tensor(periodic, device=x.device)
    elet = torch.as_tensor(ele, device=x.device)
    pairs = ele_pairs = 0
    for i0 in range(0, n, 512):
        d = x[i0:i0 + 512, None, :] - x[None, :, :]
        d = torch.where(per, d - boxt * torch.round(d / boxt), d)
        r2 = (d * d).sum(-1)
        rows = torch.arange(i0, min(i0 + 512, n), device=x.device)
        upper = rows[:, None] < torch.arange(n, device=x.device)[None, :]
        pairs += int(((r2 < cutoff * cutoff) & upper).sum())
        mix = elet[rows][:, None] & ~elet[None, :]
        ele_pairs += int(((r2 < cut_coulsq) & mix).sum())
    return pairs, ele_pairs


def program_sizes(eng, st) -> dict:
    """The sizes of what the program hands its list and mesh kernels at
    state ``st``, read off its own tensors as its launch counters are: the
    block list's blocks, atoms per block and union width (K1), the PPPM
    mesh and its order, and on a tiled mesh its tiles, their extent, the
    patch border and the slots per tile (K2a, K3).  Empty where the
    program has neither."""
    from lammps_user_conp2_tpu_torch.ops import pppm
    out = {}
    nbr = getattr(st, "nbr", None)
    if getattr(nbr, "bun", None) is not None:
        out.update(list_blocks=int(nbr.bun.shape[0]),
                   union_width=int(nbr.bun.shape[1]),
                   block_atoms=int(nbr.brows.shape[1]))
    grid = getattr(eng, "pppm_grid", None)
    if grid is not None:
        out.update(mesh=tuple(grid.shape), order=grid.order)
        n = int(st.x.shape[0])
        if not pppm._use_dense(grid, n):
            g = pppm._tile_geometry(grid, n)
            out.update(tiles=(g.ntx, g.nty, g.ntz), tile=(g.tlx, g.tly, g.tlz),
                       tile_border=g.hw + g.dm, slot_cap=g.cap)
    return out


def shapes(deck, cut_coulsq, x, sizes=None) -> dict:
    """The cell's sizes that the roofline files read, at positions x (a
    tensor), with the program's list and mesh ``sizes``
    (``program_sizes``)."""
    pairs, ele_pairs = count_pairs(x, deck.ele, deck.box, deck.periodic,
                                   deck.cutoff, cut_coulsq)
    width = np.zeros(deck.natoms, int)
    for i, j in deck.excl:
        width[i] += 1
        width[j] += 1
    cl = clusters(deck.shake)
    m = sum(len(a) for a, _, _ in cl)
    return dict(natoms=deck.natoms, ne=int(deck.ele.sum()),
                charged_elyte=int(((deck.q0 != 0) & ~deck.ele).sum()),
                ntypes=deck.lj_eps.shape[0] - 1,
                excl_width=int(width.max()) if deck.excl else 0,
                pairs=pairs, ele_pairs=ele_pairs, clusters=m,
                cluster_atoms=max((len(a[0]) for a, _, _ in cl), default=0),
                cluster_slots=max((len(s) for _, s, _ in cl), default=0),
                clustered_rows=sum(len(a) * len(a[0]) for a, _, _ in cl),
                **(sizes or {}))


def phase_seconds(eng, st, names, iters=20) -> dict:
    """Seconds per call of the program's phases (``utils/timers.phases``)
    alone, eager, after one warm-up call: CUDA events on the card."""
    from lammps_user_conp2_tpu_torch.utils import timers
    calls = timers.phases(eng, st)
    out = {}
    for name in names:
        fn = calls.get(name)
        if fn is None:
            continue
        fn()
        if st.x.is_cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            out[name] = a.elapsed_time(b) / 1e3 / iters
        else:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            out[name] = (time.perf_counter() - t) / iters
    return out


def host_syncs(eng, st, chunk, every) -> tuple:
    """(synchronising calls, steps) of one chunk of ``Engine.run`` with its
    thermo rows read back, under ``set_sync_debug_mode("warn")``."""
    from lammps_user_conp2_tpu_torch import cli
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, th = eng.run(st, chunk, thermo_every=every)
            cli.thermo_rows(th)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum("called a synchronizing" in str(w.message) for w in caught)
    return n, chunk


def traced(eng, st, traffic, roof) -> dict:
    """The profiled replay of ``trace_steps`` steps (timed itself with CUDA
    events), its kernels, busy time, idle gaps and hand-kernel time, and
    the hand kernels' calls in it from the program's launch counters."""
    from torch.profiler import ProfilerActivity, profile

    from lammps_user_conp2_tpu_torch.ops.kernels import build
    nsteps = int(traffic["trace_steps"])
    before = {c.name: c.count for c in build.COUNTERS}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        eng.run(st, nsteps, thermo_every=int(traffic["thermo_every"]))
        b.record()
        torch.cuda.synchronize()
    calls = {c.name: c.count - before.get(c.name, 0) for c in build.COUNTERS}
    parts = {k: m.PARTS for k, m in roof.items()}
    r = devtrace.read(prof, lambda name: devtrace.kernel_of(name, parts))
    return dict(steps=nsteps, window_s=a.elapsed_time(b) / 1e3,
                kernels=r["kernels"], busy_s=r["busy_s"],
                kernel_s=r["by_kernel"], by_name=r["by_name"],
                idle=r["idle"],
                calls={k: calls.get(m.COUNTER, 0) for k, m in roof.items()})


def run_cell(cell: dict, seed: int, seconds: float, with_trace: bool, *,
             device=None, dtype=torch.float32, t_start=None, log=print,
             min_chunks=1, control=False) -> dict:
    """One run of ``cell`` (``load_cell``); returns the result line's
    fields.  ``device`` None is the card; the CPU serves the tests.  The
    window runs at least ``min_chunks`` chunks; with ``control`` the
    result also holds the control's readings at the same samples
    (``values_control``: the reference in TF32 in the program's place)."""
    from lammps_user_conp2_tpu_torch import cli
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device or "cuda")
    config, traffic = cell["config"], cell["traffic"]
    chunk, every = int(traffic["chunk_steps"]), int(traffic["thermo_every"])
    spans, counters = {}, {}
    data_dir = tempfile.mkdtemp(prefix="perfbench_data_")
    old_ref = os.environ.get("CONP_REF_TESTS")
    try:
        path = write_data(config, seed, data_dir)
        os.environ["CONP_REF_TESTS"] = data_dir
        system, eng = build_program(config, traffic, dev, dtype, spans)
        st0 = eng.init_state()
        t = time.perf_counter()
        st, th = eng.run(st0, chunk, thermo_every=every)
        cli.thermo_rows(th)
        _sync(dev)
        spans["warm_run"] = time.perf_counter() - t
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        # the samples' chunk ends: two drawn from the seed over every end
        # but the last (a reservoir, so that only they stay on the card),
        # and the last
        rng = np.random.default_rng(seed)
        drawn, last = [], None
        steps = nchunks = failed = 0
        marks = [t0]
        while True:
            st, th = eng.run(st, chunk, thermo_every=every)
            row = cli.thermo_rows(th)[-1]
            if last is not None:
                j = rng.integers(0, nchunks) if nchunks > 2 else len(drawn)
                if j < 2:
                    drawn[j:j + 1] = [last]
            last = (st, row)
            failed += not all(np.isfinite(float(row[k]))
                              for k in judge.THERMO)
            nchunks += 1
            steps += chunk
            marks.append(time.perf_counter())
            if (time.perf_counter() - t0 >= seconds
                    and nchunks >= min_chunks):
                break
        _sync(dev)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        ns_day = ns_per_day(steps, float(eng.md.dt), wall)
        per = np.diff(marks)
        spans["slow_chunks"] = slow_share(per)
        log(f"window: {steps} steps in {wall:.3f} s, {nchunks} chunks "
            f"(s per chunk min {per.min():.4f} median {np.median(per):.4f} "
            f"max {per.max():.4f}; {spans['slow_chunks']:.1f}% of them "
            f"over {SLOW:.2f}x the fastest: the host's slower speed), "
            f"{steps / wall:.1f} steps/s, {ns_day:.3f} ns/day; set-up "
            f"{setup_s:.3f} s; {card_state()}")

        roof = rooflines()
        tr = None
        if with_trace:
            tr = traced(eng, st, traffic, roof)
            counters["host_syncs"], counters["sync_steps"] = host_syncs(
                eng, st, chunk, every)
            phases = phase_seconds(eng, st, ("charge_solve", "pair_forces",
                                             "kspace_forces"))
        sizes = program_sizes(eng, st)

        # the samples: the start, the chunk ends drawn, the last; each
        # with the states after one and two more steps
        chosen = [(st0, None)] + drawn + [last]
        deck_tags = np.sort(np.asarray(system.tag))
        rows_ref = np.searchsorted(deck_tags, np.asarray(system.tag))

        def to_ref(a):
            out = np.empty_like(a)
            out[rows_ref] = a
            return out

        samples = []
        for s, row in chosen:
            hs = host_state(s, to_ref)
            after, _ = eng.run(steppable(eng, s), 1, thermo_every=0)
            ha = host_state(after, to_ref)
            after, _ = eng.run(after, 1, thermo_every=0)
            ha2 = host_state(after, to_ref)
            prow = None if row is None else {
                k: float(row[k]) for k in judge.THERMO}
            samples.append((hs, program_answers(hs, ha, ha2, prow)))
        x_last = samples[-1][0]["x"]
        del eng, st, st0, drawn, last, chosen, after, s
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the reference, from the data file and the deck's settings alone;
        # its own peak of device memory from here (the program's was read)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        deck = build_deck(path, config, traffic)
        if not np.array_equal(deck.tag, deck_tags):
            raise RuntimeError("the program's atoms are not the file's")
        ref = Reference(deck, dev)
        judged = []
        for hs, got in samples:
            hs = dict(hs, q0=deck.q0)
            judged.append((hs, got, judge.model_answers(ref, hs)))
        values = judge.readings(judged, deck)
        correct, checks = judge.verdict(values, cell["limits"])
        log(f"reference: {len(judged)} samples in "
            f"{time.perf_counter() - t:.3f} s, device memory peak "
            f"{device_peak(dev)} B")
        if deck.shake:
            res = lambda side: np.max([judge.constraint_residuals(
                a[k]["x"], a[k]["v"], deck) for _, g, e in judged
                for a in (side(g, e),) for k in ("next", "next2")], axis=0)
            log("constraints after the steps, not compared (positions, "
                "velocities): program {:.3e} {:.3e}, reference {:.3e} "
                "{:.3e}".format(*res(lambda g, e: g), *res(lambda g, e: e)))
        values_control = None
        if control:
            t = time.perf_counter()
            ctl = Reference(deck, dev, tf32=True)
            values_control = judge.readings(
                [(hs, judge.model_answers(ctl, hs), e)
                 for hs, _, e in judged], deck)
            log(f"control: {time.perf_counter() - t:.3f} s, device memory "
                f"peak with the reference's {device_peak(dev)} B")

        ctx = dict(spans=spans, counters=counters)
        if with_trace:
            sh = shapes(deck, ref.cut_coulsq,
                        torch.as_tensor(x_last, device=dev), sizes)
            bounds = {}
            for k, m in roof.items():
                cost = m.cost(sh)
                if cost is not None:
                    bounds[k] = (tr["calls"][k], peaks.bound_s(*cost))
            tr["kernel_bounds"] = bounds
            ctx.update(trace=tr, phases=phases, shapes=sh)
        metrics = {}
        if not with_trace:
            e2e = dict(ns_per_day=ns_day, setup_s=setup_s)
            for m in cell["end_to_end"]:
                metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
        else:
            for m in cell["per_layer"]:
                reader = load_module(PB / "metrics" / f"{m['name']}.py")
                v = reader.read(ctx)
                if v is not None:
                    metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        out = dict(correct=bool(correct and failed == 0),
                   attempted=nchunks, failed=failed, metrics=metrics,
                   device=dict(platform="gpu" if dev.type == "cuda"
                               else dev.type,
                               kind=(torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
                               count=1, memory_peak_bytes=int(peak)),
                   values=values, checks=checks)
        if control:
            out["values_control"] = values_control
        if with_trace:
            out["device"].update(busy_s=tr["busy_s"],
                                 window_s=tr["window_s"])
            out["breakdown"] = dict(device_ops=devtrace.top(tr["by_name"]),
                                    idle_gaps=devtrace.top(tr["idle"]))
        return out
    finally:
        if old_ref is None:
            os.environ.pop("CONP_REF_TESTS", None)
        else:
            os.environ["CONP_REF_TESTS"] = old_ref
        shutil.rmtree(data_dir, ignore_errors=True)
