"""Per-phase timing: the reference's Btime/Ctime/Ktime accounting
(fix_conp.cpp:139-141, 549-567, 698-714) for the port.

The phases of a step are timed one at a time on the engine's configured
path (the Verlet list or the dense sweep, the mesh or the factored Ewald),
each after one warm-up call: with CUDA events on the card, on the host
clock on the CPU; ``full_step`` is ``Engine.run`` per step (the CUDA-graph
replay on the card).  ``trace`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from ..ops import ewald_factored as ewf
from ..ops import pppm as pppm_ops
from ..ops.kernels import build


def phases(engine, state) -> dict:
    """{phase: callable} of the step's phases at ``state`` on the engine's
    path, in step order: b_vector (K5, or K2a and the z-plane readout),
    charge_solve, pair_forces (K4 or K1), nbr_rebuild, pppm_spread (K2a),
    pppm_fft, pppm_gather (K3), kspace_forces, full_step.  The inputs each
    phase reads are computed here, once."""
    eng = engine
    conp = eng.conp
    x, q, nbr, tasg = state.x, state.q, state.nbr, state.tasg
    out = {}
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
            out["pppm_gather"] = lambda: pppm_ops.gather3(grid, ef, x,
                                                          slots=slots)
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
    """A ``torch.profiler`` trace of the block (the card's kernels where
    there is one), written to ``logdir/trace.json`` for Perfetto or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
