"""The set-up spans the program's tracer (``lammps_user_conp2_tpu_torch/
utils/timers``) recorded in this process, for the readers in ``metrics/``.

The tracer records the set-up spans always, in memory; the run's are the
first of their names with no enclosing span.  They are read only after a
run of the harness in this process (``ctx["spans"]`` holds its warm
chunk), and not at all where the program has no tracer (a checkout from
before it had one): then every reader here returns None.
"""

import sys

# the set-up spans that add up to the program's part of setup_s
SETUP = ("setup.deck", "setup.conp", "setup.engine", "setup.init_state")


def spans(ctx):
    """The program's spans (``timers.spans()``), or None."""
    if "warm_run" not in ctx.get("spans", {}):
        return None
    try:
        from lammps_user_conp2_tpu_torch.utils import timers
    except ImportError:
        return None
    read = getattr(timers, "spans", None)
    return read() if callable(read) else None


def first(recs, name):
    """The index of the first closed span ``name`` with no parent, or
    None."""
    for i, r in enumerate(recs):
        if r["name"] == name and r["parent"] is None and r["end_ns"]:
            return i
    return None


def seconds(r) -> float:
    return (r["end_ns"] - r["start_ns"]) * 1e-9


def top_s(ctx, name):
    """Seconds of the run's set-up span ``name``, or None."""
    recs = spans(ctx)
    i = None if recs is None else first(recs, name)
    return None if i is None else seconds(recs[i])


def child_s(ctx, parent, name):
    """Seconds of the spans ``name`` inside the run's span ``parent``,
    summed, or None where there is none."""
    recs = spans(ctx)
    p = None if recs is None else first(recs, parent)
    if p is None:
        return None
    kids = [seconds(r) for r in recs if r["parent"] == p
            and r["name"] == name and r["end_ns"]]
    return sum(kids) if kids else None


def outside_s(ctx):
    """Seconds of ``setup_s`` before the warm chunk outside the program's
    set-up spans: from the process start (``T_START`` of the running
    ``run.py``) to the end of ``setup.init_state``, less the four spans;
    None where one is missing."""
    recs = spans(ctx)
    t_start = getattr(sys.modules.get("__main__"), "T_START", None)
    if recs is None or t_start is None:
        return None
    idx = [first(recs, n) for n in SETUP]
    if None in idx:
        return None
    end = recs[idx[-1]]["end_ns"] * 1e-9
    return end - t_start - sum(seconds(recs[i]) for i in idx)
