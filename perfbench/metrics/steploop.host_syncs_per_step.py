"""Synchronising host calls per step over one unprofiled chunk of
``Engine.run``, counted with ``torch.cuda.set_sync_debug_mode("warn")``."""

LAYER = "step loop"
UNIT = "syncs/step"
MOVES = "ns_per_day"


def read(ctx):
    c = ctx["counters"]
    if not c.get("sync_steps"):
        return None
    return c["host_syncs"] / c["sync_steps"]
