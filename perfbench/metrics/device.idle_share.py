"""Share of the profiled window in which no operation ran on the device:
1 - (union of the kernel intervals) / (the window, timed with CUDA events
in the same run)."""

LAYER = "device"
UNIT = "%"
MOVES = "ns_per_day"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0.0 or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
