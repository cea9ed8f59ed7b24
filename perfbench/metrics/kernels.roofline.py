"""Share of their bound that the hand kernels reach in the profiled replay:
the sum over the kernels with a file under ``perfbench/roofline/`` of
(bound per call x calls) over the sum of their device time.  Bounds at the
window's last state; calls from the program's launch counters."""

LAYER = "hand kernels"
UNIT = "%"
MOVES = "ns_per_day"


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    bound = busy = 0.0
    for k, (calls, bound_s) in tr["kernel_bounds"].items():
        t = tr["kernel_s"].get(k, 0.0)
        if t > 0.0 and calls > 0:
            bound += calls * bound_s
            busy += t
    if busy <= 0.0:
        return None
    return 100.0 * bound / busy
