"""Device kernels per step in the profiled replay of ``Engine.run``."""

LAYER = "step loop"
UNIT = "kernels/step"
MOVES = "ns_per_day"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["steps"] or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["steps"]
