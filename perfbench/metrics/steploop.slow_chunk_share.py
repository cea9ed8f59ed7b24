"""% of the window's chunks that ran while the host was in its slower
speed: a chunk over ``harness.SLOW`` times the run's fastest, on the host
clock.  It tells a run that the host's ``cudaGraphLaunch`` slowed from one
whose step got slower on every chunk."""

LAYER = "step loop"
UNIT = "%"
MOVES = "ns_per_day"


def read(ctx):
    return ctx["spans"].get("slow_chunks")
