"""Seconds of the warm ``Engine.run`` chunk that captures the step's CUDA
graphs (``models/graphs``), on the host clock, synchronised."""

LAYER = "graph capture"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("warm_run")
