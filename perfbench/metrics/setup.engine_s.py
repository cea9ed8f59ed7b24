"""Seconds of ``build_engine`` (the pair path and k-space tables in
float32, the SHAKE tables, the integrator): the program's span
``setup.engine``."""

from perfbench import program

LAYER = "engine build"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.top_s(ctx, "setup.engine")
