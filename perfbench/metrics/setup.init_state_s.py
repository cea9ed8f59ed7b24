"""Seconds of ``Engine.init_state``: the first list and mesh tiles, the
first eager charge solve and forces, with the first cuBLAS and cuFFT
plans; the program's span ``setup.init_state``."""

from perfbench import program

LAYER = "initial state"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.top_s(ctx, "setup.init_state")
