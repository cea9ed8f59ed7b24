"""Seconds of assembling A, the electrodes' (Ne, Ne) interaction matrix in
float64 on the host, inside ``setup_conp``: the program's span
``setup.conp.matrix`` within ``setup.conp``."""

from perfbench import program

LAYER = "charge-solve set-up"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.child_s(ctx, "setup.conp", "setup.conp.matrix")
