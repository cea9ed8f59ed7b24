"""Seconds of the float64 inverse of A, its projection, the d vector and
elesetq inside ``setup_conp``: the program's spans ``setup.conp.inverse``
within ``setup.conp``, summed."""

from perfbench import program

LAYER = "charge-solve set-up"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.child_s(ctx, "setup.conp", "setup.conp.inverse")
