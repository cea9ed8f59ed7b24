"""Milliseconds of the charge solve (b vector, A^-1 b, the mode update) run
alone and eager at the window's last state: the program's own entry to the
layer, ``utils/timers.phases``'s ``charge_solve``, between CUDA events. It
pays the launches that the graphed step does not."""

LAYER = "charge solve"
UNIT = "ms"
MOVES = "ns_per_day"


def read(ctx):
    s = ctx["phases"].get("charge_solve")
    return None if s is None else s * 1e3
