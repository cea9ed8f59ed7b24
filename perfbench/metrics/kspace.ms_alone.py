"""Milliseconds of the k-space forces (factored Ewald, or the PPPM mesh) run
alone and eager at the window's last state: the program's own entry to the
layer, ``utils/timers.phases``'s ``kspace_forces``, between CUDA events.
It pays the launches that the graphed step does not."""

LAYER = "k-space forces"
UNIT = "ms"
MOVES = "ns_per_day"


def read(ctx):
    s = ctx["phases"].get("kspace_forces")
    return None if s is None else s * 1e3
