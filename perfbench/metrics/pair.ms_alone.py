"""Milliseconds of the pair sweep (K4 with the fused CONP correction) run
alone and eager at the window's last state: the program's own entry to the
layer, ``utils/timers.phases``'s ``pair_forces``, between CUDA events. It
pays the launches that the graphed step does not."""

LAYER = "pair forces"
UNIT = "ms"
MOVES = "ns_per_day"


def read(ctx):
    s = ctx["phases"].get("pair_forces")
    return None if s is None else s * 1e3
