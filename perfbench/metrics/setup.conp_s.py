"""Seconds of the charge solve's set-up (``models/conp.setup_conp``: A, its
projected inverse and the k-space tables in float64), on the host clock
around the call inside ``cli.build``."""

LAYER = "charge-solve set-up"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("setup_conp")
