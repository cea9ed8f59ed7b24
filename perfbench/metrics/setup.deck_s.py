"""Seconds of the deck's load (``cli.load_deck``: the data file parsed, the
``System`` and the deck's settings built): the program's span
``setup.deck``, on the host clock."""

from perfbench import program

LAYER = "deck load"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.top_s(ctx, "setup.deck")
