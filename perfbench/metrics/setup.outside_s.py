"""Seconds of ``setup_s`` outside the program's set-up spans and the warm
chunk: the torch and CUDA start, the imports and the harness's data file.
From the process start to the end of ``setup.init_state``, less
``setup.deck``, ``setup.conp``, ``setup.engine`` and ``setup.init_state``;
with them, ``setup.graphs_s`` and the warm chunk's start right after
``init_state``, it adds up to ``setup_s``."""

from perfbench import program

LAYER = "outside the program"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return program.outside_s(ctx)
