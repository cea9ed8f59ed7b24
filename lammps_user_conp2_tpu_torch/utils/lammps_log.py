"""Parser for the thermo blocks of a LAMMPS log (the reference's recorded
runs and the logs ``cli run`` writes)."""

from __future__ import annotations

import numpy as np


def parse_thermo_blocks(path: str):
    """A list of dict(column -> np.ndarray), one per thermo block: a line
    that starts with ``Step`` and the numeric rows of the same width under
    it."""
    blocks = []
    with open(path, errors="replace") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if parts and parts[0] == "Step":
            cols = parts
            rows = []
            i += 1
            while i < len(lines):
                p = lines[i].split()
                if len(p) != len(cols):
                    break
                try:
                    rows.append([float(v) for v in p])
                except ValueError:
                    break
                i += 1
            if rows:
                arr = np.array(rows)
                blocks.append({c: arr[:, k] for k, c in enumerate(cols)})
        else:
            i += 1
    return blocks
