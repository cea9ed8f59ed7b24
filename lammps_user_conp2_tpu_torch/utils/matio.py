"""A-matrix files in the reference's format (the matout / org / inv
keywords).

Format (fix_conp.cpp:833-849, 960-977): the first line holds the electrode
tags (%20d each), then one line per electrode row, %20.12f per entry
(``amatrix``) or %20.10f (``inv_a_matrix``).  Reading permutes rows and
columns by tag to the caller's electrode order (fix_conp.cpp:721-773).
"""

from __future__ import annotations

import numpy as np


def write_matrix(path: str, tags: np.ndarray, mat: np.ndarray,
                 digits: int = 12) -> None:
    """Write ``mat`` (Ne, Ne) with the electrode ``tags`` as its header."""
    ne = len(tags)
    mat = np.asarray(mat)
    if mat.shape != (ne, ne):
        raise ValueError(f"matrix of shape {mat.shape} for {ne} tags")
    with open(path, "w") as f:
        f.write(" " + "".join(f"{int(t):20d}" for t in tags) + "\n")
        for i in range(ne):
            f.write(" " + " ".join(f"{v:20.{digits}f}" for v in mat[i]) + "\n")


def read_matrix(path: str, want_tags: np.ndarray):
    """(tags, matrix) of the file at ``path`` with rows and columns in the
    order of ``want_tags``; raises ValueError when the file's entries do
    not fill an Ne x Ne matrix or a wanted tag is missing."""
    with open(path) as f:
        tags = np.array([int(t) for t in f.readline().split()])
        vals = np.asarray(f.read().split(), dtype=np.float64)
    ne = len(tags)
    if vals.size != ne * ne:
        raise ValueError(
            f"A-matrix file {path} has {vals.size} entries, expected {ne * ne}")
    pos = {int(t): i for i, t in enumerate(tags)}
    try:
        perm = np.array([pos[int(t)] for t in np.asarray(want_tags)])
    except KeyError as e:
        raise ValueError(f"electrode tag {e} missing from {path}") from None
    return tags[perm], vals.reshape(ne, ne)[np.ix_(perm, perm)]
