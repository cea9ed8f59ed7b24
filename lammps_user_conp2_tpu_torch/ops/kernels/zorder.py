"""Per-step z ordering shared by the pair and electrode-row kernels.

Both CUDA sweeps (``pair_kernel``, ``ele_rows_kernel``) cull column tiles
or windows by z, which needs the atoms sorted by (wrapped) z.  All run at
the same positions within a step, so the (N,) sort is computed once, by
the charge solve, and handed to the force path with the factored-Ewald
tables.

Any permutation is correct: the culling bounds are read from the same
sorted keys the kernels use, so a poor order only loosens them.  Ties may
sort differently from ``jnp.argsort``; nothing depends on their order.

The bound tests carry a +1e-3 Angstrom margin (Z_MARGIN): the sort keys and
the kernels' minimum-image distances are computed by different float
expressions, and a pair within a few ulps of the cutoff must never be
dropped by a bound that rounded the other way.
"""

from __future__ import annotations

import torch

Z_MARGIN = 1e-3


def wrap_z(z, lz, zperiodic):
    if zperiodic:
        return z - lz * torch.floor(z * (1.0 / lz))
    return z


def z_perm(x, box, periodic):
    """(perm, z_sorted): the atom order by wrapped z, and the sorted keys."""
    zs = wrap_z(x[:, 2], float(box[2]), bool(periodic[2]))
    zsorted, perm = torch.sort(zs)
    return perm, zsorted
