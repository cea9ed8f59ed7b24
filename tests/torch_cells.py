"""Shared cells and inputs for the port's parity tests (test_torch_*.py).

S1 is the 96-atom entry cell, S2 a 640-atom cell that spans five 128-atom
z tiles.  ``x_near`` puts ions within the cutoff of both walls, where the
electrode rows and the Gaussian correction are nonzero.
"""

import numpy as np

S1 = dict(n_elyte=64, nele_side=4)
S2 = dict(n_elyte=512, nele_side=8, lz=60.0, lxy=24.0)


def x_near(system):
    from lammps_user_conp2_tpu_torch.workloads import near_wall_positions
    return near_wall_positions(system)


def x_close(system):
    """Ions mapped onto [3, lz-3]: within 1 A of the walls' planes, where
    the Gaussian correction (clamped at eta r = ERFC_MAX, r < 2.93 A) is
    large rather than ~1e-14."""
    from lammps_user_conp2_tpu_torch.workloads import near_wall_positions
    return near_wall_positions(system, margin=3.0)


def charges_with_electrodes(system, seed=1, scale=0.05):
    """q0 with random nonzero electrode charges (numpy default_rng)."""
    rng = np.random.default_rng(seed)
    q = np.array(system.q0, np.float64)
    q[system.ele_mask] = scale * rng.standard_normal(int(system.ele_mask.sum()))
    return q


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))
