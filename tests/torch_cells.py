"""Shared cells and inputs for the port's parity tests (test_torch_*.py).

S1 is the 96-atom entry cell, S2 a 640-atom cell that spans five 128-atom
z tiles, S3 the 562-atom cell whose box is four cutoffs wide (the JAX
package's Verlet-list and tiled-PPPM engine tests), S4 a 712-atom cell
whose exact Ewald sum has more than KXY_CHUNK xy vectors.  ``x_near`` puts ions within the cutoff of both walls, where the
electrode rows and the Gaussian correction are nonzero.

IL_SMALL is the ionic-liquid cell of ``workloads.write_il_data`` at the
test size: 40 ion pairs between one 96-atom graphene sheet per wall, 352
atoms, 40 SHAKE clusters; ``il_small`` reads it through a package's deck
function with the cutoff and the k-space accuracy cut (IL_SMALL_MD) so that
the 14.76 A box holds two cutoffs.
"""

import dataclasses

import numpy as np
import torch

S1 = dict(n_elyte=64, nele_side=4)
S2 = dict(n_elyte=512, nele_side=8, lz=60.0, lxy=24.0)
S3 = dict(n_elyte=512, nele_side=5, lz=36.0, lxy=20.0)
S4 = dict(n_elyte=512, nele_side=10, lz=36.0, lxy=80.0)

# the port's entry points run on the card by default: the CPU tests ask
# for the CPU, in float64 (SOLVE64 for setup_conp, CPU64 for build_engine
# and the interop functions)
SOLVE64 = dict(solve_dtype=torch.float64, device="cpu")
CPU64 = dict(dtype=torch.float64, device="cpu")


def pppm_cell(wl, kspace_enum, cell=S3, **md_kw):
    """(system, md, cfg) of ``wl.synthetic(**cell)`` with PPPM in both the
    charge solve and the forces; ``md_kw`` replaces MDConfig fields."""
    system, md, cfg = wl.synthetic(**cell)
    md = dataclasses.replace(md, kspace_style=kspace_enum.PPPM, **md_kw)
    cfg = dataclasses.replace(cfg, kspace=kspace_enum.PPPM)
    return system, md, cfg


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


# the test-size fixture and its cuts, shared with shake_residual --cell small
from lammps_user_conp2_tpu_torch.shake_residual import (  # noqa: E402
    SMALL as IL_SMALL, SMALL_MD as IL_SMALL_MD)


def il_small_file(directory):
    """Write the test-size ionic-liquid data file into ``directory``."""
    from lammps_user_conp2_tpu_torch.workloads import write_il_data
    return write_il_data(f"{directory}/il_small.data", **IL_SMALL)


def il_small(wl, path, deck="il_onelayer", n=0):
    """(system, md, cfg) of ``wl.<deck>(n)`` on the file at ``path``, with
    IL_SMALL_MD in the MDConfig."""
    system, md, cfg = getattr(wl, deck)(n, data_path=str(path))
    return system, dataclasses.replace(md, **IL_SMALL_MD), cfg


def tile_rows(geom, seed, *, empty=0.2, heavy=None):
    """Random slot rows (T, 8, cap) float64 for a ``TileGeom``: each tile
    holds a random count of atoms in its first slots (a share ``empty`` of
    the tiles none), with origins over the whole patch range including the
    drift margin, fractional offsets in [-1/2, 1/2] and about one charge
    in five zero; the top z bin empty, as a slab's guard bins are; tile
    ``heavy`` is full, every origin inside the tile."""
    rng = np.random.default_rng(seed)
    dm2 = 2 * geom.dm
    rows = np.zeros((geom.t_tiles, 8, geom.cap))
    for t in range(geom.t_tiles):
        if t != heavy and (rng.random() < empty
                           or t % geom.ntz == geom.ntz - 1):
            continue
        c = geom.cap if t == heavy else int(rng.integers(1, geom.cap + 1))
        lo = geom.dm + 2 if t == heavy else 0
        rows[t, 0, :c] = rng.integers(lo, geom.tlx + dm2 - lo, c)
        rows[t, 1, :c] = rng.integers(lo, geom.tly + dm2 - lo, c)
        rows[t, 2, :c] = rng.integers(0, geom.tlz + dm2, c)
        rows[t, 3:6, :c] = rng.uniform(-0.5, 0.5, (3, c))
        q = rng.standard_normal(c)
        if t != heavy:
            q[rng.random(c) < 0.2] = 0.0
        rows[t, 6, :c] = q
    return torch.as_tensor(rows)


# hand-built SHAKE tables, one per LAMMPS cluster shape (fix shake's
# shake2, shake3, shake4 and shake3angle, central atom first), the il
# decks' linear 3-site cation (slots (0,1), (1,2), (0,2)) and a table that
# mixes every shape, padded as ``models.shake.build_constraints`` pads it
SHAKE_SHAPES = {
    "shake2": [[(0, 1)]],
    "shake3": [[(0, 1), (0, 2)]],
    "shake4": [[(0, 1), (0, 2), (0, 3)]],
    "shake3angle": [[(0, 1), (0, 2), (1, 2)]],
    "linear3": [[(0, 1), (1, 2), (0, 2)]],
    "mixed": [[(0, 1)], [(0, 1), (0, 2)], [(0, 1), (0, 2), (0, 3)],
              [(0, 1), (0, 2), (1, 2)]],
}
SHAKE_BOX = (19.0, 21.0, 30.0)
SHAKE_PERIODIC = (True, True, False)


def shake_case(shape, kind="interior", seed=0, nclusters=24, nfree=37):
    """A hand-built SHAKE system: dict(tables=(atoms, amask, ci, cj, dist2,
    cmask, invm, pairs), natoms, x_old, x_new, v, box, periodic), float64
    numpy.  Clusters of ``SHAKE_SHAPES[shape]`` in turn, bonds of 1-1.6 A
    from the first atom (chained for linear3), ``nfree`` unconstrained
    atoms, every row order shuffled; x_old satisfies the constraints,
    x_new is x_old plus 0.05 A noise.  ``kind``: "interior"; "straddle",
    every cluster's first atom 0.2 A inside the periodic x face, the rest
    across it; "near_tie", one more two-atom cluster whose x_new and x_old
    bond lies along x with |d / L| = 0.5 - 1e-6."""
    rng = np.random.default_rng(seed)
    box = np.array(SHAKE_BOX)
    shapes = SHAKE_SHAPES[shape]
    clusters = [shapes[i % len(shapes)] for i in range(nclusters)]
    if kind == "near_tie":
        clusters.append([(0, 1)])
    sizes = [1 + max(j for _, j in c) for c in clusters]
    natoms = sum(sizes) + nfree
    perm = rng.permutation(natoms)
    x = np.empty((natoms, 3))
    x[:] = rng.uniform((0, 0, 3), (box[0], box[1], box[2] - 3), (natoms, 3))
    K = max(sizes)
    C = max(len(c) for c in clusters)
    M = len(clusters)
    atoms = np.zeros((M, K), np.int64)
    amask = np.zeros((M, K), bool)
    ci = np.zeros((M, C), np.int64)
    cj = np.zeros((M, C), np.int64)
    dist2 = np.ones((M, C))
    cmask = np.zeros((M, C), bool)
    pairs = []
    start = 0
    near = kind == "near_tie"
    for m, (cons, k) in enumerate(zip(clusters, sizes)):
        rows = perm[start:start + k]
        start += k
        base = rng.uniform((0, 0, 5), (box[0], box[1], box[2] - 5))
        if kind == "straddle":
            base[0] = 0.2
        pos = [base]
        for a in range(1, k):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            prev = pos[a - 1] if shape == "linear3" else pos[0]
            pos.append(prev + rng.uniform(1.0, 1.6) * u)
        if near and m == M - 1:
            pos = [base, base + np.array([(0.5 - 1e-6) * box[0], 0.0, 0.0])]
        pos = np.array(pos)
        pos[:, 0] %= box[0]
        pos[:, 1] %= box[1]
        x[rows] = pos
        atoms[m, :k] = rows
        atoms[m, k:] = rows[0]
        amask[m, :k] = True
        for s, (i, j) in enumerate(cons):
            d = pos[i] - pos[j]
            d[:2] -= box[:2] * np.round(d[:2] / box[:2])
            ci[m, s], cj[m, s] = i, j
            dist2[m, s] = float(d @ d)
            cmask[m, s] = True
            pairs.append((rows[i], rows[j]))
    mass = rng.uniform(1.0, 16.0, natoms)
    invm = np.where(amask, 1.0 / mass[atoms], 0.0)
    x_new = x + rng.normal(0.0, 0.05, x.shape)
    if near:
        x_new[atoms[-1]] = x[atoms[-1]]
    x_new[:, :2] %= box[:2]
    v = rng.normal(0.0, 0.01, x.shape)
    return dict(tables=(atoms, amask, ci, cj, dist2, cmask, invm, pairs),
                natoms=natoms, x_old=x, x_new=x_new, v=v,
                box=tuple(box), periodic=SHAKE_PERIODIC)
