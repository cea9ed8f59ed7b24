"""The reference's PPPM mesh (``perfbench/reference/pppm.py``) and its
blocked pair sums, on the CPU: against the exact Ewald sum, whose gap
follows the stated accuracy; against the program's float64 PPPM on a
small synthetic capacitor, ik and the ad gradient within 1e-9; its
pieces (the B-spline weights, the aliasing sums, the self-force) against
their definitions; the exclusions set per block as the dense matrix set
them; and the synthetic state's file as both sides read it."""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench.proof import run as proof
from perfbench.proof import state as proof_state
from perfbench.reference import pppm
from perfbench.reference.conp_md import Reference, slab_mesh
from perfbench.reference.deck import QQR2E, build_deck

# a capacitor whose mesh the reference's rule and the program's agree on
# (24 x 24 x 40, 120 in z over the slab), and a smaller one
SMALL = dict(n_elyte=400, nele_side=4, lz=40.0, lxy=20.0)
TINY = dict(n_elyte=64, nele_side=4, lz=30.0, lxy=12.0)


def deck_of(path, diff="ad", accuracy=None):
    cfg, traffic = proof.load()
    cfg = copy.deepcopy(cfg)
    if diff is None:
        del cfg["deck"]["pppm_diff"]
    else:
        cfg["deck"]["pppm_diff"] = diff
    if accuracy is not None:
        cfg["deck"]["kspace_accuracy"] = accuracy
    return build_deck(str(path), cfg, traffic)


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    return proof_state.write_data(tmp_path_factory.mktemp("syn") / "data",
                                  2 ** 31 + 7, **SMALL)


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    return proof_state.write_data(tmp_path_factory.mktemp("tiny") / "data",
                                  3, **TINY)


def charged(d):
    """The file's charges with the electrodes given some."""
    q = torch.as_tensor(d.q0).clone()
    rng = np.random.default_rng(0)
    q[torch.as_tensor(d.ele)] = torch.as_tensor(
        rng.normal(0.0, 0.05, int(d.ele.sum())))
    return q


@pytest.mark.parametrize("accuracy", [1e-7, 1e-4])
@pytest.mark.parametrize("diff", ["ik", "ad"])
def test_mesh_against_ewald_follows_the_accuracy(tiny_file, diff, accuracy):
    """The RMS gap of the k-space forces between the mesh and the exact
    Ewald sum is about the stated absolute accuracy (accuracy x qqr2e,
    the force between two unit charges 1 A apart): 0.6 to 1.5 of it in
    these runs."""
    got, ewald = (Reference(deck_of(tiny_file, d, accuracy), "cpu")
                  for d in (diff, None))
    d = ewald.deck
    x, q = torch.as_tensor(d.x0), charged(d)
    (e1, f1), (e2, f2) = got.kspace(x, q), ewald.kspace(x, q)
    rms = float((f1 - f2).pow(2).sum(1).mean().sqrt()) * QQR2E
    assert 0.2 < rms / (accuracy * QQR2E) < 3.0, rms
    assert abs(float(e1 - e2)) < 1e-3 * abs(float(e2))


def program_state(path, diff):
    """The program's float64 CPU engine's first state on the file, with
    ``pppm_diff`` set."""
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    system, md, cfg = proof_state.program_deck(path, **SMALL)
    md = dataclasses.replace(md, pppm_diff=diff)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float64,
                      device="cpu")
    eng = build_engine(system, md, conp, dtype=torch.float64, device="cpu")
    return eng, eng.init_state()


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("diff", ["ik", "ad"])
def test_mesh_equals_the_programs_pppm(small_file, diff):
    """q, forces and pe of the reference's mesh within 1e-9 of the
    program's float64 PPPM (dense mesh) at the same state.  The program's
    ad differentiates the potential that the ik influence function gives
    and subtracts no self-force; the reference's ad is LAMMPS's
    (compute_gf_ad, the self-force), so its ad gradient is held to the
    program's with those two set as the program has them, and LAMMPS's ad
    differs by what they add."""
    eng, st = program_state(small_file, diff)
    ref = Reference(deck_of(small_file, diff), "cpu")
    assert eng.pppm_grid.shape == ref.mesh.dims
    d = ref.deck
    if diff == "ad":
        lammps = ref.forces(st.x, ref.solve(st.x, torch.as_tensor(d.q0))[0])
        ref.mesh.greens = Reference(deck_of(small_file, "ik"),
                                    "cpu").mesh.greens
        ref.mesh.sf = [0.0] * 6
    q, _ = ref.solve(st.x, torch.as_tensor(d.q0))
    f, pe = ref.forces(st.x, q)
    assert rel(st.q[d.ele], q[d.ele]) < 1e-9
    assert rel(st.f, f) < 1e-9
    assert abs(float(st.energy - pe)) < 1e-9 * abs(float(pe))
    if diff == "ad":
        assert rel(lammps[0], f) > 1e-6


def test_bspline_weights_are_lammps_rho1d():
    """The recursion's weights equal LAMMPS's tabulated polynomials (the
    program's ``rho_coeffs``, compute_rho_coeff) and their derivative."""
    from lammps_user_conp2_tpu_torch.ops.pppm import rho_coeffs
    cf = torch.as_tensor(rho_coeffs(5))
    dx = torch.linspace(-0.5, 0.5, 101, dtype=torch.float64)
    lam = sum(cf[:, l][None, :] * dx[:, None] ** l for l in range(5))
    dlam = sum(l * cf[:, l][None, :] * dx[:, None] ** (l - 1)
               for l in range(1, 5))
    t = dx[:, None] + torch.arange(-2, 3, dtype=torch.float64)[None, :]
    assert torch.allclose(pppm.bspline(t), lam, rtol=0, atol=1e-14)
    assert torch.allclose(pppm.dbspline(t), dlam, rtol=0, atol=1e-14)
    assert torch.allclose(pppm.bspline(t).sum(1),
                          torch.ones(101, dtype=torch.float64), atol=1e-15)


def test_aliasing_sums():
    """gf_denom's closed form is the sum over images of W^2; two images
    past LAMMPS's bound leave nothing for a third to change."""
    n = 24
    m = pppm.Mesh((20.0, 20.0, 120.0), (0, 0, 0), 0.542, (n, n, 120), "ik",
                  "cpu")
    k = m.kper[0]
    brute = sum(pppm.sinc_pow(math.pi * (k + n * b) / n, 10)
                for b in range(-80, 81))
    s2 = torch.sin(math.pi * k / n) ** 2
    closed = torch.zeros_like(s2)
    for c in reversed(pppm.gf_b()):
        closed = c + closed * s2
    assert torch.allclose(closed, brute, rtol=0, atol=1e-14)
    old = pppm.EXTRA_IMAGES
    try:
        pppm.EXTRA_IMAGES = old + 1
        more = pppm.Mesh((20.0, 20.0, 120.0), (0, 0, 0), 0.542,
                         (n, n, 120), "ik", "cpu").greens
    finally:
        pppm.EXTRA_IMAGES = old
    assert float((more - m.greens).abs().max()) <= 1e-13 * float(
        m.greens.abs().max())


def test_self_force_correction():
    """A lone charge in a periodic box feels no force; the ad mesh gives
    it one that varies with its place between the mesh nodes, and the
    self-force subtraction takes out more than 99% of it."""
    m = pppm.Mesh((10.0, 10.0, 10.0), (0, 0, 0), 0.6, (12, 12, 12), "ad",
                  "cpu")
    x = torch.as_tensor(np.random.default_rng(1).uniform(0, 10, (64, 3)))
    q = torch.ones(1, dtype=torch.float64)
    f = torch.stack([m.energy_forces(x[i:i + 1], q)[1][0]
                     for i in range(64)])
    m.sf = [0.0] * 6
    raw = torch.stack([m.energy_forces(x[i:i + 1], q)[1][0]
                       for i in range(64)])
    assert float(f.abs().max()) < 1e-2 * float(raw.abs().max())


def test_slab_mesh_rule():
    assert slab_mesh((144, 144, 243), 3.0) == (144, 144, 729)
    assert slab_mesh((15, 15, 27), 3.0) == (15, 15, 81)
    assert slab_mesh((30, 32, 80), 0.0) == (30, 32, 80)


def test_blocked_exclusions_equal_the_dense_matrix(il_file):
    """The exclusion factors set per block of rows equal the (N, N)
    matrix the reference built before, row for row."""
    from perfbench import harness
    cell = harness.load_cell("il0")
    d = build_deck(il_file, cell["config"], cell["traffic"])
    ref = Reference(d, "cpu")
    n = d.natoms
    dense = torch.ones((n, n), dtype=torch.float64)
    ex = torch.as_tensor(np.asarray(d.excl))
    dense[ex[:, 0], ex[:, 1]] = 0.0
    dense[ex[:, 1], ex[:, 0]] = 0.0
    every = torch.arange(n)
    for i0 in range(0, n, 512):
        rows = min(512, n - i0)
        assert torch.equal(ref._special(i0, rows, every),
                           dense[i0:i0 + rows])
        some = every[(every * 7 + i0) % 3 != 0]
        assert torch.equal(ref._special(i0, rows, some),
                           dense[i0:i0 + rows][:, some])
    assert len(d.excl) > 0


def test_cells_reach_every_pair_within_the_cutoff(il_file, tmp_path):
    """Each block's columns hold every atom within the cutoff of one of
    its rows, and fewer than all where the box is many cutoffs wide."""
    from perfbench import harness
    cell = harness.load_cell("il0")
    wide = proof_state.write_data(tmp_path / "data", 9, n_elyte=1500,
                                  nele_side=6, lz=40.0, lxy=60.0)
    for d in (build_deck(il_file, cell["config"], cell["traffic"]),
              deck_of(wide)):
        ref = Reference(d, "cpu")
        rng = np.random.default_rng(2)
        x = torch.as_tensor(d.x0 + rng.normal(0.0, 0.3, d.x0.shape))
        c, nc = ref._cells(x)
        n = d.natoms
        fewer = False
        for i0 in range(0, n, 512):
            rows = torch.arange(i0, min(i0 + 512, n))
            cols = ref._reach(c, nc, rows)
            dx = ref._mi(x[rows, None, :] - x[None, :, :])
            near = ((dx * dx).sum(-1) < d.cutoff ** 2).any(0)
            assert near[cols].sum() == near.sum()
            assert torch.all(cols[1:] > cols[:-1])
            fewer |= cols.shape[0] < n
        assert fewer or d.box[0] < 3 * d.cutoff


@pytest.mark.parametrize("solver", ["CG", "CG_MATFREE"])
def test_cg_deck_reads_as_inv(dilute_file, solver):
    """A CG deck's reference is the INV deck's: the same answers, bit for
    bit."""
    from perfbench import harness, judge
    cell = harness.load_cell("dilute0")
    tr = copy.deepcopy(cell["traffic"])
    tr["trial_settings"]["solver"] = solver
    inv = build_deck(dilute_file, cell["config"], cell["traffic"])
    cg = build_deck(dilute_file, cell["config"], tr)
    hs = dict(x=inv.x0, v=inv.v0, xi=np.zeros((1, 3)), vxi=np.zeros((1, 3)),
              q0=inv.q0)
    a = judge.model_answers(Reference(inv, "cpu"), hs)
    b = judge.model_answers(Reference(cg, "cpu"), hs)
    assert np.array_equal(a["q"], b["q"]) and np.array_equal(a["f"], b["f"])
    assert a["pe"] == b["pe"] and a["next2"]["pe"] == b["next2"]["pe"]


def test_deck_refuses_a_mesh_without_pppm(dilute_file):
    from perfbench import harness
    cell = harness.load_cell("dilute0")
    cfg = copy.deepcopy(cell["config"])
    cfg["deck"]["pppm_diff"] = "ad"
    with pytest.raises(NotImplementedError, match="pppm_diff"):
        build_deck(dilute_file, cfg, cell["traffic"])


def test_state_file_as_both_sides_read_it(tiny_file):
    """The synthetic state's file: the reference's deck and the program's
    system hold the same atoms, charges and velocities; the ions start
    near 300 K with no net momentum, the walls at rest."""
    d = deck_of(tiny_file)
    system, md, cfg = proof_state.program_deck(tiny_file, **TINY)
    rows = np.searchsorted(d.tag, system.tag)
    assert np.array_equal(d.x0[rows], system.x0)
    assert np.array_equal(d.v0[rows], system.v0)
    assert np.array_equal(d.q0[rows], system.q0)
    assert d.ele.sum() == 2 * TINY["nele_side"] ** 2
    ion = ~d.ele
    assert np.all(d.v0[d.ele] == 0.0)
    p = (d.mass[ion, None] * d.v0[ion]).sum(0)
    assert np.abs(p).max() < 1e-12
    assert cfg.kspace.name == "PPPM" and cfg.solver.name == "INV"
