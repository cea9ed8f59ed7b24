"""The roofline files give the bounds the program's chip runs recorded
(PERF.md's kernel table: K4 and K5 at the il and dilute cells, K7 and K8
at the il cell, at the x0 of the files those runs used, seed 0; K1, K2a
and K3 at the 100k cell, at the sizes its program hands them), and the
list and mesh kernels have none in the cells, which run neither."""

import json
import math

import pytest
import torch
from conftest import ROOT

from perfbench import harness, peaks
from perfbench.reference.conp_md import ERFC_MAX, pppm_grid
from perfbench.reference.deck import QQR2E, build_deck

TRAFFIC = json.loads((ROOT / "perfbench/traffic/trial0.json").read_text())
# ms per call, as PERF.md prints them (6 decimals)
RECORDED = {"il_onelayer": dict(K4=0.001143, K5=0.000090, K7=0.000050,
                                K8=0.000035),
            "dilute": dict(K4=0.000007, K5=0.000011)}
# the program's 100k cell (step_breakdown_large.large_cell, built on its
# x0) at near_wall_positions, as harness.shapes and program_sizes read it
# there (measured on one H100)
SHAPES_100K = dict(natoms=99362, ntypes=3, pairs=454380, ele_pairs=7738,
                   charged_elyte=98304, list_blocks=12421, union_width=160,
                   block_atoms=8, mesh=(144, 144, 750), order=5,
                   tiles=(9, 9, 10), tile=(16, 16, 32), tile_border=3,
                   slot_cap=320)
RECORDED_100K = dict(K1=0.003915, K2a=0.010422, K3=0.013613)


@pytest.mark.parametrize("deck", sorted(RECORDED))
def test_bounds_as_recorded(deck, tmp_path):
    from lammps_user_conp2_tpu_torch import workloads
    cfg = json.loads((ROOT / f"perfbench/configs/{deck}.json").read_text())
    path = getattr(workloads, cfg["writer"]["name"])(tmp_path / "data",
                                                     seed=0)
    d = build_deck(path, cfg, TRAFFIC)
    g, _ = pppm_grid(d.box, d.accuracy * QQR2E, d.natoms,
                     float((d.q0 ** 2).sum()) * QQR2E, d.cutoff)
    cut = min(d.cutoff ** 2, (ERFC_MAX / g) ** 2)
    sh = harness.shapes(d, cut, torch.as_tensor(d.x0))
    roof = harness.rooflines()
    for k, ms in RECORDED[deck].items():
        got = peaks.bound_s(*roof[k].cost(sh)) * 1e3
        assert round(got, 6) == pytest.approx(ms, abs=1e-12), (k, got)
    if deck == "dilute":
        assert roof["K7"].cost(sh) is None
    # no list and no tiled mesh in these cells: kernels.roofline reads as
    # it did without the files
    for k in ("K1", "K2a", "K3"):
        assert roof[k].cost(sh) is None
        assert roof[k].cost(dict(sh, mesh=(30, 32, 80), order=5)) is None


def test_list_and_mesh_bounds_as_recorded():
    roof = harness.rooflines()
    for k, ms in RECORDED_100K.items():
        b, ops = roof[k].cost(SHAPES_100K)
        got = peaks.bound_s(b, ops) * 1e3
        assert b / peaks.HBM_BYTES_PER_S > ops / peaks.F32_FLOP_PER_S, k
        assert round(got, 6) == pytest.approx(ms, abs=1e-12), (k, got)


@pytest.mark.parametrize("name", [
    "pair_sweep", "pair_reduce", "pair_reduce_items", "pair_schedule",
    "b_order_kernel", "b_rows_kernel", "shake_rows_kernel", "shake_kernel",
    "rattle_kernel", "integrate_half_kernel", "integrate_sums_kernel",
    "spread_tiles_kernel", "corr_ele_kernel",
    "void_at::native::_scatter_gather_elementwise_kernel_128__8__at::",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_war"])
def test_other_kernels_are_not_the_list_and_mesh_kernels(name):
    """The device kernels of the cells (hand kernels and the library's)
    belong to no part of K1, K2a or K3."""
    from perfbench import devtrace
    roof = harness.rooflines()
    parts = {k: m.PARTS for k, m in roof.items()}
    assert devtrace.kernel_of(name, parts) not in ("K1", "K2a", "K3")
    assert devtrace.kernel_of("block_pair_reduce", parts) == "K1"


def test_bound_is_the_larger_side():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert math.isclose(peaks.bound_s(1.0, 67e12), 1.0)
