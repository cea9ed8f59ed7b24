"""The roofline files give the bounds the program's chip runs recorded
(PERF.md's kernel table: K4 and K5 at the il and dilute cells, K7 and K8
at the il cell), at the x0 of the files those runs used (seed 0)."""

import json
import math

import pytest
import torch
from conftest import ROOT

from perfbench import harness, peaks
from perfbench.reference.conp_md import ERFC_MAX, g_ewald_pppm
from perfbench.reference.deck import QQR2E, build_deck

TRAFFIC = json.loads((ROOT / "perfbench/traffic/trial0.json").read_text())
# ms per call, as PERF.md prints them (6 decimals)
RECORDED = {"il_onelayer": dict(K4=0.001143, K5=0.000090, K7=0.000050,
                                K8=0.000035),
            "dilute": dict(K4=0.000007, K5=0.000011)}


@pytest.mark.parametrize("deck", sorted(RECORDED))
def test_bounds_as_recorded(deck, tmp_path):
    from lammps_user_conp2_tpu_torch import workloads
    cfg = json.loads((ROOT / f"perfbench/configs/{deck}.json").read_text())
    path = getattr(workloads, cfg["writer"]["name"])(tmp_path / "data",
                                                     seed=0)
    d = build_deck(path, cfg, TRAFFIC)
    g = g_ewald_pppm(d.box, d.accuracy * QQR2E, d.natoms,
                     float((d.q0 ** 2).sum()) * QQR2E, d.cutoff)
    cut = min(d.cutoff ** 2, (ERFC_MAX / g) ** 2)
    sh = harness.shapes(d, cut, torch.as_tensor(d.x0))
    roof = harness.rooflines()
    for k, ms in RECORDED[deck].items():
        got = peaks.bound_s(*roof[k].cost(sh)) * 1e3
        assert round(got, 6) == pytest.approx(ms, abs=1e-12), (k, got)
    if deck == "dilute":
        assert roof["K7"].cost(sh) is None


def test_bound_is_the_larger_side():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert math.isclose(peaks.bound_s(1.0, 67e12), 1.0)
