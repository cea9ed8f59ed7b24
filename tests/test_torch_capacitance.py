"""The port's capacitance estimators (``capacitance.py``) against the
repository's ``tools/capacitance.py`` (imported from its file, unchanged),
float64 on the CPU, on the file of ``workloads.write_dilute_data`` and the
test-size ionic-liquid file:

* the static estimate (the set-up's totsetq, e/V) on the port's solver
  equals the tool's on the JAX solver of the same deck to 1e-10 relative,
  and equals the solver's own float64 totsetq whatever the solve dtype;
* the fluctuation estimate equals the tool's on the same series, units and
  temperature;
* ``python -m lammps_user_conp2_tpu_torch.capacitance dilute 0 --cpu``
  runs (in process): the static value as the set-up's, a finite positive
  fluctuation estimate over the sampled rows.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu_torch import capacitance, workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from torch_cells import SOLVE64, il_small_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "capacitance_tool", os.path.join(REPO, "tools", "capacitance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    twl.write_dilute_data(d / "dilute" / "data")
    il_small_file(d)
    return d


@pytest.mark.parametrize("deck", ["dilute", "il_onelayer"])
def test_static_matches_the_tool(tool, ref_dir, deck):
    path = str(ref_dir / ("dilute/data" if deck == "dilute"
                          else "il_small.data"))
    ts, tmd, tcfg = getattr(twl, deck)(0, data_path=path)
    js, jmd, jcfg = getattr(jwl, deck)(0, data_path=path)
    t = tsetup(ts, tmd, tcfg, **SOLVE64)
    got = capacitance.static_capacitance(t)
    ref = tool.static_capacitance(jsetup(js, jmd, jcfg))
    assert got == pytest.approx(ref, rel=1e-10)
    assert got == float(t.totsetq) and got != 0.0
    # a float32 solve keeps the float64 set-up's value
    t32 = tsetup(ts, tmd, tcfg, solve_dtype=torch.float32, device="cpu")
    assert capacitance.static_capacitance(t32) == got
    assert t32.totsetq.dtype == torch.float32


def test_fluctuation_matches_the_tool(tool):
    system, _, _ = twl.synthetic()
    units = system.units()
    rng = np.random.default_rng(3)
    for n, temp in ((40, 298.0), (401, 500.0)):
        series = 0.05 + 1e-3 * rng.standard_normal(n)
        got = capacitance.fluctuation_capacitance(series, temp, units)
        assert got == tool.fluctuation_capacitance(series, temp, units)
        assert got > 0.0
    assert capacitance.fluctuation_capacitance(np.full(7, 0.3), 300.0,
                                               units) == 0.0


def test_main_on_the_dilute_deck(ref_dir, monkeypatch, capsys):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    r = capacitance.estimate("dilute", 0, 20, 2, device="cpu")
    system, md, cfg = twl.dilute(0)
    c = float(tsetup(system, md, cfg, **SOLVE64).totsetq)
    assert r["static"] == c and r["samples"] == 10
    assert np.isfinite(r["fluctuation"]) and r["fluctuation"] > 0.0
    assert r["temp_mean"] > 0.0
    assert capacitance.main(["dilute", "0", "--steps", "20", "--thermo", "2",
                             "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"static capacitance dQ_left/dV = {c:.17g} e/V")
    assert out[1].startswith("fluctuation capacitance <dQ^2>/(kB T) = ")
    assert out[1].endswith("over 10 samples")
