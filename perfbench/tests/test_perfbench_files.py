"""Every configuration, cell, metric and kernel roofline of BENCHMARK.json
is a file found by its name, loads, and keeps to the benchmark's rules."""

import json
import re

from conftest import ROOT

from perfbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {"ns_per_day",
                                                         "setup_s"}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_loads():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["chunk_steps"] > 0
        assert cell["limits"]
        assert cell["per_layer"] and cell["end_to_end"]


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        reader = harness.load_module(ROOT / "perfbench" / "metrics"
                                     / f"{m['name']}.py")
        assert reader.LAYER == m["layer"]
        assert reader.UNIT == m["unit"]
        assert reader.MOVES == m["moves"]
        assert reader.read(dict(spans={}, counters={}, phases={})) is None


def test_every_roofline_loads():
    roof = harness.rooflines()
    assert {"K4", "K5", "K7", "K8"} <= set(roof)
    for k, m in roof.items():
        assert m.PARTS and m.COUNTER and callable(m.cost)


def test_config_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
