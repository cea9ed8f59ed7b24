"""A whole run of a cell on the CPU, the look for a chip skipped: the
program as it is comes out correct, and with its timed path broken
underneath it does not (a step that returns its state unchanged, half
the atoms' forces left out, an electrode charge altered where the solve
produces it, the step's closing kick left out).  The cell's own limits
decide; the exchange between chips has no fault to plant: every cell runs
on one chip.  Every fault on the dilute cell; the state left unchanged
and the closing kick left out on the il cells too, which compare no
velocities: the charges and forces after the first step catch the one,
those after the second step (whose positions carry the velocities after
the first) the other."""

import time

import pytest
import torch

from perfbench import faults, harness


def run(cell="dilute0", seed=2 ** 31 + 11):
    c = harness.load_cell(cell)
    c["traffic"] = dict(c["traffic"], chunk_steps=4, thermo_every=2)
    return harness.run_cell(c, seed, 0.2, False, device="cpu",
                            dtype=torch.float64, t_start=time.perf_counter(),
                            min_chunks=3, log=lambda m: None)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert set(out["metrics"]) == {"ns_per_day", "setup_s"}


@pytest.mark.parametrize("cell,fault", [
    ("dilute0", "unchanged"), ("dilute0", "half_forces"),
    ("dilute0", "altered_charge"), ("dilute0", "no_closing_kick"),
    ("il0", "unchanged"), ("il0", "no_closing_kick"), ("il4", "unchanged")])
def test_fault_is_not_correct(cell, fault):
    undo = faults.plant(fault)
    try:
        out = run(cell)
    finally:
        undo()
    failed = [name for name, v, lim in out["checks"] if not v <= lim]
    assert not out["correct"] and failed, out["checks"]
