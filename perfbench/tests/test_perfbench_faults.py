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
the first) the other.  The integrator's faults are planted on the
kernel's entry with stage sequences the kernel runs, so that they run on
the card too."""

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
    ("dilute0", "no_closing_thermostat"), ("il0", "unchanged"),
    ("il0", "no_closing_kick"), ("il4", "unchanged")])
def test_fault_is_not_correct(cell, fault):
    undo = faults.plant(fault)
    try:
        out = run(cell)
    finally:
        undo()
    failed = [name for name, v, lim in out["checks"] if not v <= lim]
    assert not out["correct"] and failed, out["checks"]


@pytest.mark.parametrize("fault,dropped", [("no_closing_kick", "kick"),
                                           ("no_closing_thermostat", "nhc")])
def test_integrator_faults_pass_the_kernel_its_stages(fault, dropped):
    """Each stage sequence the engine hands K10's entry (the first half;
    the second half without SHAKE, and its two pieces around RATTLE) goes
    on whole in the first half, and in the second without the stage the
    fault leaves out: always one of the sequences the kernel runs
    (``integrate_kernel.STAGES``), or, where nothing is left, the input
    back."""
    from lammps_user_conp2_tpu_torch.models import md
    from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel
    seen = []
    inner = md.integrate_half
    md.integrate_half = lambda itg, v, f, x, xi, vxi, stages: (
        seen.append(stages) or (v, x, xi, vxi))
    undo = faults.plant(fault)
    try:
        for stages in integrate_kernel.STAGES:
            before = len(seen)
            out = md.integrate_half("itg", "v", "f", "x", "xi", "vxi",
                                    stages)
            if stages[0] == "nhc" and stages != ("nhc",):
                assert seen[before:] == [stages]
            elif stages == (dropped,):
                assert seen[before:] == [] and out == ("v", "x", "xi", "vxi")
            else:
                assert seen[before:] == [tuple(x for x in stages
                                               if x != dropped)]
    finally:
        undo()
        md.integrate_half = inner
    assert set(seen) <= set(integrate_kernel.STAGES)
