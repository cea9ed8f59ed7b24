"""The plain reference agrees with the program's float64 CPU engine (its
plain versions): the charges, the fix scalar, the forces, the energy and
two steps, for each cell's deck and trial (the il0 deck on a small
ionic-liquid cell with SHAKE).  And the control, the reference in TF32
in the program's place, fails the cell's own limits where the program
passes them."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from conftest import IL_SMALL_MD, ROOT

from perfbench import harness, judge
from perfbench.reference.conp_md import Reference, tf32_round
from perfbench.reference.deck import build_deck

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def program_and_deck(deck, path, traffic, small=False, steps=3):
    """The program's float64 CPU engine a few steps on, the reference's deck
    of the same file, and the state's answers as the program gives them."""
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    cfg = json.loads((ROOT / f"perfbench/configs/{deck}.json").read_text())
    system, md, ccfg = getattr(workloads, deck)(traffic["trial"],
                                                data_path=str(path))
    if small:
        md = dataclasses.replace(md, **IL_SMALL_MD)
        cfg["deck"].update(IL_SMALL_MD)
    conp = setup_conp(system, md, ccfg, solve_dtype=torch.float64,
                      device="cpu")
    eng = build_engine(system, md, conp, dtype=torch.float64, device="cpu")
    st = eng.init_state()
    for _ in range(steps):
        st = eng.step(st)
    d = build_deck(str(path), cfg, traffic)
    rows = np.searchsorted(d.tag, system.tag)

    def to_ref(t):
        a = t.detach().double().numpy()
        out = np.empty_like(a)
        out[rows] = a
        return out

    hs = dict(x=to_ref(st.x), v=to_ref(st.v), xi=st.nhc_xi.numpy(),
              vxi=st.nhc_vxi.numpy(), q0=d.q0)
    after = lambda s: dict(x=to_ref(s.x), v=to_ref(s.v), q=to_ref(s.q),
                           f=to_ref(s.f), pe=float(s.energy),
                           scalar=float(s.scalar_out))
    nxt = eng.step(st)
    got = dict(q=to_ref(st.q), scalar=float(st.scalar_out), f=to_ref(st.f),
               pe=float(st.energy),
               row={k: float(v) for k, v in eng.thermo(st).items()
                    if k != "step"},
               next=after(nxt), next2=after(eng.step(nxt)))
    return d, hs, got


@pytest.fixture(scope="module", params=[w["name"] for w in BENCH["workloads"]])
def case(request, dilute_file, il_small_file, il_file):
    cell = harness.load_cell(request.param)
    deck = cell["config"]["name"]
    # il0 on the small cell; il4's mesh needs the deck's own size and
    # accuracy to stay within the cell's limits
    small = request.param == "il0"
    path = {"dilute": dilute_file,
            "il_onelayer": il_small_file if small else il_file}[deck]
    d, hs, got = program_and_deck(deck, path, cell["traffic"], small)
    ref = judge.model_answers(Reference(d, "cpu"), hs)
    return cell, d, hs, got, ref


def test_reference_agrees_with_the_program(case):
    cell, d, hs, got, ref = case
    r = judge.readings([(hs, got, ref)], d)
    # the same arithmetic in float64; under PPPM the mesh's own error
    # against the exact Ewald sum (1.4e-5 of max|q| at the il cell)
    tol = 3e-5 if cell["traffic"]["trial_settings"]["kspace"] == "PPPM" \
        else 1e-11
    for name, v in r.items():
        assert v <= tol, (name, v)
    assert np.abs(ref["q"][d.ele]).max() > 0.0
    assert d.excl or not len(d.bonds)
    assert judge.verdict(r, cell["limits"])[0]


def test_control_fails_the_cells_limits(case):
    cell, d, hs, got, ref = case
    ctl = judge.model_answers(Reference(d, "cpu", tf32=True), hs)
    r = judge.readings([(hs, ctl, ref)], d)
    ok, checks = judge.verdict(r, cell["limits"])
    assert not ok, checks


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159265],
                     dtype=torch.float32)
    y = tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2.0 ** -10
    assert abs(float(y[3]) - 3.14159265) < 2.0 ** -9
    m, _ = torch.frexp(y)
    assert torch.all(m * 2048.0 == torch.round(m * 2048.0))


@pytest.mark.parametrize("deck,old,new", [
    ("il_onelayer", "\n2 500 2.5\n", "\n2 500 2.6\n"),
    ("il_onelayer", "\n4 144.96", "\n4 144.9"),
    ("dilute", "\n3 196.97", "\n3 196.9")])
def test_deck_refuses_a_file_with_another_force_field(
        deck, old, new, il_small_file, dilute_file, tmp_path):
    """The reference takes the force field from the configuration, and a
    data file that lists other coefficients or masses is refused."""
    cell = harness.load_cell({"il_onelayer": "il0", "dilute": "dilute0"}[deck])
    src = {"il_onelayer": il_small_file, "dilute": dilute_file}[deck]
    text = open(src).read()
    assert build_deck(str(src), cell["config"], cell["traffic"]).natoms
    assert text.count(old) == 1
    bad = tmp_path / "data"
    bad.write_text(text.replace(old, new))
    with pytest.raises(ValueError, match="configuration"):
        build_deck(str(bad), cell["config"], cell["traffic"])
