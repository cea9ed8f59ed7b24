"""Port vs JAX package: the set-up of the charge and field modes, their
invariants, the cond deck, and the step counter under the graph runner;
float64 on both sides, on the written il file (IL_SMALL).

* Setup: COND's ``setzvec`` and ``vmult``, the FFIELD d vector (its z ramp
  with the lower-half left electrode shifted by one), the EHGO width and
  overlap tables and ``self_diag`` (kappa 0 with u0 'auto', as the il
  deck's trial 4, and kappa 0.5 with an explicit u0) equal the JAX
  package's to 1e-12.
* The invariants of the JAX package's tests/test_cond.py on the written
  file: COND's charges equal CONP's at COND's potential difference, and
  CONQ at CONP's right-electrode charge returns dV = 2.0 to 1e-8.
* The cond deck's trial 4 (COND, FFIELD, PPPM, the feedback field) runs
  20 steps against the JAX engine (test_torch_decks.py's bounds).
* The graph runner with the eager backend (test_torch_step_graph.py's):
  a callable target that varies per step, the feedback field and zmirror's
  period replay bit for bit as the eager steps, and the device step
  counter advances with them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import graphs
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from test_torch_decks import deck_20_steps_match
from test_torch_step_graph import EagerBackend, assert_same_bits
from torch_cells import CPU64, SOLVE64, il_small, il_small_file

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


@pytest.mark.parametrize("deck,n", [("cond", 4), ("il_onelayer", 3),
                                    ("il_onelayer", 4)])
def test_setup_matches(il_path, deck, n):
    js, jmd, jcfg = il_small(jwl, il_path, deck, n)
    ts, tmd, tcfg = il_small(twl, il_path, deck, n)
    jsol = jsetup(js, jmd, jcfg)
    tsol = tsetup(ts, tmd, tcfg, **SOLVE64)
    close = lambda t, j: np.testing.assert_allclose(
        np.asarray(t), np.asarray(j), rtol=1e-12, atol=1e-12)
    close(tsol.d, jsol.ctx.d)
    close(tsol.setzvec, jsol.ctx.setzvec)
    close(tsol.vmult, jsol.ctx.vmult)
    for name in ("eta_ij", "fo_ij", "self_diag"):
        close(getattr(tsol.kernels, name), getattr(jsol.kernels, name))
    assert tsol.ksp.slabflag is False      # FFIELD: z periodic, no slab
    if tcfg.mode.name == "COND":
        assert float(tsol.vmult) != 0.0
        z = ts.x0[tsol.ele_idx, 2]
        lz = ts.box[2]
        left_low = (ts.elecheck[tsol.ele_idx] == 1) & (
            z < ts.box_lo[2] + lz / 2)
        close(tsol.setzvec, np.where(left_low, -z / lz - 1.0, -z / lz))


def test_ehgo_overlap_tables_match(il_path):
    """kappa 0.5 with an explicit u0 (u0 'auto' makes every overlap term
    0): fo != 0; the tables and self_diag equal the JAX package's to
    1e-12, A^-1 to 1e-8 relative (the conditioning of the inverse)."""
    import math
    out = {}
    for wl, setup, kw in ((jwl, jsetup, {}), (twl, tsetup, SOLVE64)):
        system, md, cfg = il_small(wl, il_path, "il_onelayer", 4)
        u0 = 1.2 * math.sqrt(2 / math.pi) * cfg.eta / system.units().evscale
        cfg = dataclasses.replace(cfg, ehgo=dataclasses.replace(
            cfg.ehgo, kappa=0.5, eta_by_type=((5, cfg.eta, u0),)))
        out[wl] = setup(system, md, cfg, **kw)
    j, t = out[jwl], out[twl]
    assert np.abs(t.kernels.fo_ij).max() > 0
    for name in ("eta_ij", "fo_ij", "self_diag"):
        np.testing.assert_allclose(getattr(t.kernels, name),
                                   getattr(j.kernels, name), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(t.ainv.numpy(), np.asarray(j.ctx.ainv),
                               rtol=1e-8, atol=1e-10)


def test_cond_equals_conp_at_its_potdiff(il_path):
    """fix cond applies q = A^-1 b + dV elesetq with its own dV; fix conp
    (FFIELD) at that dV gives the same charges."""
    system, md, cfg = il_small(twl, il_path, "cond", 4)
    x0 = torch.as_tensor(system.x0)
    q0 = torch.as_tensor(system.q0)
    solver = tsetup(system, md, cfg, **SOLVE64)
    qc, dv, _ = solver.solve_full(x0, q0)
    conp = tsetup(system, md, dataclasses.replace(
        cfg, mode=type(cfg.mode).CONP, target=float(dv)), **SOLVE64)
    qp, _, _ = conp.solve_full(x0, q0)
    np.testing.assert_allclose(qc[system.ele_mask].numpy(),
                               qp[system.ele_mask].numpy(), atol=1e-12)
    assert abs(float(dv)) > 1e-3


def test_conq_at_conp_charge_returns_its_potential(il_path):
    """CONQ with CONP's right-electrode charge at 2 V as its target returns
    dV = 2.0 (the FFIELD variant of the dilute CONQ test) and CONP's
    charges."""
    system, md, cfg = il_small(twl, il_path, "cond", 3)
    x0 = torch.as_tensor(system.x0)
    q0 = torch.as_tensor(system.q0)
    Mode = type(cfg.mode)
    conp = tsetup(system, md, dataclasses.replace(cfg, mode=Mode.CONP,
                                                  target=2.0), **SOLVE64)
    qp, _, _ = conp.solve_full(x0, q0)
    qright = float(qp[system.ele_right_mask].sum())
    conq = tsetup(system, md, dataclasses.replace(cfg, target=qright),
                  **SOLVE64)
    qq, dv, _ = conq.solve_full(x0, q0)
    assert abs(float(dv) - 2.0) < 1e-8
    np.testing.assert_allclose(qq[system.ele_mask].numpy(),
                               qp[system.ele_mask].numpy(), atol=1e-10)


def test_cond_deck_20_steps_match(il_path):
    deck_20_steps_match(il_path, "cond", 4)


def _ramp(step):
    return 1.5 + 0.01 * step


@pytest.mark.parametrize("case", ["target", "feedback", "zmirror"])
def test_runner_replays_counter_target_feedback(il_path, case):
    """The graph runner (eager backend) against the eager steps, bit for
    bit, thermo rows included: a per-step ramped CONP target (il_onelayer
    4 with its callable replaced), the COND feedback field (cond 4), and
    zmirror's period read from the counter (zmirror 2, every 2)."""
    if case == "target":
        system, md, cfg = il_small(twl, il_path, "il_onelayer", 4)
        cfg = dataclasses.replace(cfg, target=_ramp)
    elif case == "feedback":
        system, md, cfg = il_small(twl, il_path, "cond", 4)
    else:
        system, md, cfg = il_small(twl, il_path, "zmirror", 2)
        md = dataclasses.replace(md, zmirror=dataclasses.replace(
            md.zmirror, every=2))
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    st0 = eng.init_state()
    ref, th_ref = eng.run(st0, 4, thermo_every=1)
    runner = graphs.step_graphs(eng, st0, EagerBackend())
    got, th = runner.run(st0, 4, 1)
    assert_same_bits(got, ref)
    for k in th:
        assert torch.equal(th[k], th_ref[k])
    assert int(got.step_t) == got.step == 4
    if case == "target":
        # the ramp moved the induced charge: each step solved at its own
        # target, step + 1 of the state it started from
        st = st0
        for i in range(4):
            st = eng.step(st)
            x = st.x
            q_ref, _, _ = eng.conp.solve_full(
                x, st.q, step=torch.tensor(i + 1))
            assert torch.equal(st.q, q_ref)
        assert float(th["f_e"][-1]) != float(th["f_e"][0])
