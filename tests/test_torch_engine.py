"""Port vs JAX package: the slice as a whole on S2, float64 on both sides.

20 steps of build_engine -> init_state(x_near) -> run from independent
setups: per step x to atol 1e-8 A, q to atol 1e-8 e, pe to a relative
1e-9, thermo temp and qleft to a relative 1e-8 (the bounds on x and q
allow for the 1e-8 relative difference the setup test permits in A^-1).
A second case feeds the JAX context and state through ``interop`` and
compares one step, so the setup is not under test there."""

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from torch_cells import S2, x_near

torch.set_num_threads(2)

NSTEPS = 20


@pytest.fixture(scope="module")
def engines():
    js, jmd, jcfg = jwl.synthetic(**S2)
    ts, tmd, tcfg = twl.synthetic(**S2)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg))
    return jeng, teng, x_near(ts)


def _jax_steps(jeng, x0):
    st = jeng.init_state(x0=x0)
    states, rows = [], []
    for _ in range(NSTEPS):
        st, th = jeng.run(st, 1, thermo_every=1)
        states.append(st)
        rows.append({k: float(np.asarray(v)[0]) for k, v in th.items()})
    return states, rows


def test_engine_20_steps_match(engines):
    jeng, teng, x0 = engines
    jstates, jrows = _jax_steps(jeng, x0)
    ne = teng.conp.ne

    st = teng.init_state(x0=x0)
    for i in range(NSTEPS):
        st = teng.step(st)
        js = jstates[i]
        assert st.step == int(js.step)
        np.testing.assert_allclose(st.x.numpy(), np.asarray(js.x), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(st.q.numpy(), np.asarray(js.q), rtol=0,
                                   atol=1e-8)
        assert float(st.energy) == pytest.approx(float(js.energy), rel=1e-9)
        assert abs(float(st.q[:ne].sum())) < 1e-10
    assert float(teng.thermo(st)["temp"]) > 0.0

    # the same trajectory through run(): thermo rows every step
    final, th = teng.run(teng.init_state(x0=x0), NSTEPS, thermo_every=1)
    np.testing.assert_array_equal(final.x.numpy(), st.x.numpy())
    assert th["temp"].shape == (NSTEPS,)
    for i, row in enumerate(jrows):
        assert int(th["step"][i]) == int(row["step"])
        for key in ("temp", "tempsl", "qleft", "qright"):
            assert float(th[key][i]) == pytest.approx(row[key], rel=1e-8)
        assert float(th["pe"][i]) == pytest.approx(row["pe"], rel=1e-9)
    # the electrodes hold nonzero, opposite charges under the 1 V step
    assert abs(jrows[-1]["qleft"]) > 1e-3


def test_one_step_from_jax_state_and_context(engines):
    """Hold the per-step path apart from the setup: the JAX context and a
    JAX mid-run state go through interop into the port, and one step of
    each must agree."""
    jeng, teng, x0 = engines
    jstates, _ = _jax_steps(jeng, x0)
    js0, js1 = jstates[-2], jstates[-1]
    jctx = {k: np.asarray(v) for k, v in jeng.conp.ctx._asdict().items()}
    teng.conp.load_context(interop.context_from_numpy(jctx))
    try:
        fields = {k: np.asarray(v) for k, v in js0._asdict().items()
                  if v is not None}
        out = teng.step(interop.state_from_numpy(fields))
        np.testing.assert_allclose(out.x.numpy(), np.asarray(js1.x), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(out.v.numpy(), np.asarray(js1.v),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(out.q.numpy(), np.asarray(js1.q), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(out.f.numpy(), np.asarray(js1.f),
                                   rtol=1e-8, atol=1e-8)
        assert float(out.energy) == pytest.approx(float(js1.energy),
                                                  rel=1e-11)
        assert float(out.scalar_out) == pytest.approx(
            float(js1.scalar_out), rel=1e-10)
    finally:
        # leave the module-scoped engine with its own context
        ts, tmd, tcfg = twl.synthetic(**S2)
        teng.conp.load_context(tsetup(ts, tmd, tcfg).ctx)


def test_engine_without_conp_matches():
    """No CONP: the pair sweep without the fused correction and the
    uncached factored Ewald."""
    js, jmd, _ = jwl.synthetic(**S2)
    ts, tmd, _ = twl.synthetic(**S2)
    jeng = jbuild(js, jmd, None)
    teng = tbuild(ts, tmd, None)
    x0 = x_near(ts)
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    for _ in range(3):
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                               atol=1e-10)
    assert float(tst.energy) == pytest.approx(float(jst.energy), rel=1e-10)
