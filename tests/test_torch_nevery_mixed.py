"""Port vs JAX package: ``nevery`` > 1 and mixed precision.

* nevery = 2 and 3 on S2 (EWALD, dense) and S3 (PPPM, dense mesh), INV,
  float64, 6 steps from ``x_near``: on the steps that skip the solve the
  charges and the fix scalar are bit-unchanged, on the others they move;
  q (1e-8 e), pe (1e-9 relative) and f (1e-7) against the JAX engine at
  every step, the tolerances of test_torch_charge_modes.py; the skip
  branch hands the force path the electrolyte's k-space cache.
* Mixed precision, a float32 engine over a float64 solve, on S2 (EWALD,
  INV), S3 (PPPM, INV) and S3 under CG_MATFREE, 4 steps against the JAX
  engine in the same dtypes: q to 2e-5 e, f to 1e-4 of its largest
  component, pe to 1e-4 relative (the JAX package's float32 PPPM energy
  at S3 sits 6.6e-5 below the float64 one, the port's 4e-7 above it); pe
  also to 1e-5 relative of the port's float64 engine; the state's charges
  float32, the fix scalar float64; the force path drops the solve's
  float64 cache and builds its own in float32 (the factored tables under
  EWALD, the mesh under PPPM), once per step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import md as tmd_mod
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import CPU64, S2, SOLVE64, pppm_cell, x_near

torch.set_num_threads(2)


def _cells(cell, **cfg_kw):
    """(JAX, port) (system, md, cfg) of ``cell`` (S2: EWALD; S3: PPPM)."""
    if cell == "S2":
        j = jwl.synthetic(**S2)
        t = twl.synthetic(**S2)
    else:
        j = pppm_cell(jwl, JK)
        t = pppm_cell(twl, TK)
    out = []
    for (system, md, cfg) in (j, t):
        kw = dict(cfg_kw)
        if "solver" in kw:
            kw["solver"] = type(cfg.solver)[kw["solver"]]
        out.append((system, md, dataclasses.replace(cfg, **kw)))
    return out


@pytest.mark.parametrize("nevery", [2, 3])
@pytest.mark.parametrize("cell", ["S2", "S3"])
def test_nevery_steps_match(cell, nevery, monkeypatch):
    (js, jmd, jcfg), (ts, tmd, tcfg) = _cells(cell, nevery=nevery)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg))
    teng = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    caches = []
    real = teng.compute_forces

    def spy(x, q, kcache=None, *a, **k):
        caches.append(kcache is not None)
        return real(x, q, kcache, *a, **k)

    monkeypatch.setattr(teng, "compute_forces", spy)
    x0 = x_near(ts)
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    for i in range(6):
        prev = tst
        jst, _ = jeng.run(jst, 1, thermo_every=1)
        tst = teng.step(tst)
        solved = (i + 1) % nevery == 0
        assert torch.equal(tst.q, prev.q) != solved
        assert torch.equal(tst.scalar_out, prev.scalar_out) != solved
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=1e-8)
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-9)
        np.testing.assert_allclose(tst.f.numpy(), np.asarray(jst.f), rtol=0,
                                   atol=1e-7)
    # every step, solve or skip, hands the forces the solve's cache
    assert caches == [True] * 7


@pytest.mark.parametrize("case", ["S2", "S3", "S3-matfree"])
def test_mixed_precision_matches(case, monkeypatch):
    kw = dict(solver="CG_MATFREE") if case.endswith("matfree") else {}
    (js, jmd, jcfg), (ts, tmd, tcfg) = _cells(case[:2], **kw)
    jeng = jbuild(js, jmd, jsetup(js, jmd, jcfg, solve_dtype=jnp.float64),
                  dtype=jnp.float32)
    tsol = tsetup(ts, tmd, tcfg, **SOLVE64)
    teng = tbuild(ts, tmd, tsol, dtype=torch.float32, device="cpu")
    assert tsol.solve_dtype == torch.float64 and teng.dtype == torch.float32
    if case == "S2":
        # the engine's own factored tables, in its own dtype
        assert teng.fksp is not tsol.fksp
        assert teng.fksp.ug_t.dtype == torch.float32
    else:
        assert teng.fksp is None
    nsteps = 4
    x0 = x_near(ts)
    e64 = tbuild(ts, tmd, tsetup(ts, tmd, tcfg, **SOLVE64), **CPU64)
    ref64 = [e64.init_state(x0=x0)]
    for _ in range(nsteps):
        ref64.append(e64.step(ref64[-1]))
    # the force path's own cache: the factored sums or the mesh spread, in
    # float32, once per step beside the solve's float64 one
    built = []
    mod = tmd_mod.ewf if case == "S2" else tmd_mod.pppm_ops
    name = "energy_forces_f" if case == "S2" else "spread_rhok"
    real = getattr(mod, name)

    def spy(*a, **k):
        built.append(a[1].dtype)
        return real(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    for i in range(nsteps + 1):
        if i:
            jst, _ = jeng.run(jst, 1, thermo_every=1)
            tst = teng.step(tst)
        assert tst.q.dtype == torch.float32
        assert tst.scalar_out.dtype == torch.float64
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=0,
                                   atol=2e-5)
        fmax = float(np.abs(np.asarray(jst.f)).max())
        np.testing.assert_allclose(tst.f.numpy(), np.asarray(jst.f), rtol=0,
                                   atol=1e-4 * fmax)
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-4)
        assert float(tst.energy) == pytest.approx(float(ref64[i].energy),
                                                  rel=1e-5)
    assert built.count(torch.float32) == nsteps + 1
    if case != "S2":
        assert built.count(torch.float64) == nsteps + 1
