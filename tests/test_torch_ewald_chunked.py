"""Port vs JAX package: the factored Ewald above KXY_CHUNK xy vectors.

S4 (712 atoms, a 80 x 80 A box) has 1,411 xy vectors, more than
KXY_CHUNK = 1024, so the JAX package scans its tables in chunks and so
does the port.  Float64 on both sides:

* the chunked structure factor, the b readout on the electrodes and the
  energy and forces at ``x_near`` with random electrode charges (numpy seed
  7): to 1e-10 relative of the JAX package's, and to 1e-12 of the port's
  own sums with the chunk bound lifted (the tables formed whole);
* ``setup_conp`` and ``build_engine`` under EWALD: no per-step cache (the
  solve's k-space cache is None), 5 engine steps from ``x_near`` with the
  JAX context loaded through ``interop``: q, pe and f to 1e-10 relative of
  the JAX engine's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops import ewald_factored as jewf
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import ewald_factored as tewf
from torch_cells import (CPU64, S4, SOLVE64, charges_with_electrodes,
                         rel_err, x_near)

torch.set_num_threads(2)


def _sums(ewf, fk, x, q, ne, wrap):
    sr, si = ewf.structure_factor_f(fk, wrap(x), wrap(q))
    phi = ewf.potential_on_points_f(fk, wrap(x[:ne]), sr, si)
    e, f = ewf.energy_forces_f(fk, wrap(x), wrap(q))
    return [np.asarray(a) for a in (sr, si, phi, e, f)]


def test_chunked_sums_match(monkeypatch):
    system, md, cfg = twl.synthetic(**S4)
    tsol = tsetup(system, md, cfg, **SOLVE64)
    fk = tsol.fksp
    assert fk.nxy > tewf.KXY_CHUNK and not tsol._ewald_cacheable()
    jfk = jewf.factorize(tsol.ksp)
    assert jfk.nxy == fk.nxy
    np.testing.assert_array_equal(jfk.kxy, fk.kxy)
    x = x_near(system)
    q = charges_with_electrodes(system, seed=7)
    ne = tsol.ne
    got = _sums(tewf, fk, x, q, ne, torch.from_numpy)
    ref = _sums(jewf, jfk, x, q, ne, jnp.asarray)
    for g, r in zip(got, ref):
        assert rel_err(g, r) < 1e-10
    # the same sums with the tables formed whole
    monkeypatch.setattr(tewf, "KXY_CHUNK", 1 << 20)
    whole = _sums(tewf, fk, x, q, ne, torch.from_numpy)
    for g, w in zip(got, whole):
        assert rel_err(g, w) < 1e-12


def test_engine_steps_match():
    js, jmd, jcfg = jwl.synthetic(**S4)
    ts, tmd, tcfg = twl.synthetic(**S4)
    jsol = jsetup(js, jmd, jcfg)
    tsol = tsetup(ts, tmd, tcfg, **SOLVE64)
    jctx = {k: np.asarray(v) for k, v in jsol.ctx._asdict().items()}
    tsol.load_context(interop.context_from_numpy(jctx, **CPU64))
    jeng = jbuild(js, jmd, jsol)
    teng = tbuild(ts, tmd, tsol, **CPU64)
    assert teng.ncfg is None and teng.fksp.nxy > tewf.KXY_CHUNK
    x0 = x_near(ts)
    jst = jeng.init_state(x0=x0)
    tst = teng.init_state(x0=x0)
    _, _, kcache = tsol.solve_full(tst.x, tst.q, step=tst.step_t)
    assert kcache is None
    for i in range(6):
        if i:
            jst, _ = jeng.run(jst, 1, thermo_every=1)
            tst = teng.step(tst)
        assert rel_err(tst.q.numpy(), jst.q) < 1e-10
        assert float(tst.energy) == pytest.approx(float(jst.energy),
                                                  rel=1e-10)
        assert rel_err(tst.f.numpy(), jst.f) < 1e-10
