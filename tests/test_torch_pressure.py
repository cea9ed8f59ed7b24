"""Port vs JAX package: the virial and the pressure (``models/pressure.py``).

* On a 40-ion periodic cell (tests/test_pressure.py's): the pair and the
  Ewald k-space virials, scalar and tensor, against the JAX package to
  1e-10 relative; the volume-derivative oracle, P = -dE/dV for the scalar
  and W_aa = -dE/dln(L_a) per axis at fixed fractional coordinates, to
  5e-3; the tensors' traces equal the scalars to 1e-10; the mesh tensor
  ``pppm_virial_tensor`` against the JAX one to 1e-10 and against the
  Ewald tensor to 2e-3 of its largest component (at convergence).
* Whole engines from the same state (the JAX engine's, through
  ``interop``): ``pressure_tensor`` and ``pressure_scalar`` on the
  352-atom ionic-liquid fixture (EWALD, slab, bonds, angles, exclusions,
  the CONP correction), ``pressure_tensor`` on its EHGO trial 4 (PPPM,
  per-type Gaussian tables) and on S3 (PPPM), and the bonded tensor and
  scalar: float64, to 1e-10 relative (of the largest component).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import pressure as jp
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.models.md import build_engine as jbuild
from lammps_user_conp2_tpu.ops import ewald as jew
from lammps_user_conp2_tpu.ops import ewald_factored as jewf
from lammps_user_conp2_tpu.ops import pppm as jpppm
from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
from lammps_user_conp2_tpu.utils.config import KSpaceStyle as JK
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import pressure as tp
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops import ewald as tew
from lammps_user_conp2_tpu_torch.ops import ewald_factored as tewf
from lammps_user_conp2_tpu_torch.ops import pppm as tpppm
from lammps_user_conp2_tpu_torch.ops.pairs import make_pair_tables
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from torch_cells import (CPU64, SOLVE64, il_small, il_small_file, pppm_cell,
                         rel_err, x_near)

torch.set_num_threads(2)
QQR2E = 332.06371
G = 0.9
CUT = 5.0
TOL = 1e-10
BOX0 = np.array([11.0, 12.0, 13.0])


def _ions(scale3=(1.0, 1.0, 1.0), n=40, seed=0):
    """(x, q, box) of tests/test_pressure.py's cell, numpy."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0, 1, (n, 3))
    q = rng.normal(size=n)
    q -= q.mean()
    box = tuple(BOX0 * np.asarray(scale3))
    return frac * np.asarray(box), q, box


def _lj():
    eps = np.zeros((2, 2))
    sig = np.zeros((2, 2))
    eps[1, 1] = 0.12
    sig[1, 1] = 2.8
    return eps, sig


def _port_parts(scale3, accuracy=1e-8):
    """(energy, pair virial tensor + qqr2e kspace tensor, scalar virial,
    fk, x, q, box) of the port on the ion cell."""
    from lammps_user_conp2_tpu_torch.ops.pairs import dense_pair_forces
    x, q, box = _ions(scale3)
    n = len(q)
    ksp = tew.setup_ewald(box=box, accuracy_abs=accuracy * QQR2E, g_ewald=G,
                          natoms=n, q2=float((q ** 2).sum()) * QQR2E)
    fk = tewf.factorize(ksp)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    typ = torch.ones(n, dtype=torch.int64)
    tables = make_pair_tables(*_lj())
    kw = dict(box=box, periodic=(True,) * 3, cutoff=CUT, g_ewald=G,
              qqr2e=QQR2E)
    _, ev, ec = dense_pair_forces(xt, qt, typ, tables, None, **kw)
    ek, _ = tewf.energy_forces_f(fk, xt, qt)
    e = float(ev + ec + QQR2E * ek)
    w6 = (tp.pair_virial_tensor(xt, qt, typ, tables, None, block=16, **kw)
          + QQR2E * tp.kspace_virial_tensor(fk, xt, qt))
    w = (tp.pair_virial_scalar(xt, qt, typ, tables, None, block=16, **kw)
         + QQR2E * tp.kspace_virial_scalar(fk, xt, qt))
    return e, w6.numpy(), float(w), fk, xt, qt, box


def test_ion_cell_virials_match_jax():
    _, _, _, fk, xt, qt, box = _port_parts((1.0, 1.0, 1.0))
    x, q, _ = _ions()
    n = len(q)
    typ = np.ones(n, np.int64)
    jt = jtables(*_lj(), typ)
    jexcl = (jnp.full((n, 1), n, jnp.int32), jnp.zeros((n, 1)))
    ksp = jew.setup_ewald(box=box, accuracy_abs=1e-8 * QQR2E, g_ewald=G,
                          natoms=n, q2=float((q ** 2).sum()) * QQR2E)
    jfk = jewf.factorize(ksp)
    kw = dict(box=box, periodic=(True,) * 3, cutoff=CUT, g_ewald=G,
              qqr2e=QQR2E)
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    typt = torch.ones(n, dtype=torch.int64)
    tt = make_pair_tables(*_lj())
    pairs = [
        (tp.pair_virial_scalar(xt, qt, typt, tt, None, **kw),
         jp.pair_virial_scalar(xj, qj, jnp.asarray(typ), jt, jexcl, **kw)),
        (tp.pair_virial_tensor(xt, qt, typt, tt, None, **kw),
         jp.pair_virial_tensor(xj, qj, jnp.asarray(typ), jt, jexcl, **kw)),
        (tp.kspace_virial_scalar(fk, xt, qt),
         jp.kspace_virial_scalar(jfk, xj, qj)),
        (tp.kspace_virial_tensor(fk, xt, qt),
         jp.kspace_virial_tensor(jfk, xj, qj)),
    ]
    for got, want in pairs:
        assert rel_err(got.numpy(), want) < TOL


def test_virial_matches_volume_derivative():
    eps = 2e-5
    e0, _, w0, *_ = _port_parts((1.0, 1.0, 1.0))
    ep = _port_parts((1.0 + eps,) * 3)[0]
    em = _port_parts((1.0 - eps,) * 3)[0]
    v = lambda s: float(np.prod(BOX0 * s))
    p_num = -(ep - em) / (v(1.0 + eps) - v(1.0 - eps))
    p_vir = w0 / (3.0 * v(1.0))
    assert abs(p_num - p_vir) / max(1e-3, abs(p_vir)) < 5e-3


@pytest.mark.parametrize("ax", [0, 1, 2])
def test_virial_tensor_diagonal_matches_axis_derivatives(ax):
    eps = 2e-5
    _, w6, *_ = _port_parts((1.0, 1.0, 1.0))
    sp = [1.0, 1.0, 1.0]
    sm = [1.0, 1.0, 1.0]
    sp[ax] = 1.0 + eps
    sm[ax] = 1.0 - eps
    w_num = -(_port_parts(sp)[0] - _port_parts(sm)[0]) / (2 * eps)
    assert abs(w_num - w6[ax]) / max(1e-3, abs(w6[ax])) < 5e-3


def test_virial_tensor_trace_matches_scalar():
    _, w6, w, fk, xt, qt, _ = _port_parts((1.0, 1.0, 1.0))
    assert w6[:3].sum() == pytest.approx(w, rel=TOL)
    k6 = tp.kspace_virial_tensor(fk, xt, qt).numpy()
    ks = float(tp.kspace_virial_scalar(fk, xt, qt))
    assert k6[:3].sum() == pytest.approx(ks, rel=TOL)


def test_pppm_virial_tensor_matches_jax_and_ewald():
    _, _, _, _, xt, qt, box = _port_parts((1.0, 1.0, 1.0))
    x, q, _ = _ions()
    n = len(q)
    q2 = float((q ** 2).sum()) * QQR2E
    kw = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-10 * QQR2E,
              natoms=n, q2=q2, cutoff=CUT, g_ewald=G)
    tgrid = tpppm.setup_pppm(**kw, device="cpu")
    jgrid = jpppm.setup_pppm(**kw)
    w_mesh = tp.pppm_virial_tensor(tgrid, tpppm.spread(tgrid, xt, qt)).numpy()
    w_jax = np.asarray(jp.pppm_virial_tensor(
        jgrid, jpppm.spread(jgrid, jnp.asarray(x), jnp.asarray(q))))
    assert rel_err(w_mesh, w_jax) < TOL
    ksp = tew.setup_ewald(box=box, accuracy_abs=1e-10 * QQR2E, g_ewald=G,
                          natoms=n, q2=q2)
    w_ew = tp.kspace_virial_tensor(tewf.factorize(ksp), xt, qt).numpy()
    assert np.abs(w_mesh - w_ew).max() / max(1.0, np.abs(w_ew).max()) < 2e-3


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _engines(name, il_path):
    """(JAX engine, port engine with the JAX context, JAX state at x0)."""
    if name == "S3":
        (js, jmd, jcfg), (ts, tmd, tcfg) = pppm_cell(jwl, JK), \
            pppm_cell(twl, TK)
        x0 = x_near(ts)
    else:
        n = 4 if name == "il4" else 0
        js, jmd, jcfg = il_small(jwl, il_path, n=n)
        ts, tmd, tcfg = il_small(twl, il_path, n=n)
        x0 = ts.x0
    jsol = jsetup(js, jmd, jcfg)
    tsol = tsetup(ts, tmd, tcfg, **SOLVE64)
    tsol.load_context(interop.context_from_numpy(
        {k: np.asarray(v) for k, v in jsol.ctx._asdict().items()}, **CPU64))
    jeng = jbuild(js, jmd, jsol)
    teng = tbuild(ts, tmd, tsol, **CPU64)
    jst, _ = jeng.run(jeng.init_state(x0=x0), 3, thermo_every=0)
    tst = interop.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in
         ("x", "v", "q", "f", "step", "nhc_xi", "nhc_vxi", "scalar_out",
          "energy")}, engine=teng, **CPU64)
    return jeng, teng, jst, tst


@pytest.mark.parametrize("name", ["il", "il4", "S3"])
def test_engine_pressure_matches_jax(il_path, name):
    jeng, teng, jst, tst = _engines(name, il_path)
    got = tp.pressure_tensor(teng, tst, block=100).numpy()
    want = np.asarray(jp.pressure_tensor(jeng, jst))
    assert rel_err(got, want) < TOL
    if name != "il":
        return
    assert float(tp.pressure_scalar(teng, tst)) == pytest.approx(
        float(jp.pressure_scalar(jeng, jst)), rel=TOL)
    sys = teng.system
    bkw = dict(box=sys.box, periodic=sys.periodic)
    jargs = (jnp.asarray(np.asarray(jst.x)), jnp.asarray(sys.bonds),
             jnp.asarray(sys.bond_coeffs), jnp.asarray(sys.angles),
             jnp.asarray(sys.angle_coeffs))
    targs = (tst.x, teng.bonds, teng.bond_coeffs, teng.angles,
             teng.angle_coeffs)
    for tf, jf in ((tp.bonded_virial_tensor, jp.bonded_virial_tensor),
                   (tp.bonded_virial_scalar, jp.bonded_virial_scalar)):
        assert rel_err(tf(*targs, **bkw).numpy(), jf(*jargs, **bkw)) < TOL
