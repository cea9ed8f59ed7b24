"""Port vs JAX package: the host layer (System, synthetic cells, pair
tables, exclusions, interop) must agree exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models import system as jsystem
from lammps_user_conp2_tpu.ops import pairs as jpairs
from lammps_user_conp2_tpu.utils import data_io as jdata_io
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import system as tsystem
from lammps_user_conp2_tpu_torch.ops import pairs as tpairs
from lammps_user_conp2_tpu_torch.utils import data_io as tdata_io
from torch_cells import S1, S2

torch.set_num_threads(2)


def _assert_same_system(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "groups":
            assert va.keys() == vb.keys()
            for k in va:
                np.testing.assert_array_equal(va[k], vb[k])
        elif isinstance(va, np.ndarray):
            assert va.dtype == np.asarray(vb).dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("cell", [S1, S2], ids=["S1", "S2"])
def test_synthetic_system_matches(cell):
    js, jmd, jcfg = jwl.synthetic(**cell)
    ts, tmd, tcfg = twl.synthetic(**cell)
    _assert_same_system(ts, js)
    plain = lambda cfg: {k: getattr(v, "value", v)
                         for k, v in dataclasses.asdict(cfg).items()}
    assert plain(tmd) == plain(jmd)
    assert plain(tcfg) == plain(jcfg)
    np.testing.assert_array_equal(ts.elecheck, js.elecheck)
    assert ts.box == js.box and ts.natoms == js.natoms
    # LJ tables and exclusions
    jt = jpairs.make_pair_tables(js.lj_eps, js.lj_sigma, js.type)
    tt = tpairs.make_pair_tables(ts.lj_eps, ts.lj_sigma)
    for k in ("lj1", "lj2", "lj3", "lj4"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    for a, b in zip(tsystem.exclusion_lists(ts), jsystem.exclusion_lists(js)):
        np.testing.assert_array_equal(a, b)
    # interop: the JAX system's fields rebuild the same port System
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    _assert_same_system(interop.system_from_numpy(fields), ts)


def _bonded_data(mod):
    """A 6-atom molecule pair with bonds and angles, as each package's
    LammpsData."""
    rng = np.random.default_rng(4)
    n = 6
    return mod.LammpsData(
        natoms=n, natomtypes=2, box_lo=np.zeros(3), box_hi=np.full(3, 10.0),
        tag=np.arange(1, n + 1), mol=np.array([1, 1, 1, 2, 2, 2]),
        type=np.array([1, 2, 2, 1, 2, 2]), q=rng.standard_normal(n),
        x=rng.uniform(0, 10, (n, 3)), v=np.zeros((n, 3)),
        mass_by_type=np.array([0.0, 16.0, 1.0]),
        pair_coeffs=np.array([[0, 0], [0.15, 3.1], [0.0, 1.0]]),
        pair_coeffs_ij=None,
        bond_coeffs=np.array([[0, 0], [450.0, 1.0]]),
        angle_coeffs=np.array([[0, 0], [55.0, 104.5]]),
        bonds=np.array([[1, 0, 1], [1, 0, 2], [1, 3, 4], [1, 3, 5]]),
        angles=np.array([[1, 1, 0, 2], [1, 4, 3, 5]]))


def test_bonded_system_and_reorder_match():
    """build_system, exclusion_lists and electrodes_first on a bonded
    system with electrodes not at the front."""
    kw = dict(units="real", periodic=(True, True, True), mix="geometric",
              ele_left=[2], ele_right=None,
              pair_coeff_overrides=[(1, 2, 0.1, 2.0)])
    js = jsystem.build_system(_bonded_data(jdata_io), **kw)
    ts = tsystem.build_system(_bonded_data(tdata_io), **kw)
    _assert_same_system(ts, js)
    for a, b in zip(tsystem.exclusion_lists(ts), jsystem.exclusion_lists(js)):
        np.testing.assert_array_equal(a, b)
    _assert_same_system(tsystem.electrodes_first(ts),
                        jsystem.electrodes_first(js))
    assert tsystem.electrodes_first(ts).ele_mask[:3].all()


def test_bonded_forces_match():
    """Harmonic bonds and angles (the step calls bonded_forces for any
    system with topology) against the JAX package."""
    import jax.numpy as jnp
    from lammps_user_conp2_tpu.ops.bonded import bonded_forces as jbonded
    from lammps_user_conp2_tpu_torch.ops.bonded import bonded_forces as tbonded
    data = _bonded_data(tdata_io)
    x = data.x.copy()
    x[1] = x[0] + [0.9, 0.3, 0.0]
    x[2] = x[0] + [-0.2, 1.1, 0.1]
    x[4] = x[3] + [9.5, 0.2, 0.0]         # bonded across the periodic x face
    x[5] = x[3] + [0.1, -1.0, 0.3]
    kw = dict(box=(10.0, 10.0, 10.0), periodic=(True, True, True))
    tf, te = tbonded(torch.from_numpy(x), torch.from_numpy(data.bonds),
                     torch.from_numpy(data.bond_coeffs),
                     torch.from_numpy(data.angles),
                     torch.from_numpy(data.angle_coeffs), **kw)
    jf, je = jbonded(jnp.asarray(x), jnp.asarray(data.bonds),
                     jnp.asarray(data.bond_coeffs), jnp.asarray(data.angles),
                     jnp.asarray(data.angle_coeffs), **kw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-12)
    assert float(te) == pytest.approx(float(je), rel=1e-12)
    assert float(te) > 0.0
