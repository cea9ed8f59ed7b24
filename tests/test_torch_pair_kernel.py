"""Port vs JAX package: the pair sweep (K4).  The port's plain version (the
CPU path of ``pair_forces``) against the JAX Pallas kernel in interpret
mode, with and without the fused CONP correction, on S2 (five 128-atom z
tiles) with jittered positions and nonzero electrode charges; float64.
Tolerances: forces rtol 1e-7 / atol 1e-8 (tests/test_pallas_pair.py),
energies and ecorr relative 1e-10 (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu.models.system import exclusion_lists
from lammps_user_conp2_tpu.ops.pairs import make_pair_tables as jtables
from lammps_user_conp2_tpu.ops.pallas.pair_kernel import pair_forces_pallas
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
from lammps_user_conp2_tpu_torch.ops.kernels.zorder import z_perm
from lammps_user_conp2_tpu_torch.ops.pairs import make_pair_tables
from torch_cells import S2, charges_with_electrodes, x_close, x_near

torch.set_num_threads(2)

G_EWALD = 0.5287930588017317     # S2's g_ewald (set_grid_and_gewald)
ETA = 1.979


def _inputs(positions):
    system, md, _ = twl.synthetic(**S2)
    u = system.units()
    x = positions(system)
    q = charges_with_electrodes(system)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=G_EWALD, qqr2e=u.qqr2e)
    return system, x, q, kw


def _fuse(system, lib, dtype):
    nt1 = system.ntypes + 1
    a = lambda v: lib.asarray(v) if lib is jnp else torch.as_tensor(v, dtype=dtype)
    return (a((system.elecheck != 0).astype(np.float64)),
            a((~system.ele_mask).astype(np.float64)),
            a(np.full((nt1, nt1), ETA)), a(np.zeros((nt1, nt1))))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "conp_fuse"])
@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_pair_plain_matches_jax_kernel(positions, fused):
    system, x, q, kw = _inputs(positions)
    excl = tuple(jnp.asarray(a) for a in exclusion_lists(system))
    jout = pair_forces_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(system.type),
        jtables(system.lj_eps, system.lj_sigma, system.type), excl,
        tr=128, tc=128, interpret=True,
        conp_fuse=_fuse(system, jnp, None) if fused else None, **kw)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    tt = torch.as_tensor(system.type)
    tabs = make_pair_tables(system.lj_eps, system.lj_sigma)
    fuse = _fuse(system, torch, torch.float64) if fused else None
    for fn in (k4.pair_forces, k4.pair_forces_plain):   # CPU: both plain
        tout = fn(xt, qt, tt, tabs, None, conp_fuse=fuse, **kw)
        assert len(tout) == len(jout)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   rtol=1e-7, atol=1e-8)
        for a, b in zip(tout[1:], jout[1:]):
            assert float(a) == pytest.approx(float(b), rel=1e-10)
    if fused:
        assert float(jout[3]) != 0.0
    assert k4.launches.count == 0       # nothing launched on the CPU


def test_exclusion_correction_matches_dense_exclusions():
    """The JAX package's exclusion pass (its ``ops/cells.py``): a uniform
    s=1 sweep plus ``exclusion_correction`` equals the port's dense sweep
    with the special factors applied per pair, and the JAX kernel with the
    same exclusions."""
    from lammps_user_conp2_tpu.ops.cells import exclusion_correction
    system, x, q, kw = _inputs(x_near)
    n = system.natoms
    rng = np.random.default_rng(5)
    m = 3
    exi = np.full((n, m), n, np.int64)
    exv = np.zeros((n, m))
    for i in range(0, n - 1, 2):              # symmetric nearest-index pairs
        exi[i, 0], exi[i + 1, 0] = i + 1, i
        exv[i, 0] = exv[i + 1, 0] = rng.choice([0.0, 0.5])
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    tt = torch.as_tensor(system.type)
    tabs = make_pair_tables(system.lj_eps, system.lj_sigma)
    excl = (torch.from_numpy(exi), torch.from_numpy(exv))
    f1, ev1, ec1 = k4.pair_forces_plain(xt, qt, tt, tabs, excl, **kw)
    f0, ev0, ec0 = k4.pair_forces_plain(xt, qt, tt, tabs, None, **kw)
    df, dev, dec = exclusion_correction(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(system.type),
        jtables(system.lj_eps, system.lj_sigma, system.type),
        (jnp.asarray(exi), jnp.asarray(exv)), box=kw["box"],
        periodic=kw["periodic"], cutsq=kw["cutoff"] ** 2, qqr2e=kw["qqr2e"])
    np.testing.assert_allclose(f0.numpy() + np.asarray(df), f1.numpy(),
                               rtol=1e-9, atol=1e-9)
    assert float(ev0) + float(dev) == pytest.approx(float(ev1), rel=1e-12)
    assert float(ec0) + float(dec) == pytest.approx(float(ec1), rel=1e-12)
    assert float(dec) != 0.0
    jf, jev, jec = pair_forces_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(system.type),
        jtables(system.lj_eps, system.lj_sigma, system.type),
        (jnp.asarray(exi.astype(np.int32)), jnp.asarray(exv)),
        tr=128, tc=128, interpret=True, **kw)
    np.testing.assert_allclose(f1.numpy(), np.asarray(jf), rtol=1e-7,
                               atol=1e-8)
    assert float(ev1) == pytest.approx(float(jev), rel=1e-10)
    assert float(ec1) == pytest.approx(float(jec), rel=1e-10)


def test_z_perm_sorts_wrapped_z():
    """The shared ordering: sorted wrapped-z keys, any tie order."""
    from lammps_user_conp2_tpu.ops.pallas.zorder import z_perm as jz_perm
    system, x, _, kw = _inputs(x_near)
    for periodic in (kw["periodic"], (True, True, True)):
        perm, zs = z_perm(torch.from_numpy(x), kw["box"], periodic)
        jperm, jzs = jz_perm(jnp.asarray(x), kw["box"], periodic)
        np.testing.assert_array_equal(zs.numpy(), np.asarray(jzs))
        assert sorted(perm.tolist()) == list(range(system.natoms))


def test_eta_table_kernels_equal_eta_mode():
    """The table parameterization the kernels evaluate (uniform eta,
    fo = 0) is the ETA pair mode of the JAX package, for every distance
    up to and beyond the ERFC_MAX clamp."""
    from lammps_user_conp2_tpu.ops.pairs import eta_pair_kernels as jeta
    from lammps_user_conp2_tpu_torch.ops.pairs import (eta_pair_kernels,
                                                       gauss_table_kernels)
    rsq = np.linspace(0.5, 30.0, 400)
    ti = np.zeros(400, np.int64)
    tab_pot, tab_frc = gauss_table_kernels(
        torch.full((4, 4), ETA, dtype=torch.float64),
        torch.zeros((4, 4), dtype=torch.float64))
    pot, frc, pot_a = eta_pair_kernels(ETA)
    jpot, jfrc, jpot_a = jeta(ETA)
    r, t = torch.from_numpy(rsq), torch.from_numpy(ti)
    for mine, table, ref in ((pot, tab_pot, jpot), (frc, tab_frc, jfrc)):
        np.testing.assert_allclose(table(r, t, t).numpy(),
                                   mine(r, t, t).numpy(), rtol=1e-14, atol=0)
        np.testing.assert_allclose(mine(r, t, t).numpy(),
                                   np.asarray(ref(jnp.asarray(rsq), 0, 0)),
                                   rtol=1e-14, atol=0)
    np.testing.assert_allclose(pot_a(r, t, t).numpy(),
                               np.asarray(jpot_a(jnp.asarray(rsq), 0, 0)),
                               rtol=1e-14, atol=0)
    assert float(pot(r, t, t)[-1]) == 0.0      # beyond the clamp
