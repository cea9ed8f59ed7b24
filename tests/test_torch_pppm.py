"""Port vs JAX package: the PPPM mesh path.

Grids: the 3,288-atom slab of tests/test_pppm_tiled.py (z-span tiling, the
production geometry) and a 1,500-atom fully periodic box (3x3 xy tiles
of 9 nodes, periodic z).  Setup and the influence function to 1e-12; TileGeom equal; the
tile assignment and slot rows equal; the z-binned spread, Poisson solve
and ad gather to 1e-10 (float64) and 2e-6 of the largest value (float32);
K2a's and K3's plain versions against the JAX Mosaic kernels in interpret
mode (float32); the dense path and the z-plane transforms to 1e-10; tile
overflow and stencils off the electrode planes give NaN."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lammps_user_conp2_tpu.ops import pppm as JP
from lammps_user_conp2_tpu_torch.ops import pppm as TP
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_gather as k3
from lammps_user_conp2_tpu_torch.ops.kernels import pppm_spread as k2

torch.set_num_threads(2)


def _slab():
    rng = np.random.default_rng(7)
    n = 3000
    x_ely = rng.uniform([0, 0, 2], [30, 30, 88], size=(n, 3))
    side = 12
    gx, gy = np.meshgrid(np.arange(side) * 2.5, np.arange(side) * 2.5)
    walls = [np.stack([gx.ravel(), gy.ravel(), np.full(side * side, z)], 1)
             for z in (1.0, 89.0)]
    x = np.concatenate([x_ely] + walls)
    q = rng.normal(size=len(x))
    return (30.0, 30.0, 90.0), x, q - q.mean(), dict(slabflag=True,
                                                       slab_volfactor=3.0)


def _periodic():
    rng = np.random.default_rng(5)
    n = 1500
    box = (40.0, 40.0, 60.0)
    x = rng.uniform(0, 1, size=(n, 3)) * np.asarray(box)
    q = rng.normal(size=n)
    return box, x, q - q.mean(), dict(slabflag=False)


@pytest.fixture(scope="module", params=["slab", "periodic"])
def grids(request):
    box, x, q, kw = (_slab if request.param == "slab" else _periodic)()
    args = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0, **kw)
    return JP.setup_pppm(**args), TP.setup_pppm(**args), x, q, request.param


def _tt(a, dt):
    return torch.as_tensor(np.asarray(a), dtype=dt)


def test_setup_and_greens_match(grids):
    jg, tg, x, q, _ = grids
    for name in ("order", "nx", "ny", "nz", "box", "box_lo", "zprd_grid",
                 "volume", "g_ewald", "slabflag", "lammps_grid",
                 "est_accuracy"):
        assert getattr(tg, name) == getattr(jg, name), name
    for name in ("fkx", "fky", "fkz", "coeffs"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    ref = jg.greens[..., :jg.nz // 2 + 1]
    np.testing.assert_allclose(tg.greens, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_tile_geometry_and_assignment_match(grids):
    jg, tg, x, q, kind = grids
    n = len(x)
    geom = TP._tile_geometry(tg, n)
    assert tuple(geom) == tuple(JP._tile_geometry(jg, n))
    assert geom.z_span == (kind == "slab") and geom.t_tiles > 1
    jasg = jax.jit(lambda xx: JP.tile_assign(jg, xx))(jnp.asarray(x))
    tasg = TP.tile_assign(tg, _tt(x, torch.float64))
    np.testing.assert_array_equal(tasg.slot.numpy(), np.asarray(jasg.slot))
    np.testing.assert_array_equal(tasg.table.numpy(), np.asarray(jasg.table))
    assert bool(tasg.overflow) == bool(jasg.overflow) is False
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32,
                                                   jnp.float32)):
        jrows = jax.jit(lambda xx, qq: JP._pack_slot_rows(
            JP.refresh_tile_slots(jg, jasg, xx, qq), jdt, geom.t_tiles,
            geom.cap))(jnp.asarray(x, jdt), jnp.asarray(q, jdt))
        ts = TP.refresh_tile_slots(tg, tasg, _tt(x, dt), _tt(q, dt))
        np.testing.assert_array_equal(ts.rows.numpy(), np.asarray(jrows))
    assert TP.tile_occupancy(tg, _tt(x, torch.float64)) == \
        JP.tile_occupancy(jg, x)


_ZBIN = {}


def _zbin_both(jg, tg, x, q, jdt, tdt):
    """(rhok, energy, u rows, field) of both packages, each a (jax, torch)
    pair; computed once per grid and precision."""
    key = (id(tg), str(tdt))
    if key in _ZBIN:
        return _ZBIN[key]
    n = len(x)
    xj, qj = jnp.asarray(x, jdt), jnp.asarray(q, jdt)
    xt, qt = _tt(x, tdt), _tt(q, tdt)

    @jax.jit
    def jpath(xj, qj):
        slots = JP.tile_slots(jg, xj, qj)
        rk = JP._spread_rhok_tiled(jg, xj, qj, slots, use_pallas=False)
        e, u = JP.pppm_energy_u_zbin(jg, rk, n)
        return rk, e, u, JP.gather3_ad_zbin(jg, u, xj, slots,
                                            use_pallas=False)

    tslots = TP.tile_slots(tg, xt, qt)
    tr = TP._spread_rhok_tiled(tg, xt, qt, tslots)
    te, tu = TP.pppm_energy_u_zbin(tg, tr, n)
    tf = TP.gather3_ad_zbin(tg, tu, xt, tslots)
    _ZBIN[key] = tuple(zip(jpath(xj, qj), (tr, te, tu, tf)))
    return _ZBIN[key]


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_zbinned_path_matches(grids, prec):
    jg, tg, x, q, _ = grids
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[prec]
    tol = 1e-10 if prec == "f64" else 2e-6
    rhok, (je, te), uz, f = _zbin_both(jg, tg, x, q, jdt, tdt)
    for j, t in (rhok, uz, f):
        j, t = np.asarray(j), t.numpy()
        assert np.isfinite(t).all()
        assert np.abs(t - j).max() <= tol * np.abs(j).max()
    if prec == "f64":
        assert float(te) == pytest.approx(float(je), rel=1e-10)
    else:
        # the energy sums ~nx ny nz/2 float32 terms: JAX's sum is off the
        # float64 value by ~1e-5 (its own tests allow 2e-5), the port's
        # torch.sum by ~2e-7; hold the port to float64 at 2e-6
        e64 = float(_zbin_both(jg, tg, x, q, jnp.float64,
                               torch.float64)[1][1])
        assert float(te) == pytest.approx(e64, rel=2e-6)
        assert float(te) == pytest.approx(float(je), rel=2e-5)


def test_k2a_k3_plain_match_jax_kernels(grids):
    """The plain versions against the JAX Mosaic kernels (interpret mode),
    float32, on the same slot rows and potential rows."""
    from lammps_user_conp2_tpu.ops.pallas.pppm_gather import (
        gather3_tiles_pallas)
    from lammps_user_conp2_tpu.ops.pallas.pppm_spread import (
        spread_mesh_pallas)
    jg, tg, x, q, _ = grids
    n = len(x)
    geom = TP._tile_geometry(tg, n)
    bw, ex, ey, ez = TP._patch_dims(geom)
    xj, qj = jnp.asarray(x, jnp.float32), jnp.asarray(q, jnp.float32)

    @jax.jit
    def jax_side(xj, qj):
        jslots = JP.tile_slots(jg, xj, qj)
        sl = JP._pack_slot_rows(jslots, jnp.float32, geom.t_tiles, geom.cap)
        mz = spread_mesh_pallas(
            sl.reshape(geom.ntx, geom.nty, geom.ntz, 8, geom.cap), jg.coeffs,
            tlx=geom.tlx, tly=geom.tly, ez=ez, bw=bw, ntx=geom.ntx,
            nty=geom.nty, ntz=geom.ntz, cap=geom.cap, interpret=True)
        rhok = JP._spread_rhok_tiled(jg, xj, qj, jslots, use_pallas=False)
        _, uz = JP.pppm_energy_u_zbin(jg, rhok, n)
        up = jnp.pad(uz, ((bw, bw), (bw, bw), (0, 0), (0, 0)), mode="wrap")
        out = gather3_tiles_pallas(JP._zbin_patches(up, geom), sl, jg.coeffs,
                                   ex=ex, ey=ey, ez=ez, cap=geom.cap,
                                   interpret=True)
        return sl, mz, up, out

    sl, mz, up, out = jax_side(xj, qj)
    ref = np.asarray(mz).transpose(1, 2, 0, 3)
    cf = torch.as_tensor(tg.coeffs, dtype=torch.float32)
    rows = torch.as_tensor(np.array(sl))
    got = k2.spread_mesh(rows, cf, geom).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()
    ref = np.asarray(out[:, :3, :].transpose(0, 2, 1)).reshape(-1, 3)
    got = k3.gather3(torch.as_tensor(np.array(up)), rows, cf, geom).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_tile_overflow_fails_loud(grids):
    jg, tg, x, q, _ = grids
    import dataclasses
    small = dataclasses.replace(tg, tile_cap=4)
    xt, qt = _tt(x, torch.float64), _tt(q, torch.float64)
    slots = TP.tile_slots(small, xt, qt)
    assert bool(slots.overflow)
    assert torch.isnan(TP._spread_rhok_tiled(small, xt, qt, slots)).all()
    _, uz = TP.pppm_energy_u_zbin(tg, TP._spread_rhok_tiled(tg, xt, qt),
                                  len(x))
    assert torch.isnan(TP.gather3_ad_zbin(
        small, torch.zeros((tg.nx, tg.ny) + tuple(uz.shape[2:]),
                           dtype=torch.float64), xt, slots)).all()


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(3)
    box = (14.0, 15.0, 40.0)
    n = 200
    x = rng.uniform([0, 0, 4], [14, 15, 36], size=(n, 3))
    q = rng.normal(size=n)
    q -= q.mean()
    args = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                natoms=n, q2=float((q ** 2).sum()), cutoff=6.0, slabflag=True,
                slab_volfactor=3.0)
    jg, tg = JP.setup_pppm(**args), TP.setup_pppm(**args)
    assert TP._use_dense(tg, n)
    return jg, tg, x, q


def test_dense_path_matches(dense):
    jg, tg, x, q = dense
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    xt, qt = _tt(x, torch.float64), _tt(q, torch.float64)
    rho_j, rho_t = JP.spread(jg, xj, qj), TP.spread(tg, xt, qt)
    pairs = [(rho_j, rho_t)]
    rk_j, rk_t = JP.rfft3(jg, rho_j), TP.rfft3(tg, rho_t)
    pairs.append((rk_j, rk_t))
    (ej, uj), (et, ut) = (JP.pppm_energy_u_from_k(jg, rk_j),
                          TP.pppm_energy_u_from_k(tg, rk_t))
    pairs += [(ej, et), (uj, ut),
              (JP.gather3_ad(jg, uj, xj), TP.gather3_ad(tg, ut, xt)),
              (JP.gather(jg, uj, xj), TP.gather(tg, ut, xt))]
    (ej, fj), (et, ft) = (JP.pppm_energy_efield_from_k(jg, rk_j),
                          TP.pppm_energy_efield_from_k(tg, rk_t))
    pairs += [(ej, et), (JP.gather3(jg, fj, xj), TP.gather3(tg, ft, xt))]
    pairs.append((JP.irfft3(jg, rk_j), TP.irfft3(tg, rk_t)))
    for j, t in pairs:
        j, t = np.asarray(j), t.numpy()
        assert np.abs(t - j).max() <= 1e-10 * max(np.abs(j).max(), 1e-300)


def test_fft_stands_in_for_dft_matmuls_f32(dense):
    """float32: torch.fft in place of the JAX package's exact-phase DFT
    matmuls (rfft3/irfft3, _xy_fft2/_xy_ifft2)."""
    jg, tg, x, q = dense
    rho = JP.spread(jg, jnp.asarray(x, jnp.float32),
                    jnp.asarray(q, jnp.float32))
    rk_j = JP.rfft3(jg, rho)
    rk_t = TP.rfft3(tg, torch.as_tensor(np.array(rho)))
    sc = np.abs(np.asarray(rk_j)).max()
    assert np.abs(rk_t.numpy() - np.asarray(rk_j)).max() <= 2e-6 * sc
    back_j = np.asarray(JP.irfft3(jg, rk_j))
    back_t = TP.irfft3(tg, torch.as_tensor(np.array(rk_j))).numpy()
    assert np.abs(back_t - back_j).max() <= 2e-6 * np.abs(back_j).max()
    vre, vim = JP._xy_ifft2(rk_j)
    v = torch.fft.ifftn(torch.as_tensor(np.array(rk_j)), dim=(0, 1))
    assert np.abs(v.real.numpy() - np.asarray(vre)).max() <= 2e-6 * sc
    assert np.abs(v.imag.numpy() - np.asarray(vim)).max() <= 2e-6 * sc


@pytest.fixture(scope="module")
def slab_grid():
    box, x, q, kw = _slab()
    args = dict(box=box, box_lo=(0.0, 0.0, 0.0), accuracy_abs=1e-4,
                natoms=len(x), q2=float((q ** 2).sum()), cutoff=8.0, **kw)
    return JP.setup_pppm(**args), TP.setup_pppm(**args), x, q


@pytest.mark.parametrize("grid_kind", ["dense", "slab"])
def test_zplane_functions_match(dense, slab_grid, grid_kind):
    jg, tg, x, q = dense if grid_kind == "dense" else slab_grid
    # electrode-like atoms: the lowest z layer of the cell
    zlo = np.sort(x[:, 2])[min(40, len(x) - 1)]
    sel = x[:, 2] <= zlo
    xe, qe = x[sel], q[sel]
    zp = TP.electrode_zplanes(tg, xe)
    np.testing.assert_array_equal(zp, JP.electrode_zplanes(jg, xe))
    zpi = TP.zplane_inverse(tg, zp)
    np.testing.assert_array_equal(zpi, JP.zplane_inverse(jg, zp))
    xej, qej = jnp.asarray(xe), jnp.asarray(qe)
    xet, qet = _tt(xe, torch.float64), _tt(qe, torch.float64)
    rp_j, rp_t = (JP.spread_zplanes(jg, xej, qej, zpi),
                  TP.spread_zplanes(tg, xet, qet, zpi))
    rk_j = JP.rhok_from_zplanes(jg, rp_j, zp)
    rk_t = TP.rhok_from_zplanes(tg, rp_t, zp)
    up_j, up_t = JP.u_on_zplanes(jg, rk_j, zp), TP.u_on_zplanes(tg, rk_t, zp)
    for j, t in ((rp_j, rp_t), (rk_j, rk_t), (up_j, up_t),
                 (JP.gather_zplanes(jg, up_j, xej, zpi),
                  TP.gather_zplanes(tg, up_t, xet, zpi))):
        j, t = np.asarray(j), t.numpy()
        assert np.isfinite(t).all()
        assert np.abs(t - j).max() <= 1e-10 * np.abs(j).max()
    # a stencil node off the plane set poisons the output (fail loud)
    far = xet.clone()
    far[0, 2] = float(np.asarray(x)[:, 2].max())
    assert torch.isnan(TP.spread_zplanes(tg, far, qet, zpi)).all()
    assert torch.isnan(TP.gather_zplanes(tg, up_t, far, zpi)).all()
    assert np.isnan(np.asarray(JP.gather_zplanes(
        jg, up_j, jnp.asarray(far.numpy()), zpi))).all()


@pytest.mark.parametrize("m", [2, 4, 5, 9])
def test_weight_matrix_adds_each_stencil_column(m):
    """The dense stencil weights: each row's order-5 weights added at their
    mesh columns, also where a mesh axis shorter than the order wraps a
    row's stencil onto one column more than once (then a column at a time,
    so that the card adds them in a fixed order)."""
    rng = np.random.default_rng(m)
    n, p = 7, 5
    i = np.remainder(rng.integers(0, m, (n, 1)) + np.arange(p) - 2, m)
    w = rng.standard_normal((n, p))
    ref = np.zeros((n, m))
    np.add.at(ref, (np.arange(n)[:, None], i), w)
    got = TP._weight_matrix(m, torch.from_numpy(i), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=1e-15)
