"""Port vs JAX package: Ewald setup (g_ewald, k-vectors, factorization) to
roundoff, and the factored per-step sums on S2 at jittered positions to a
relative 1e-10 (float64 on both sides; only the summation order differs)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu.ops import ewald as jew
from lammps_user_conp2_tpu.ops import ewald_factored as jewf
from lammps_user_conp2_tpu.ops import pppm as jpppm
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.ops import ewald as tew
from lammps_user_conp2_tpu_torch.ops import ewald_factored as tewf
from lammps_user_conp2_tpu_torch.ops import pppm as tpppm
from torch_cells import S1, S2, charges_with_electrodes, rel_err, x_near

torch.set_num_threads(2)


def _ewald_params(cell):
    system, md, _ = twl.synthetic(**cell)
    u = system.units()
    q2 = float((system.q0 ** 2).sum()) * u.qqr2e
    return system, md, dict(box=system.box,
                            accuracy_abs=md.kspace_accuracy * u.qqr2e,
                            natoms=system.natoms, q2=q2)


@pytest.mark.parametrize("cell", [S1, S2], ids=["S1", "S2"])
def test_setup_matches(cell):
    system, md, kw = _ewald_params(cell)
    gk = dict(cutoff=md.cutoff, slab_volfactor=md.slab)
    tg = tpppm.set_grid_and_gewald(**kw, **gk)
    jg = jpppm.set_grid_and_gewald(**kw, **gk)
    assert tg[1] == jg[1]
    assert tg[0] == pytest.approx(jg[0], rel=1e-14)
    assert tg[2] == pytest.approx(jg[2], rel=1e-14)
    g = tg[0]
    assert tew.determine_g_ewald_box(
        kw["accuracy_abs"], md.cutoff, kw["natoms"], kw["q2"], *kw["box"]
    ) == jew.determine_g_ewald_box(
        kw["accuracy_abs"], md.cutoff, kw["natoms"], kw["q2"], *kw["box"])
    sk = dict(g_ewald=g, slabflag=True, slab_volfactor=md.slab, **kw)
    tk, jk = tew.setup_ewald(**sk), jew.setup_ewald(**sk)
    assert tk.kcount == jk.kcount
    assert (tk.kxmax, tk.kymax, tk.kzmax) == (jk.kxmax, jk.kymax, jk.kzmax)
    assert tk.g_ewald == jk.g_ewald and tk.volume == jk.volume
    np.testing.assert_array_equal(tk.kvecs, jk.kvecs)
    np.testing.assert_allclose(tk.ug, jk.ug, rtol=1e-14)
    assert tk.ug_tot == pytest.approx(jk.ug_tot, rel=1e-14)
    tf, jf = tewf.factorize(tk), jewf.factorize(jk)
    np.testing.assert_array_equal(tf.kxy, jf.kxy)
    np.testing.assert_array_equal(tf.kz, jf.kz)
    np.testing.assert_allclose(tf.ug, jf.ug, rtol=1e-14, atol=0)
    np.testing.assert_allclose(tf.unitk, jf.unitk, rtol=1e-15)
    assert tf.ug_tot == pytest.approx(jf.ug_tot, rel=1e-14)
    np.testing.assert_array_equal(tf.ug_t.numpy(), tf.ug)


def test_factored_sums_match_on_s2():
    system, md, kw = _ewald_params(S2)
    g = tpppm.set_grid_and_gewald(cutoff=md.cutoff, slab_volfactor=md.slab,
                                  **kw)[0]
    sk = dict(g_ewald=g, slabflag=True, slab_volfactor=md.slab, **kw)
    tf = tewf.factorize(tew.setup_ewald(**sk))
    jf = jewf.factorize(jew.setup_ewald(**sk))
    x = x_near(system)
    q = charges_with_electrodes(system)
    ne = int(system.ele_mask.sum())
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    xj, qj = jnp.asarray(x), jnp.asarray(q)

    ttab = tewf.axis_tables(tf, xt)
    jtab = jewf.axis_tables(jf, xj)
    for a, b in zip((*ttab[0], *ttab[1]), (*jtab[0], *jtab[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)

    q_ely = np.where(system.ele_mask, 0.0, q)
    tsr, tsi = tewf.structure_factor_tab(ttab, torch.from_numpy(q_ely))
    jsr, jsi = jewf.structure_factor_tab(jtab, jnp.asarray(q_ely))
    assert rel_err(tsr, jsr) < 1e-10 and rel_err(tsi, jsi) < 1e-10

    cut = lambda tabs: ((tabs[0][0][:ne], tabs[0][1][:ne]),
                        (tabs[1][0][:ne], tabs[1][1][:ne]))
    tphi = tewf.potential_on_points_tab(cut(ttab), tsr, tsi, tf.ug_t)
    jphi = jewf.potential_on_points_tab(cut(jtab), jsr, jsi, jf.ug)
    assert rel_err(tphi, jphi) < 1e-10

    te, tfk = tewf.energy_forces_cached(tf, qt, ttab, tsr, tsi, ne)
    je, jfk = jewf.energy_forces_cached(jf, qj, jtab, jsr, jsi,
                                        jnp.arange(ne), contig=True)
    assert float(te) == pytest.approx(float(je), rel=1e-10)
    assert rel_err(tfk, jfk) < 1e-10

    te2, tfk2 = tewf.energy_forces_f(tf, xt, qt)
    je2, jfk2 = jewf.energy_forces_f(jf, xj, qj)
    assert float(te2) == pytest.approx(float(je2), rel=1e-10)
    assert rel_err(tfk2, jfk2) < 1e-10
    # the cached path at the same positions is the same physics
    assert float(te2) == pytest.approx(float(te), rel=1e-10)

    es, fs = tew.slab_correction_energy_forces(xt, qt, tf.volume)
    jes, jfs = jew.slab_correction_energy_forces(xj, qj, jf.volume)
    assert float(es) == pytest.approx(float(jes), rel=1e-12)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=1e-12)


@pytest.mark.parametrize("plane_max", [64, 0], ids=["planes", "chunked"])
def test_amatrix_kspace_host_matches(plane_max):
    system, md, kw = _ewald_params(S1)
    sk = dict(g_ewald=0.53, slabflag=True, slab_volfactor=md.slab, **kw)
    tk, jk = tew.setup_ewald(**sk), jew.setup_ewald(**sk)
    xe = x_near(system)[system.ele_mask]
    a = tewf.amatrix_kspace_host(xe, tk, plane_max=plane_max, chunk=1000)
    b = jewf.amatrix_kspace_host(xe, jk, plane_max=plane_max, chunk=1000)
    assert rel_err(a, b) < 1e-12
    # and the direct (Ne, K) trig sum of the JAX package
    c = np.asarray(jew.amatrix_kspace(jnp.asarray(xe), jk))
    assert rel_err(a, c) < 1e-10
    assert math.isfinite(float(a.sum()))
