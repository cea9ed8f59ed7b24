"""K6's work order, emulated on the CPU (the kernel itself runs on the card
only; ``tests/test_torch_gpu.py`` holds it to its plain version there).

K6 searches the correction's own range ``r_corr`` (``correction_range``,
float64 from the tables: ERFC_MAX / eta_min with a 1e-5 margin when every
electrode x electrolyte fo is 0, else the cutoff) in two passes over the
compacted z orders (``corr_orders``: the electrolyte's, the electrodes'):
a row per electrode over the electrolyte order, a row per electrolyte atom
over the electrode order, each pair term formed from the electrode's side.

* ``r_corr`` from the engine's tables (the ionic-liquid fixture: 2.93 A of
  a 7 A cutoff) and from non-uniform width tables (the smallest electrode
  x electrolyte width decides; the electrode x electrode entries do not);
  the cutoff when any electrode x electrolyte fo is not 0, when a width is
  not positive, or when ERFC_MAX / eta_min exceeds it.
* ``window_sweep``, the two passes as the kernel walks them (z windows by
  binary search on the sorted keys, three on a periodic z), equals
  ``conp_correction_plain`` at the full cutoff to 1e-12 of the largest
  force and of ecorr in float64, where the correction is not zero (the
  fixture's anions 1.2 A off the inner sheets, S2 1 A from the walls, S2
  in a fully periodic box across its z face, S2 with non-uniform widths);
  both passes find the same pairs; and at S2 it equals the JAX package's
  ``conp_correction_forces`` (rtol 1e-7, atol 1e-8, the K6 tests' measure).
* Every (electrode, electrolyte) pair with r_corr <= r < cutoff has a force
  and an energy term of exactly 0, in float64 and float32.
* ``corr_orders`` on the CPU: each order is the full z order filtered by
  its flag, in the same order.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.electrodes import make_kernels as jkernels
from lammps_user_conp2_tpu.ops.pairs import conp_correction_forces as jcorr
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.electrodes import make_kernels
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.ops.erfc import ERFC_MAX
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k6
from lammps_user_conp2_tpu_torch.ops.kernels.zorder import Z_MARGIN, z_perm
from lammps_user_conp2_tpu_torch.ops.pairs import (gauss_table_kernels,
                                                   min_image)
from torch_cells import (CPU64, S2, SOLVE64, charges_with_electrodes,
                         il_small, il_small_file, x_close)

torch.set_num_threads(2)


def _windows(keys, order, z, zcut, box, periodic):
    """The columns of ``order`` whose sorted keys lie in the z windows of a
    row at z, as the kernel's ``z_windows`` finds them."""
    lz = box[2]
    zw = z - lz * math.floor(z / lz) if periodic[2] else z
    if periodic[2] and 2.0 * zcut >= lz:
        wins = [(-math.inf, math.inf)]
    elif periodic[2]:
        wins = [(zw - zcut + s, zw + zcut + s) for s in (0.0, lz, -lz)]
    else:
        wins = [(zw - zcut, zw + zcut)]
    cols = []
    for lo_v, hi_v in wins:
        lo = int(torch.searchsorted(keys, torch.tensor(lo_v, dtype=keys.dtype)))
        hi = int(torch.searchsorted(keys, torch.tensor(hi_v, dtype=keys.dtype),
                                    right=True))
        cols.append(order[lo:hi])
    return torch.cat(cols)


def window_sweep(x, q, type_idx, ele_idx, ele_f, ely_f, eta_tab, fo_tab, *,
                 box, periodic, r_corr, qqr2e):
    """K6's two passes: (f, ecorr, pairs of pass 1, pairs of pass 2)."""
    potential, force = gauss_table_kernels(eta_tab, fo_tab)
    perm, zs = z_perm(x, box, periodic)
    (lp, lz), (ep, ez) = k6.corr_orders(perm, zs, ely_f, ele_f)
    zcut = r_corr + Z_MARGIN

    def terms(ae, al):
        d = min_image(x[ae] - x[al], box, periodic)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[
            ..., 2]
        keep = rsq < r_corr * r_corr
        pref = qqr2e * q[ae] * q[al]
        ti, tj = type_idx[ae], type_idx[al]
        e = pref * potential(rsq, ti, tj)
        fv = (pref * force(rsq, ti, tj) / rsq)[..., None] * d
        return keep, e, fv

    f = torch.zeros_like(x)
    ecorr = torch.zeros((), dtype=x.dtype)
    pairs1, pairs2 = set(), set()
    for ae in ele_idx.tolist():
        al = _windows(lz, lp, float(x[ae, 2]), zcut, box, periodic)
        keep, e, fv = terms(ae, al)
        f[ae] = fv[keep].sum(0)
        ecorr = ecorr + e[keep].sum()
        pairs1.update((ae, j) for j in al[keep].tolist())
    for al in lp.tolist():
        ae = _windows(ez, ep, float(x[al, 2]), zcut, box, periodic)
        keep, _, fv = terms(ae, al)
        f[al] = -fv[keep].sum(0)
        pairs2.update((i, al) for i in ae[keep].tolist())
    return f, ecorr, pairs1, pairs2


def _args(system, x, q, eta_tab=None, fo_tab=None, cfg=None):
    kern = make_kernels(cfg, system)
    t = torch.as_tensor
    ele = np.nonzero(system.ele_mask)[0]
    return (t(x), t(q), t(system.type), t(ele),
            t((system.elecheck != 0).astype(np.float64)),
            t((~system.ele_mask).astype(np.float64)),
            t(kern.eta_ij if eta_tab is None else eta_tab),
            t(kern.fo_ij if fo_tab is None else fo_tab))


def _range(system, args, cutoff):
    ele = system.ele_mask
    return k6.correction_range(args[6].numpy(), args[7].numpy(),
                               np.unique(system.type[ele]),
                               np.unique(system.type[~ele]), cutoff)


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def _il_case(il_path):
    system, md, cfg = il_small(twl, il_path)
    x = twl.near_sheet_positions(system, gap=1.2, count=4)
    q = charges_with_electrodes(system)
    return system, md, _args(system, x, q, cfg=cfg), system.periodic


def _s2_case(periodic=None, widths=False):
    system, md, cfg = twl.synthetic(**S2)
    x = x_close(system)
    per = system.periodic
    if periodic:
        # every axis periodic, the ions across the z face
        per = (True, True, True)
        lz = system.box[2]
        x = np.array(x)
        x[:, 2] = np.mod(x[:, 2] + 0.5 * lz - 1.0, lz) - 0.3
    eta = None
    if widths:
        rng = np.random.default_rng(3)
        nt1 = system.ntypes + 1
        eta = rng.uniform(1.2, 2.4, (nt1, nt1))
        eta = 0.5 * (eta + eta.T)
    q = charges_with_electrodes(system)
    return system, md, _args(system, x, q, eta_tab=eta, cfg=cfg), per


CASES = {
    "il_1.2A": _il_case,
    "S2_1A": lambda p: _s2_case(),
    "S2_periodic_z": lambda p: _s2_case(periodic=True),
    "S2_widths": lambda p: _s2_case(widths=True),
}


def test_engine_range_from_tables(il_path):
    system, md, cfg = il_small(twl, il_path)
    md = dataclasses.replace(md, use_pallas_pair=False)
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    assert eng.r_corr == pytest.approx(ERFC_MAX / cfg.eta * (1.0 + 1e-5),
                                       rel=1e-15)
    assert 2.9 < eng.r_corr < md.cutoff
    assert torch.equal(eng.corr_gtab, torch.stack([eng.eta_tab,
                                                   eng.fo_tab]))


def test_range_takes_the_smallest_cross_width():
    system, md, args, _ = _s2_case(widths=True)
    ele = system.ele_mask
    eta = args[6].numpy()
    te, tl = np.unique(system.type[ele]), np.unique(system.type[~ele])
    cross = eta[np.ix_(te, tl)].min()
    assert _range(system, args, 100.0) == pytest.approx(
        ERFC_MAX / cross * (1.0 + 1e-5), rel=1e-15)
    # electrode x electrode widths do not enter: make one tiny
    eta2 = eta.copy()
    eta2[te[0], te[0]] = 1e-3
    assert k6.correction_range(eta2, args[7].numpy(), te, tl, 100.0) == (
        _range(system, args, 100.0))


@pytest.mark.parametrize("case", ["overlap", "overlap_same_side", "width",
                                  "beyond_cutoff"])
def test_range_falls_back_to_the_cutoff(case):
    system, md, args, _ = _s2_case()
    ele = system.ele_mask
    te, tl = np.unique(system.type[ele]), np.unique(system.type[~ele])
    eta, fo = args[6].numpy().copy(), args[7].numpy().copy()
    cutoff = md.cutoff
    if case == "overlap":
        fo[te[0], tl[-1]] = 0.5
        assert k6.correction_range(eta, fo, te, tl, cutoff) == cutoff
    elif case == "overlap_same_side":
        fo[te[0], te[0]] = 0.5          # an electrode x electrode entry
        assert k6.correction_range(eta, fo, te, tl, cutoff) < cutoff
    elif case == "width":
        eta[te[-1], tl[0]] = 0.0
        assert k6.correction_range(eta, fo, te, tl, cutoff) == cutoff
    else:
        eta[:] = 0.5 * ERFC_MAX / cutoff
        assert k6.correction_range(eta, fo, te, tl, cutoff) == cutoff


@pytest.mark.parametrize("case", list(CASES))
def test_window_sweep_matches_plain(case, il_path):
    system, md, args, periodic = CASES[case](il_path)
    qqr2e = system.units().qqr2e
    r_corr = _range(system, args, md.cutoff)
    assert r_corr < md.cutoff
    f, ecorr, p1, p2 = window_sweep(*args, box=system.box, periodic=periodic,
                                    r_corr=r_corr, qqr2e=qqr2e)
    pf, pe = k6.conp_correction_plain(*args, box=system.box,
                                      periodic=periodic, cutoff=md.cutoff,
                                      qqr2e=qqr2e)
    assert abs(float(pe)) > 1e-3 and len(p1) > 0
    assert p1 == p2
    scale = float(pf.abs().max())
    assert float((f - pf).abs().max()) <= 1e-12 * scale
    assert abs(float(ecorr - pe)) <= 1e-12 * abs(float(pe))


def test_window_sweep_matches_jax():
    system, md, args, periodic = _s2_case()
    jsys, _, jcfg = jwl.synthetic(**S2)
    kw = dict(box=system.box, periodic=periodic, cutoff=md.cutoff,
              qqr2e=system.units().qqr2e)
    f, ecorr, _, _ = window_sweep(*args, box=system.box, periodic=periodic,
                                  r_corr=_range(system, args, md.cutoff),
                                  qqr2e=kw["qqr2e"])
    jk = jkernels(jcfg, jsys)
    rf, re = jcorr(jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy()),
                   jnp.asarray(jsys.elecheck), jk.force, jk.potential,
                   jnp.asarray(jsys.type), ele_idx=jnp.asarray(args[3].numpy()),
                   **kw)
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=1e-7,
                               atol=1e-8)
    assert float(ecorr) == pytest.approx(float(re), rel=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["il_1.2A", "S2_widths"])
def test_pruned_pairs_are_exactly_zero(case, dtype, il_path):
    system, md, args, periodic = CASES[case](il_path)
    x, q, types, ele_idx, _, ely_f, eta_tab, fo_tab = args
    r_corr = _range(system, args, md.cutoff)
    ely = torch.nonzero(ely_f > 0).squeeze(1)
    potential, force = gauss_table_kernels(eta_tab.to(dtype), fo_tab.to(dtype))
    d = min_image(x[ele_idx][:, None, :].to(dtype) - x[ely][None].to(dtype),
                  system.box, periodic)
    rsq = (d * d).sum(-1)
    rc2 = torch.tensor(r_corr * r_corr, dtype=dtype)
    pruned = (rsq >= rc2) & (rsq < md.cutoff ** 2)
    assert int(pruned.sum()) > 100
    ti, tj = types[ele_idx][:, None], types[ely][None, :]
    assert bool((potential(rsq, ti, tj)[pruned] == 0).all())
    assert bool((force(rsq, ti, tj)[pruned] == 0).all())
    kept = rsq < rc2
    assert bool((potential(rsq, ti, tj)[kept] != 0).any())


def test_corr_orders_on_cpu():
    system, md, args, periodic = _s2_case()
    x, ele_f, ely_f = args[0], args[4], args[5]
    perm, zs = z_perm(x, system.box, periodic)
    (lp, lz), (ep, ez) = k6.corr_orders(perm, zs, ely_f, ele_f)
    assert torch.equal(lp, perm[ely_f[perm] > 0])
    assert torch.equal(ep, perm[ele_f[perm] > 0])
    assert torch.equal(lz, zs[ely_f[perm] > 0])
    assert torch.equal(ez, zs[ele_f[perm] > 0])
    assert lp.numel() + ep.numel() == x.shape[0]
    assert bool((lz[1:] >= lz[:-1]).all()) and bool((ez[1:] >= ez[:-1]).all())
