"""CUDA kernels against their plain versions on the card (float32, S2 and
the near-wall positions): max|kernel - plain| / max|plain| <= 2e-5 per
output (tools/kernel_oracle.py's measure), a CUDA float64 tensor raises,
and the engine's main path launches both kernels.  Needs a CUDA device:
skipped on the CPU.  Run on the card with
``python -m pytest tests/test_torch_gpu.py -q``."""

import numpy as np
import pytest
import torch

from torch_cells import S2, charges_with_electrodes, x_close, x_near

pytestmark = pytest.mark.gpu
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _cell(cuda, positions):
    from lammps_user_conp2_tpu_torch import workloads
    from lammps_user_conp2_tpu_torch.models.conp import setup_conp
    from lammps_user_conp2_tpu_torch.models.md import build_engine
    system, md, cfg = workloads.synthetic(**S2)
    conp = setup_conp(system, md, cfg, solve_dtype=torch.float32, device=cuda)
    eng = build_engine(system, md, conp, dtype=torch.float32, device=cuda)
    x = torch.as_tensor(positions(system), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(charges_with_electrodes(system), dtype=torch.float32,
                        device=cuda)
    return system, md, conp, eng, x, q


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_kernels_match_plain_on_card(cuda, positions):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, positions)
    kw = dict(box=system.box, periodic=system.periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    for cf in (None, fuse):
        got = k4.pair_forces(x, q, eng.type_idx, eng.tables, None,
                             conp_fuse=cf, **kw)
        ref = k4.pair_forces_plain(x, q, eng.type_idx, eng.tables, None,
                                   conp_fuse=cf, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    args = (x, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
            conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=system.periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    b = k5.b_realspace(*args, **bkw)
    assert _rel(b, k5.b_realspace_plain(*args, **bkw)) <= TOL
    with pytest.raises(TypeError):
        k5.b_realspace(*(a.double() if a.is_floating_point() else a
                         for a in args), **bkw)


def test_engine_launches_kernels(cuda):
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, x_near)
    k4.launches.reset()
    k5.launches.reset()
    st, _ = eng.run(eng.init_state(x0=x.cpu().numpy()), 3, thermo_every=0)
    torch.cuda.synchronize()
    assert (k4.launches.count, k5.launches.count) == (4, 4)
    assert np.isfinite(float(st.energy))


def test_kernels_periodic_z_on_card(cuda):
    """The periodic-z branches: K4's minimum-image tile gap and K5's three
    z windows, in a fully periodic box, against the plain versions."""
    from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
    from lammps_user_conp2_tpu_torch.ops.kernels import pair_kernel as k4
    system, md, conp, eng, x, q = _cell(cuda, x_close)
    periodic = (True, True, True)
    kw = dict(box=system.box, periodic=periodic, cutoff=md.cutoff,
              g_ewald=conp.ksp.g_ewald, qqr2e=system.units().qqr2e)
    fuse = (eng.ele_flag, eng.elyte_flag, eng.eta_tab, eng.fo_tab)
    # shift z so atoms straddle the periodic z face
    xs = x.clone()
    xs[:, 2] = torch.remainder(xs[:, 2] + 0.5 * system.box[2] - 1.0,
                               system.box[2]) - 0.3
    got = k4.pair_forces(xs, q, eng.type_idx, eng.tables, None,
                         conp_fuse=fuse, **kw)
    ref = k4.pair_forces_plain(xs, q, eng.type_idx, eng.tables, None,
                               conp_fuse=fuse, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= TOL
    q_elyte = torch.where(conp.elyte_t, q, torch.zeros_like(q))
    args = (xs, q_elyte, conp.ele_idx_t, conp.elyte_f, conp.eta_rows,
            conp.fo_rows, conp.type_t)
    bkw = dict(box=system.box, periodic=periodic,
               cut_coulsq=conp.cut_coulsq, g_ewald=conp.ksp.g_ewald)
    b = k5.b_realspace(*args, **bkw)
    ref_b = k5.b_realspace_plain(*args, **bkw)
    assert float(ref_b.abs().max()) > 0.0 and _rel(b, ref_b) <= TOL
