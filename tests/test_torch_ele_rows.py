"""Port vs JAX package: the electrode b rows (K5).  The port's plain version
(the CPU path of ``b_realspace``) against the JAX Pallas kernel in
interpret mode and against the JAX dense branch (conp.py:241-251), on S2
with jittered positions; float64, atol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu.ops.erfc import erfcr_sqrt
from lammps_user_conp2_tpu.ops.pairs import eta_pair_kernels, min_image
from lammps_user_conp2_tpu.ops.pallas.ele_rows_kernel import b_realspace_pallas
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel as k5
from torch_cells import S2, charges_with_electrodes, x_close, x_near

torch.set_num_threads(2)

G_EWALD = 0.5287930588017317     # S2's g_ewald (set_grid_and_gewald)
ETA = 1.979
CUT_COULSQ = 25.0


@pytest.mark.parametrize("positions", [x_near, x_close],
                         ids=["x_near", "x_close"])
def test_b_rows_plain_matches_jax(positions):
    system, md, _ = twl.synthetic(**S2)
    x = positions(system)
    q = charges_with_electrodes(system)
    elyte = ~system.ele_mask
    q_elyte = np.where(elyte, q, 0.0)
    ele_idx = np.nonzero(system.ele_mask)[0]
    nt1 = system.ntypes + 1
    te = system.type[ele_idx]
    eta_rows = np.full((nt1, nt1), ETA)[te]
    fo_rows = np.zeros((len(ele_idx), nt1))
    kw = dict(box=system.box, periodic=system.periodic,
              cut_coulsq=CUT_COULSQ, g_ewald=G_EWALD)

    ohc = (system.type[:, None] == np.arange(nt1)[None, :]).astype(np.float64)
    jb = np.asarray(b_realspace_pallas(
        jnp.asarray(x), jnp.asarray(q_elyte), jnp.asarray(ele_idx),
        jnp.asarray(elyte.astype(np.float64)), jnp.asarray(eta_rows),
        jnp.asarray(fo_rows), jnp.asarray(ohc), tr=128, tc=128,
        interpret=True, **kw))
    # the JAX dense branch of b_vector_full
    xj = jnp.asarray(x)
    dx = min_image(xj[ele_idx][:, None, :] - xj[None, :, :],
                   jnp.asarray(system.box), system.periodic)
    rsq = jnp.sum(dx * dx, axis=-1)
    mask = jnp.asarray(elyte)[None, :] & (rsq < CUT_COULSQ)
    rsq_s = jnp.where(mask, rsq, 1.0)
    pot = eta_pair_kernels(ETA)[0]
    dudq = erfcr_sqrt(G_EWALD ** 2 * rsq_s) * G_EWALD + pot(rsq_s, None, None)
    jd = -np.asarray(jnp.sum(jnp.where(mask, dudq, 0.0)
                             * jnp.asarray(q_elyte)[None, :], axis=1))

    args = (torch.from_numpy(x), torch.from_numpy(q_elyte),
            torch.from_numpy(ele_idx), torch.from_numpy(elyte.astype(float)),
            torch.from_numpy(eta_rows), torch.from_numpy(fo_rows),
            torch.as_tensor(system.type))
    for fn in (k5.b_realspace, k5.b_realspace_plain):   # CPU: both plain
        tb = fn(*args, **kw).numpy()
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tb, jd, rtol=0, atol=1e-12)
    assert np.abs(jb).max() > 1e-3          # ions within the cutoff
    assert k5.launches.count == 0
