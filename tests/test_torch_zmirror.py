"""zmirror on the port vs the JAX package, on the doubled test-size
ionic-liquid cell (704 atoms), float64.

* zmirror trial 3 (CONQ, zmirror, PPPM, NOSLAB, zneutr) runs 20 engine
  steps against the JAX engine (test_torch_decks.py's bounds).
* Trial 2 (CONP): after every step the upper half is the lower half
  mirrored, bit for bit; the halves' electrode charges mirror each other
  and each half is neutral (zneutr).
* The period: with every = 3 the mirror applies at the multiples of 3 of
  the device step counter only, as the JAX ZMirror at those steps.
* The tag pairing refuses groups that are not tag-contiguous or not of
  one size, as the JAX package does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu.models import zmirror as jzm
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models import zmirror as tzm
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from test_torch_decks import deck_20_steps_match
from torch_cells import CPU64, SOLVE64, il_small, il_small_file

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


def test_zmirror_deck_20_steps_match(il_path):
    deck_20_steps_match(il_path, "zmirror", 3)


def _mirror_holds(eng, x):
    zm = eng.zmirror
    src, dst = zm.src_idx, zm.dst_idx
    assert torch.equal(x[dst, :2], x[src, :2])
    assert torch.equal(x[dst, 2], zm.zoffset - x[src, 2])


def test_zmirror_holds_every_step(il_path):
    """zmirror trial 2 (CONP, PPPM): after every step the upper half is the
    lower half mirrored, bit for bit; the halves' electrode charges mirror
    each other and each half is neutral (zneutr)."""
    system, md, cfg = il_small(twl, il_path, "zmirror", 2)
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    st = eng.init_state()
    pos = torch.as_tensor(system.x0[:, 2] > 0.0)
    left = torch.as_tensor(system.ele_left_mask)
    right = torch.as_tensor(system.ele_right_mask)
    for _ in range(5):
        st = eng.step(st)
        _mirror_holds(eng, st.x)
        qs = [float(st.q[m].sum()) for m in (left & ~pos, left & pos,
                                             right & ~pos, right & pos)]
        assert qs[0] == pytest.approx(qs[1], abs=1e-8)
        assert qs[2] == pytest.approx(qs[3], abs=1e-8)
        assert abs(qs[0] + qs[2]) < 1e-9
    assert eng.zmirror.every == 1 and len(eng.zmirror.src_idx) > 0


def test_zmirror_period_reads_the_step_counter(il_path):
    """With every = 3 the mirror is applied at the steps that are multiples
    of 3 only, read from the device counter, as the JAX ZMirror does."""
    system, md, cfg = il_small(twl, il_path, "zmirror", 2)
    md = dataclasses.replace(md, zmirror=dataclasses.replace(md.zmirror,
                                                             every=3))
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    jzmir = jzm.build_zmirror(system, "solneg", "solpos", 3)
    x = torch.as_tensor(system.x0) + 0.01
    for step in range(7):
        got = eng.zmirror.apply(x, torch.tensor(step))
        ref = np.asarray(jzmir.apply(jnp.asarray(x.numpy()), step))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert torch.equal(got, x) == (step % 3 != 0)


def test_zmirror_refuses_groups_not_tag_contiguous(il_path):
    system, _, _ = twl.zmirror(2, data_path=il_path)
    groups = dict(system.groups)
    bad = groups["solneg"].copy()
    rows = np.flatnonzero(bad)
    # a hole in the middle of the tag range, and an electrode atom instead:
    # the same size, tags not contiguous
    bad[rows[np.argsort(system.tag[rows])[len(rows) // 2]]] = False
    bad[np.flatnonzero(system.ele_mask)[0]] = True
    groups["solneg"] = bad
    system = dataclasses.replace(system, groups=groups)
    for build in (tzm.build_zmirror, jzm.build_zmirror):
        with pytest.raises(ValueError, match="tag-contiguous"):
            build(system, "solneg", "solpos", 1)
    groups["solneg"] = groups["solneg"] & (np.arange(system.natoms) % 2 == 0)
    system = dataclasses.replace(system, groups=groups)
    for build in (tzm.build_zmirror, jzm.build_zmirror):
        with pytest.raises(ValueError, match="same size"):
            build(system, "solneg", "solpos", 1)
