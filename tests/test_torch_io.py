"""Port vs JAX package: the trajectory dump, rerun, the LAMMPS log parser
and the checkpoint (``utils/dump``, ``utils/lammps_log``,
``utils/checkpoint``).

* a dump frame (with and without charges) is text-identical to the JAX
  writer's, and ``read_dump`` gives the JAX reader's frames;
* ``rerun_charges`` on frames of the 352-atom ionic-liquid fixture (whose
  rows ``electrodes_first`` reorders) equals the JAX one to 1e-10, and
  raises without the tags;
* ``parse_thermo_blocks`` finds the JAX parser's blocks in a log with two
  thermo blocks, comments and a truncated row;
* a checkpoint after 4 steps, loaded into a fresh engine and run 4 more,
  equals 8 uninterrupted steps bit for bit on the CPU (the fixture with
  SHAKE; S3 on the block list with PPPM, CG and nevery 2, whose warm
  start, step counter and list the file must carry); loading into a
  set-up with another tag order, another cutoff, or another solve
  context raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.utils import dump as jdump
from lammps_user_conp2_tpu.utils import lammps_log as jlog
from lammps_user_conp2_tpu_torch import interop
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.md import build_engine as tbuild
from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
from lammps_user_conp2_tpu_torch.utils import checkpoint as ckpt
from lammps_user_conp2_tpu_torch.utils import dump, lammps_log
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle as TK
from lammps_user_conp2_tpu_torch.utils.config import Solver
from torch_cells import (CPU64, SOLVE64, il_small, il_small_file, pppm_cell,
                         rel_err, x_near)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return il_small_file(tmp_path_factory.mktemp("il"))


@pytest.fixture(scope="module")
def il_frames(il_path, tmp_path_factory):
    """(system, port engine, dump path) of 3 frames 2 steps apart."""
    system, md, cfg = il_small(twl, il_path)
    eng = tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)
    st = eng.init_state()
    path = tmp_path_factory.mktemp("dump") / "traj"
    with open(path, "w") as f:
        for _ in range(3):
            st, _ = eng.run(st, 2, thermo_every=0)
            dump.write_dump_frame(f, st.step, system.natoms, system.box_lo,
                                  system.box_hi, system.tag, st.x.numpy(),
                                  st.q.numpy())
    return system, eng, path


@pytest.mark.parametrize("charges", [True, False], ids=["q", "noq"])
def test_dump_frame_text_matches_jax(il_frames, tmp_path, charges):
    system, eng, _ = il_frames
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 50, (system.natoms, 3))
    q = rng.standard_normal(system.natoms) if charges else None
    args = (17, system.natoms, system.box_lo, system.box_hi, system.tag, x, q)
    with open(tmp_path / "t", "w") as f:
        dump.write_dump_frame(f, *args)
    with open(tmp_path / "j", "w") as f:
        jdump.write_dump_frame(f, *args)
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    tf, jf = dump.read_dump(tmp_path / "t"), jdump.read_dump(tmp_path / "j")
    assert len(tf) == len(jf) == 1
    assert tf[0][0] == jf[0][0] == 17
    np.testing.assert_array_equal(tf[0][1], jf[0][1])
    assert tf[0][2].keys() == jf[0][2].keys()
    for k in tf[0][2]:
        np.testing.assert_array_equal(tf[0][2][k], jf[0][2][k])


def test_rerun_charges_match_jax(il_frames, il_path):
    system, eng, path = il_frames
    frames = dump.read_dump(str(path))
    assert [f[0] for f in frames] == [2, 4, 6]
    js, jmd, jcfg = il_small(jwl, il_path)
    jsol = jsetup(js, jmd, jcfg)
    tsol = eng.conp
    tsol.load_context(interop.context_from_numpy(
        {k: np.asarray(v) for k, v in jsol.ctx._asdict().items()}, **CPU64))
    got = dump.rerun_charges(tsol, frames, system.q0, tags=system.tag)
    want = jdump.rerun_charges(jsol, frames, system.q0, tags=system.tag)
    assert len(got) == len(want) == 3
    for (s1, q1, f1), (s2, q2, f2) in zip(got, want):
        assert s1 == s2
        assert rel_err(q1, q2) < 1e-10
        assert f1 == pytest.approx(f2, rel=1e-10)
    with pytest.raises(ValueError, match="tags"):
        dump.rerun_charges(tsol, frames, system.q0, tags=None)
    with pytest.raises(TypeError):
        dump.rerun_charges(tsol, frames, system.q0)


def test_parse_thermo_blocks_matches_jax(tmp_path):
    log = tmp_path / "log"
    log.write_text(
        "LAMMPS (29 Oct 2020)\n# comment\n"
        "Step Temp c_qleft PotEng\n0 300 0.1 -5.5\n10 301.5 0.12 -5.25\n"
        "20 302 0.13\nLoop time of 1.0 on 1 procs\n\n"
        "Step Temp PotEng\n0 310 -4\n5 nan -4.5\n7 x 1\n")
    tb, jb = lammps_log.parse_thermo_blocks(log), jlog.parse_thermo_blocks(log)
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    assert len(tb[0]["Step"]) == 2 and len(tb[1]["Step"]) == 2


def _cell(name, il_path, **md_kw):
    if name == "il":
        system, md, cfg = il_small(twl, il_path)
        x0 = None
    else:
        system, md, cfg = pppm_cell(twl, TK, pair_path="block",
                                    neighbor_skin=0.05)
        cfg = dataclasses.replace(cfg, solver=Solver.CG, nevery=2)
        x0 = x_near(system)
    return system, dataclasses.replace(md, **md_kw), cfg, x0


def _engine(system, md, cfg):
    return tbuild(system, md, tsetup(system, md, cfg, **SOLVE64), **CPU64)


def _same(a, b):
    for k in ("x", "v", "q", "f", "energy", "scalar_out", "nhc_xi",
              "nhc_vxi", "step_t"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


@pytest.mark.parametrize("name", ["il", "S3_cg"])
def test_checkpoint_resume_is_bit_identical(il_path, tmp_path, name):
    system, md, cfg, x0 = _cell(name, il_path)
    eng = _engine(system, md, cfg)
    st0 = eng.init_state(x0=x0)
    full, th_full = eng.run(st0, 8, thermo_every=2)
    half, _ = eng.run(st0, 4, thermo_every=2)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, eng, half)
    fresh = _engine(system, md, cfg)
    resumed = ckpt.load_checkpoint(path, fresh)
    _same(resumed, half)
    if eng.ncfg is not None:
        # the list was rebuilt within the first 4 steps, not at step 4
        assert eng.rebuilds > 0 and not torch.equal(half.nbr.x_ref, half.x)
        assert torch.equal(resumed.nbr.idx, half.nbr.idx)
    end, th_end = fresh.run(resumed, 4, thermo_every=2)
    _same(end, full)
    for k in th_full:
        assert torch.equal(torch.as_tensor(th_end[k]),
                           torch.as_tensor(th_full[k])[2:]), k


def test_checkpoint_refuses_another_setup(il_path, tmp_path):
    system, md, cfg, x0 = _cell("il", il_path)
    eng = _engine(system, md, cfg)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, eng, eng.init_state())
    perm = np.roll(np.arange(system.natoms), 3)
    with pytest.raises(ValueError, match="tags"):
        ckpt.load_checkpoint(path, _engine(reorder_atoms(system, perm), md,
                                           cfg))
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.load_checkpoint(path, _engine(
            system, dataclasses.replace(md, cutoff=md.cutoff - 0.5), cfg))
    with pytest.raises(ValueError, match="A\\^-1"):
        ckpt.load_checkpoint(path, _engine(
            system, md, dataclasses.replace(cfg, eta=cfg.eta * 1.1)))
