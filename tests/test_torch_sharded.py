"""The port's sharded step (``parallel/sharded.py``) over gloo at d = 2 and
4, float64 on the CPU: each d is one ``spawn_ranks`` call whose ranks run
every case of ``torch_sharded_cases.CASES`` in turn (INV, CG and
CG_MATFREE x EWALD and PPPM on the dense and per-atom list paths on S2;
the odd cell, N = 607 and Ne = 97, where every pad row is used; the block
list on a tiled mesh with the persistent per-rank tile assignment; cond 4
and zmirror 3 on the test-size ionic-liquid file; nevery 2; mobile
electrodes under CG_MATFREE; 20 steps across list rebuilds; the cell list
under INV EWALD, CG_MATFREE PPPM and on the odd cell; the tile path's
engine, whose pairs the sharded step sweeps as dense rows; ``run``
through the graph runner on the block list with CG and the ranks' tile
assignment).

* The sharded state after the case's steps against the port's
  ``Engine.step`` from the same state: q to 1e-10 e, f to 1e-7 + 1e-9
  max|f| (JAX test_sharded.py's tolerances), x, v, pe and the fix scalar
  alike.
* Every rank's replicated x, v and q equal rank 0's bit for bit.
* At d = 2, four cases against the JAX package's sharded engine on a
  2-device CPU mesh (the conftest provides 8 devices): INV EWALD dense on
  S2, the odd cell under CG_MATFREE PPPM nlist, cond 4, and the cell list
  under INV EWALD on S2 (JAX test_sharded.py:98-115's pattern on a
  synthetic cell).
* ``ShardedEngine.run`` through Engine.run's graph runner (each segment
  run eagerly where the card captures and replays it) equals a loop of
  ``ShardedEngine.step`` bit for bit, with thermo rows every step and
  none, through the list rebuilds and CG blocks the eager loop takes.
* A rank that raises fails ``spawn_ranks`` well within its timeout, and
  the ranks imported nothing of jax or the JAX package.
"""

import numpy as np
import pytest

import torch_sharded_cases as tc
from lammps_user_conp2_tpu_torch.parallel.comm import spawn_ranks
from torch_cells import il_small_file

# seconds a spawn may take before every rank is stopped
SPAWN_TIMEOUT = 300.0
JAX_CASES = ("INV-EWALD-dense", "odd-CG_MATFREE-PPPM-nlist", "cond4",
             "cell-INV-EWALD")


@pytest.fixture(scope="module")
def il_path(tmp_path_factory):
    return str(il_small_file(tmp_path_factory.mktemp("il")))


_RUNS = {}


def _run(d, il_path):
    if d not in _RUNS:
        _RUNS[d] = spawn_ranks(tc.run_cases, d, "cpu", tc.CASE_NAMES,
                               il_path, timeout=SPAWN_TIMEOUT)
    return _RUNS[d]


def _close(got, ref, name):
    assert got["step"] == ref["step"], name
    dq = np.abs(got["q"] - ref["q"]).max()
    assert dq <= tc.Q_TOL, f"{name}: max|dq| {dq:.3e}"
    df = np.abs(got["f"] - ref["f"]).max()
    fb = tc.F_ABS + tc.F_REL * np.abs(ref["f"]).max()
    assert df <= fb, f"{name}: max|df| {df:.3e} > {fb:.3e}"
    for k in ("x", "v"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-10,
                                   err_msg=f"{name}: {k}")
    assert got["energy"] == pytest.approx(ref["energy"], rel=1e-9)
    assert got["scalar"] == pytest.approx(ref["scalar"], rel=1e-9,
                                          abs=1e-10)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", tc.CASE_NAMES)
def test_sharded_matches_engine(d, name, il_path):
    results, digests = _run(d, il_path)
    assert results["modules"] == [], results["modules"]
    r = results[name]
    _close(r["sharded"], r["single"], f"d={d} {name}")
    assert r["pe_thermo"] == r["sharded"]["energy"]
    assert all(dg[name] == digests[0][name] for dg in digests), \
        f"d={d} {name}: the ranks' replicated x, v, q differ"
    spec = next(c for c in tc.CASES if c["name"] == name)
    if spec.get("pair") in ("nlist", "block"):
        assert r["list"] and r["block"] == (spec["pair"] == "block")
    if spec.get("pair") == "cell":
        assert not r["list"] and r["cells"] > 1
    if spec.get("pair") == "tile":
        # the engine is the tile path's, with its persistent mesh; the
        # sharded step bins every step, as the JAX step does
        assert not r["list"] and r["pair_cap"] is not None
        assert r["persist"] == (True, False)
    if spec["name"] == "block-tiled-persist":
        assert r["tasg"][0] == "RankTileAssign"
        assert r["rank_cap"] <= -(-r["natoms"] // d) + 1
    if spec["name"] == "reneighbor-20":
        assert r["rebuilds"] > 0 and r["x_ref_moved"]
    if spec.get("cell") == "ODD":
        assert r["natoms"] % d and r["ne"] % d


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_run_replays_the_step(d, il_path):
    results, _ = _run(d, il_path)
    g = results["run-graphed"]["graphed"]
    assert g["run_same"], f"d={d}: run differs from a loop of step"
    assert g["thermo_same"], f"d={d}: run's thermo rows differ"
    assert g["segments"] == ["cg", "head", "pre", "rebuild", "tail",
                             "thermo"]
    # list rebuilds and CG blocks: as many replayed as the eager loop took
    assert g["eager"][0] >= 1 and g["eager"][1] >= 1
    assert g["replayed"] == g["eager"] and g["steps"] == 6


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_matches_jax_sharded(name, il_path):
    import jax
    from jax.sharding import Mesh
    from lammps_user_conp2_tpu import workloads as jwl
    from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
    from lammps_user_conp2_tpu.models.md import build_engine as jbuild
    from lammps_user_conp2_tpu.parallel.sharded import build_sharded_engine
    results, _ = _run(2, il_path)
    spec = next(c for c in tc.CASES if c["name"] == name)
    system, md, cfg, v0 = tc.build_case(spec, jwl, il_path)
    eng = jbuild(system, md, jsetup(system, md, cfg))
    sheng = build_sharded_engine(eng, Mesh(np.array(jax.devices()[:2]),
                                           ("s",)))
    st = eng.init_state(x0=tc.start_positions(spec, system), v0=v0)
    for _ in range(spec.get("steps", 1)):
        st = sheng.step(st)
    ref = dict(x=np.asarray(st.x), v=np.asarray(st.v), q=np.asarray(st.q),
               f=np.asarray(st.f), energy=float(st.energy),
               scalar=float(st.scalar_out), step=int(st.step))
    _close(results[name]["sharded"], ref, f"JAX d=2 {name}")


def test_a_failing_rank_fails_the_call():
    import time
    from torch.multiprocessing import ProcessRaisedException
    t0 = time.monotonic()
    # rank 1's error, or rank 0's lost peer, whichever is seen first
    with pytest.raises(ProcessRaisedException):
        spawn_ranks(tc.fail_on_rank_one, 2, "cpu", timeout=60.0)
    assert time.monotonic() - t0 < 60.0
