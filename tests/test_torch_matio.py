"""Port vs JAX package: the A-matrix files (``utils/matio``; the matout,
org and inv keywords, ``setup_conp``'s ``matout``, ``a_file`` and
``ainv_file``).

* a write/read round trip puts rows and columns in the wanted tag order;
  a missing tag and a wrong entry count raise;
* the writer's text equals the JAX writer's on the same matrix and tags;
* ``matout`` writes ``amatrix`` and ``inv_a_matrix`` byte-identical to the
  JAX package's on S1;
* set-ups that read the files, on the same cell and on the cell with its
  atoms permuted (the file's rows then map by tag), match the in-memory
  A^-1 to the format's precision: 1e-12 absolute from ``inv_a_matrix``
  (%20.12f), 1e-9 relative through A's inverse from ``amatrix``.
"""

import dataclasses

import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads as jwl
from lammps_user_conp2_tpu.models.conp import setup_conp as jsetup
from lammps_user_conp2_tpu.utils import matio as jmatio
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.models.conp import setup_conp as tsetup
from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
from lammps_user_conp2_tpu_torch.utils import matio
from torch_cells import S1, SOLVE64, rel_err


def _matrix(ne, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ne, ne)) * 10.0 ** rng.integers(-3, 3, (ne, ne))


def test_round_trip_permutes_by_tag(tmp_path):
    ne = 9
    rng = np.random.default_rng(1)
    tags = rng.permutation(np.arange(100, 100 + ne))
    mat = _matrix(ne)
    matio.write_matrix(str(tmp_path / "m"), tags, mat)
    want = rng.permutation(tags)
    got_tags, got = matio.read_matrix(str(tmp_path / "m"), want)
    np.testing.assert_array_equal(got_tags, want)
    pos = [int(np.nonzero(tags == t)[0][0]) for t in want]
    np.testing.assert_allclose(got, mat[np.ix_(pos, pos)], rtol=0,
                               atol=5e-13)


def test_missing_tag_and_wrong_count_raise(tmp_path):
    tags = np.arange(1, 5)
    matio.write_matrix(str(tmp_path / "m"), tags, _matrix(4))
    with pytest.raises(ValueError, match="tag 7 missing"):
        matio.read_matrix(str(tmp_path / "m"), np.array([1, 2, 3, 7]))
    text = (tmp_path / "m").read_text().splitlines()
    (tmp_path / "short").write_text("\n".join(text[:-1]) + "\n")
    with pytest.raises(ValueError, match="has 12 entries, expected 16"):
        matio.read_matrix(str(tmp_path / "short"), tags)
    with pytest.raises(ValueError):
        matio.write_matrix(str(tmp_path / "bad"), tags, _matrix(3))


@pytest.mark.parametrize("digits", [12, 10])
def test_writer_text_matches_jax(tmp_path, digits):
    tags = np.array([5, 3, 11, 2, 8])
    mat = _matrix(5, seed=2)
    matio.write_matrix(str(tmp_path / "t"), tags, mat, digits=digits)
    jmatio.write_matrix(str(tmp_path / "j"), tags, mat, digits=digits)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.fixture(scope="module")
def matout_dirs(tmp_path_factory):
    """matout set-ups of S1 in both packages, each in its own directory."""
    js, jmd, jcfg = jwl.synthetic(**S1)
    ts, tmd, tcfg = twl.synthetic(**S1)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("t")
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(jdir)
        jsetup(js, jmd, dataclasses.replace(jcfg, matout=True))
        mp.chdir(tdir)
        tsol = tsetup(ts, tmd, dataclasses.replace(tcfg, matout=True),
                      **SOLVE64)
    finally:
        mp.undo()
    return jdir, tdir, tsol


@pytest.mark.parametrize("name", ["amatrix", "inv_a_matrix"])
def test_matout_files_match_jax_bytes(matout_dirs, name):
    jdir, tdir, _ = matout_dirs
    assert (tdir / name).read_bytes() == (jdir / name).read_bytes()


@pytest.mark.parametrize("scrambled", [False, True],
                         ids=["same", "permuted"])
@pytest.mark.parametrize("key", ["ainv_file", "a_file"])
def test_file_setups_match_in_memory(matout_dirs, key, scrambled):
    _, tdir, tsol = matout_dirs
    system, md, cfg = twl.synthetic(**S1)
    ref = tsol.ainv.numpy()
    if scrambled:
        perm = np.random.default_rng(3).permutation(system.natoms)
        system = reorder_atoms(system, perm)
        # the in-memory inverse in the permuted electrode order
        # (scrambled row r is row perm[r])
        pos = {int(row): i for i, row in enumerate(tsol.ele_idx)}
        order = [pos[int(perm[r])] for r in np.nonzero(system.ele_mask)[0]]
        ref = ref[np.ix_(order, order)]
    fname = "inv_a_matrix" if key == "ainv_file" else "amatrix"
    sol = tsetup(system, md, dataclasses.replace(cfg, **{
        key: str(tdir / fname)}), **SOLVE64)
    if key == "ainv_file":
        assert float(np.abs(sol.ainv.numpy() - ref).max()) <= 5e-13
    else:
        assert rel_err(sol.ainv.numpy(), ref) < 1e-9
