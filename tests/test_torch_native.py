"""The port's host library (``csrc/conp2_native.cpp`` through
``utils/native.py``) against its plain versions, the Python parser and the
Python dump writer, as JAX tests/test_native.py holds the JAX package's:

* the library builds here (the host has a toolchain: a failed build is
  reported, not hidden) into ``_build/`` under a name that carries the
  source's hash, never into ``native/``;
* ``parse_data_file`` (the library) equals ``parse_data_file_py`` and the
  JAX package's Python parser field for field, bit for bit, on the files
  the repo writes (the 3,776-atom il cell, the 8,772-atom bonded cell, the
  432-atom dilute cell with no Velocities section) and on a PairIJ file
  with no bond or angle types;
* a dump frame written by the library is the Python writer's text and
  reads back through ``utils/dump.read_dump``;
* both parsers refuse alike what the Python parser refuses (Dihedrals or
  Impropers with entries, a triclinic box);
* ``CONP2_NO_NATIVE=1`` takes the Python paths, and a failed build leaves
  its message in ``build_error``.
"""

import dataclasses
import os

import numpy as np
import pytest

from lammps_user_conp2_tpu.utils import data_io as jdata_io
from lammps_user_conp2_tpu_torch import workloads as twl
from lammps_user_conp2_tpu_torch.utils import data_io, dump, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_OFF = os.environ.get("CONP2_NO_NATIVE") == "1"

_PAIRIJ_DATA = """test PairIJ
4 atoms
2 atom types
0.0 10.0 xlo xhi
0.0 10.0 ylo yhi
0.0 10.0 zlo zhi

Masses

1 1.0
2 2.0

PairIJ Coeffs

1 1 0.1 3.0
1 2 0.2 3.5
2 2 0.3 4.0

Atoms

4 2 2 -0.5 4.0 4.0 4.0
1 1 1 0.5 1.0 1.0 1.0
3 2 2 0.5 3.0 3.0 3.0
2 1 1 -0.5 2.0 2.0 2.0

Velocities

3 0.3 0.0 -0.3
1 0.1 0.0 -0.1
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    (d / "pairij.data").write_text(_PAIRIJ_DATA)
    return {
        "il": twl.write_il_data(d / "il.data"),
        "bonded": twl.write_il_data(d / "bonded.data", n_pairs=1329,
                                    sheets=1, nx=27, ny=16),
        "dilute": twl.write_dilute_data(d / "dilute.data"),
        "pairij": str(d / "pairij.data")}


def _same(a, b):
    for f in dataclasses.fields(a):
        u, w = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, np.ndarray) or isinstance(w, np.ndarray):
            assert u is not None and w is not None, f.name
            assert np.asarray(u).dtype == np.asarray(w).dtype, f.name
            np.testing.assert_array_equal(u, w, err_msg=f.name)
        else:
            assert u == w, f.name


@pytest.mark.skipif(NATIVE_OFF, reason="CONP2_NO_NATIVE=1 is set")
def test_library_builds_into_the_package_build_dir():
    lib = native.get_lib()
    assert lib is not None, native.build_error
    path = native.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "lammps_user_conp2_tpu_torch"
    assert path.name.startswith("libconp2_native_") and len(path.stem) == 32
    assert not any(p.name.startswith("libconp2_native_")
                   for p in (native.PKG_DIR.parent / "native").iterdir())


@pytest.mark.skipif(NATIVE_OFF, reason="CONP2_NO_NATIVE=1 is set")
@pytest.mark.parametrize("name", ["il", "bonded", "dilute", "pairij"])
def test_native_parser_matches_python(files, name, monkeypatch):
    path = files[name]
    py = data_io.parse_data_file_py(path)
    # the default path is the library's: the Python parser is not called
    monkeypatch.setattr(data_io, "parse_data_file_py", None)
    nat = data_io.parse_data_file(path)
    _same(nat, py)
    _same(nat, jdata_io.parse_data_file(path, use_native=False))
    assert nat.natoms == {"il": 3776, "bonded": 8772, "dilute": 432,
                          "pairij": 4}[name]
    if name == "pairij":
        np.testing.assert_array_equal(nat.pair_coeffs_ij[2, 1], [0.2, 3.5])
        np.testing.assert_array_equal(nat.tag, [1, 2, 3, 4])
        np.testing.assert_array_equal(nat.v[:, 0], [0.1, 0.0, 0.3, 0.0])
    if name == "dilute":
        assert not nat.v.any()
    if name == "bonded":
        assert len(nat.bonds) == 2 * 1329 and len(nat.angles) == 1329


@pytest.mark.skipif(NATIVE_OFF, reason="CONP2_NO_NATIVE=1 is set")
def test_native_dump_is_the_python_dump(tmp_path):
    rng = np.random.default_rng(0)
    n = 17
    tag = rng.permutation(n) + 1
    x = rng.uniform(-5, 10, (n, 3))
    q = rng.normal(size=n)
    lo, hi = (0.0, -1.0, 0.5), (10.0, 11.0, 12.5)
    path = str(tmp_path / "t.traj")
    assert native.write_dump_frame_native(path, "w", 5, lo, hi, tag, x, q)
    assert native.write_dump_frame_native(path, "a", 10, lo, hi, tag, 2 * x,
                                          q)
    assert native.write_dump_frame_native(path, "a", 15, lo, hi, tag, x)
    with open(tmp_path / "py.traj", "w") as f:
        dump.write_dump_frame(f, 5, n, lo, hi, tag, x, q)
        dump.write_dump_frame(f, 10, n, lo, hi, tag, 2 * x, q)
        dump.write_dump_frame(f, 15, n, lo, hi, tag, x)
    assert open(path).read() == open(tmp_path / "py.traj").read()
    frames = dump.read_dump(path)
    assert [f[0] for f in frames] == [5, 10, 15]
    order = np.argsort(tag)
    np.testing.assert_array_equal(frames[0][1], tag[order])
    got = np.stack([frames[1][2][c] for c in ("xu", "yu", "zu")], axis=1)
    np.testing.assert_allclose(got, 2 * x[order], rtol=1e-7)
    np.testing.assert_allclose(frames[0][2]["q"], q[order], rtol=1e-7)
    assert not native.write_dump_frame_native(
        str(tmp_path / "no" / "such" / "dir"), "w", 0, lo, hi, tag, x)


@pytest.mark.skipif(NATIVE_OFF, reason="CONP2_NO_NATIVE=1 is set")
@pytest.mark.parametrize("extra,match", [
    ("", None),
    ("\nDihedral Coeffs\n\n1 0.5 1 2\n", None),
    ("\nDihedrals\n\n1 1 1 2 3 4\n", "Dihedrals present"),
    ("\nImpropers\n\n1 1 1 2 3 4\n", "Impropers present"),
    ("triclinic", "triclinic")], ids=["plain", "dihedral_coeffs",
                                       "dihedrals", "impropers",
                                       "triclinic"])
def test_native_refuses_what_python_refuses(files, tmp_path, extra, match):
    """A Dihedral Coeffs section is skipped; Dihedrals or Impropers with
    entries and a triclinic box raise in both parsers alike."""
    text = open(files["pairij"]).read()
    if extra == "triclinic":
        text = text.replace("0.0 10.0 zlo zhi\n",
                            "0.0 10.0 zlo zhi\n0.0 0.0 0.0 xy xz yz\n")
    else:
        text += extra
    path = str(tmp_path / "d.data")
    open(path, "w").write(text)
    if match is None:
        _same(data_io.parse_data_file(path), data_io.parse_data_file_py(path))
        return
    for parse in (data_io.parse_data_file, data_io.parse_data_file_py,
                  native.parse_data_native):
        with pytest.raises(ValueError, match=match):
            parse(path)


def test_no_native_takes_the_python_paths(files, monkeypatch, tmp_path):
    monkeypatch.setenv("CONP2_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.parse_data_native(files["dilute"]) is None
    assert not native.write_dump_frame_native(
        str(tmp_path / "t.traj"), "w", 0, (0, 0, 0), (1, 1, 1), [1],
        np.zeros((1, 3)))
    calls = []
    real = data_io.parse_data_file_py
    monkeypatch.setattr(data_io, "parse_data_file_py",
                        lambda p: calls.append(p) or real(p))
    got = data_io.parse_data_file(files["dilute"])
    assert calls == [files["dilute"]] and got.natoms == 432


def test_a_failed_build_is_reported(monkeypatch, tmp_path):
    monkeypatch.delenv("CONP2_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "lib_path", lambda: tmp_path / "lib.so")
    monkeypatch.setenv("CXX", "false")
    assert native.get_lib() is None
    assert "false failed" in native.build_error
    assert native.parse_data_native(str(tmp_path / "x")) is None
    assert list(tmp_path.iterdir()) == []
