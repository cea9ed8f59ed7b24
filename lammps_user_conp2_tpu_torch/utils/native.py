"""ctypes bindings of the port's host library (``csrc/conp2_native.cpp``):
the LAMMPS data-file parser and the dump-frame writer, host code beside
the step (the JAX package's ``utils/native.py``, with the same entry
points and signatures).

The library is built with ``g++`` at first use into ``_build/`` beside
the package sources, under a name that carries a hash of the source and
the flags, so a changed source builds anew; nothing is built when the
module is imported.  ``CONP2_NO_NATIVE=1`` turns it off: ``get_lib``
returns None and the callers take their Python paths
(``utils/data_io.parse_data_file_py``, ``utils/dump.write_dump_frame``),
which are the plain versions the library is held to.  A build that fails
also gives None, with the compiler's message in ``build_error``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "conp2_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_tried = False
# the last failed build's message (None when it built or was not tried)
build_error = None


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libconp2_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` (a temporary name first, so that
    processes building at once never load half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp = os.path.join(tmpdir, "lib.so")
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def get_lib():
    """The loaded library with its entry points declared, or None when
    ``CONP2_NO_NATIVE=1`` or the build failed (``build_error``)."""
    global _lib, _tried, build_error
    if os.environ.get("CONP2_NO_NATIVE") == "1":
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:
        build_error = str(e)
        return None
    P, L, C = ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p
    lib.conp2_open_data.restype = P
    lib.conp2_open_data.argtypes = [C]
    lib.conp2_get_long.restype = L
    lib.conp2_get_long.argtypes = [P, C]
    lib.conp2_close.argtypes = [P]
    lib.conp2_fill.argtypes = [P] * 15
    lib.conp2_fill.restype = None
    lib.conp2_fill_pair_ij.argtypes = [P, P]
    lib.conp2_fill_pair_ij.restype = None
    lib.conp2_write_dump_frame.restype = ctypes.c_int
    lib.conp2_write_dump_frame.argtypes = [C, C, L, L] + [P] * 5
    _lib = lib
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_data_native(path: str):
    """The field dict ``data_io`` finalises (the Python parser's fields, in
    file order), or None without the library or when the file cannot be
    opened; raises ValueError where the Python parser does (a triclinic
    box, Dihedrals or Impropers with entries)."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.conp2_open_data(str(path).encode())
    if not h:
        return None
    try:
        g = lambda f: lib.conp2_get_long(h, f.encode())
        # what parse_data_file_py refuses, refused alike
        if g("triclinic") == 1:
            raise ValueError("triclinic boxes not supported yet")
        for name in ("Dihedrals", "Impropers"):
            if g(name[:-1].lower() + "_rows") > 0:
                raise ValueError(f"{name} present but not supported")
        n = g("natoms")
        nb, na = g("nbonds"), g("nangles")
        nt, nbt, nat = g("natomtypes"), g("nbondtypes"), g("nangletypes")
        boxlo, boxhi = np.zeros(3), np.zeros(3)
        tag = np.zeros(n, np.int64)
        mol = np.zeros(n, np.int64)
        typ = np.zeros(n, np.int64)
        q = np.zeros(n)
        x = np.zeros((n, 3))
        v = np.zeros((n, 3))
        mass = np.zeros(nt + 1)
        pc = np.zeros((nt + 1, 2))
        bc = np.zeros((nbt + 1, 2))
        ac = np.zeros((nat + 1, 2))
        bonds = np.zeros((max(nb, 1), 3), np.int64)
        angles = np.zeros((max(na, 1), 4), np.int64)
        lib.conp2_fill(h, _ptr(boxlo), _ptr(boxhi), _ptr(tag), _ptr(mol),
                       _ptr(typ), _ptr(q), _ptr(x), _ptr(v), _ptr(mass),
                       _ptr(pc), _ptr(bc), _ptr(ac), _ptr(bonds),
                       _ptr(angles))
        pc_ij = None
        if g("has_pair_ij") == 1:
            pc_ij = np.zeros((nt + 1, nt + 1, 2))
            lib.conp2_fill_pair_ij(h, _ptr(pc_ij))
        return dict(natoms=n, natomtypes=nt, box_lo=boxlo, box_hi=boxhi,
                    tag=tag, mol=mol, type=typ, q=q, x=x, v=v,
                    mass_by_type=mass, pair_coeffs=pc, bond_coeffs=bc,
                    angle_coeffs=ac, bonds=bonds[:nb], angles=angles[:na],
                    pair_coeffs_ij=pc_ij)
    finally:
        lib.conp2_close(h)


def write_dump_frame_native(path: str, mode: str, step: int, box_lo, box_hi,
                            tag, x, q=None) -> bool:
    """Write one dump frame to ``path`` (``mode`` "w" or "a") as
    ``utils/dump.write_dump_frame`` does; False without the library or
    when the file cannot be opened."""
    lib = get_lib()
    if lib is None:
        return False
    tag = np.ascontiguousarray(tag, np.int64)
    x = np.ascontiguousarray(x, np.float64)
    lo = np.ascontiguousarray(box_lo, np.float64)
    hi = np.ascontiguousarray(box_hi, np.float64)
    qa = None if q is None else np.ascontiguousarray(q, np.float64)
    rc = lib.conp2_write_dump_frame(
        str(path).encode(), mode.encode(), int(step), len(tag), _ptr(lo),
        _ptr(hi), _ptr(tag), _ptr(x), None if qa is None else _ptr(qa))
    return rc == 0
