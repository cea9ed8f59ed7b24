"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use into ``_build/`` beside the package sources and is redone
whenever a source (or the flags) change: the library's name carries a hash
of both.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Number of kernel launches a wrapper has made since the last reset."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


class BuildInfo:
    """What the last ``load_library`` call did: the library path, the build
    seconds (None when a library with the same hash was already there) and
    the compiler's register/shared-memory report."""
    path: Path = None
    seconds: float = None
    log: str = ""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the CDLL with
    every entry's argtypes declared.  Raises if the build fails."""
    lib_path = BUILD_DIR / f"libconp2_kernels_{_digest()}.so"
    BuildInfo.path = lib_path
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu],
            capture_output=True, text=True)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed:\n" + BuildInfo.log)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.conp2_pair_forces_f32.argtypes = (
        [P] * 9 + [I, I] + [F, F, F] + [I, I, I] + [F, F, F, F] + [P, P, P, P])
    lib.conp2_pair_forces_f32.restype = I
    lib.conp2_pair_tile_rows.argtypes = []
    lib.conp2_pair_tile_rows.restype = I
    lib.conp2_b_realspace_f32.argtypes = (
        [P] * 9 + [I, I, I] + [F, F, F] + [I, I, I] + [F, F, F] + [P, P])
    lib.conp2_b_realspace_f32.restype = I
    return lib


def check_cuda(name: str, dtype, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
