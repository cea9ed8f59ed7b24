"""Build and load the CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and the objects are linked into one shared
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


COUNTERS: list = []


class LaunchCounter:
    """Number of kernel launches a wrapper has made since the last reset.
    The wrapper counts in Python, where it launches; a CUDA graph that
    captured the launch replays it without Python, so the step's graph
    runner (``models/graphs.py``) adds each graph's captured counts on
    every replay.  ``COUNTERS`` holds every counter made."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS.append(self)

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
        cu = [p for p in _sources() if p.suffix == ".cu"]
        tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
        t0 = time.perf_counter()
        try:
            objs = [os.path.join(tmpdir, p.stem + ".o") for p in cu]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", o,
                 str(p)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for p, o in zip(cu, objs)]
            logs = [pr.communicate()[0] for pr in procs]
            BuildInfo.log = "".join(logs)
            if any(pr.returncode != 0 for pr in procs):
                raise RuntimeError("nvcc failed:\n" + BuildInfo.log)
            tmp = os.path.join(tmpdir, "lib.so")
            link = subprocess.run(
                [_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                capture_output=True, text=True)
            BuildInfo.log += link.stdout + link.stderr
            if link.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + BuildInfo.log)
            os.replace(tmp, lib_path)
        finally:
            BuildInfo.seconds = time.perf_counter() - t0
            shutil.rmtree(tmpdir, ignore_errors=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    F, D = ctypes.c_float, ctypes.c_double
    lib.conp2_pair_forces_f32.argtypes = (
        [P] * 15 + [I] * 3 + [F] * 3 + [I] * 3 + [F] * 5 + [I] + [P] * 6)
    lib.conp2_pair_forces_f32.restype = I
    lib.conp2_pair_items_f32.argtypes = (
        [P] * 15 + [I] * 5 + [F] * 3 + [I] * 3 + [F] * 3 + [I] + [P] * 5)
    lib.conp2_pair_items_f32.restype = I
    lib.conp2_pair_sweep_ctas.argtypes = [I, I, I, I]
    lib.conp2_pair_sweep_ctas.restype = I
    lib.conp2_pair_schedule_i32.argtypes = [P, I, I, F, F, P, P]
    lib.conp2_pair_schedule_i32.restype = I
    lib.conp2_b_realspace_f32.argtypes = (
        [P] * 9 + [I] * 3 + [F] * 3 + [I] * 3 + [F] * 3 + [P] * 3)
    lib.conp2_b_order_i32.argtypes = [P, P, P, I, P, P]
    lib.conp2_b_order_i32.restype = I
    lib.conp2_b_realspace_f32.restype = I
    lib.conp2_conp_correction_f32.argtypes = (
        [P] * 9 + [I] * 3 + [F] * 3 + [I] * 3 + [F] * 3 + [P] * 5)
    lib.conp2_conp_correction_f32.restype = I
    lib.conp2_corr_order_i32.argtypes = [P] * 4 + [I, P, P]
    lib.conp2_corr_order_i32.restype = I
    lib.conp2_corr_rows.argtypes = []
    lib.conp2_corr_rows.restype = I
    lib.conp2_block_pair_f32.argtypes = (
        [P] * 13 + [I] * 8 + [F] * 3 + [I] * 3 + [F] * 3 + [P] * 4)
    lib.conp2_block_pair_f32.restype = I
    lib.conp2_block_pack_f32.argtypes = [P] * 5 + [I, P, P]
    lib.conp2_block_pack_f32.restype = I
    lib.conp2_spread_mesh_f32.argtypes = [P, P] + [I] * 8 + [P, P]
    lib.conp2_spread_mesh_f32.restype = I
    lib.conp2_spread_mesh_pass_cap.argtypes = [I] * 3
    lib.conp2_spread_mesh_pass_cap.restype = I
    lib.conp2_spread_tiles_f32.argtypes = [P, P] + [I] * 5 + [P, P]
    lib.conp2_spread_tiles_f32.restype = I
    lib.conp2_gather3_f32.argtypes = [P] * 3 + [I] * 8 + [P, P]
    lib.conp2_gather3_f32.restype = I
    lib.conp2_stencil_spread_f32.argtypes = [P] * 5 + [I] * 6 + [F] * 6 + [
        P, P]
    lib.conp2_stencil_spread_f32.restype = I
    lib.conp2_stencil_readout_f32.argtypes = (
        [P] * 3 + [I] * 5 + [P] * 2 + [F] + [P] * 2 + [I] * 6 + [F] * 9
        + [P] * 2)
    lib.conp2_stencil_readout_f32.restype = I
    lib.conp2_shake_positions_f32.argtypes = (
        [P] * 4 + [I] * 5 + [F] + [F] * 3 + [I] * 3 + [P] * 3)
    lib.conp2_shake_positions_f32.restype = I
    lib.conp2_rattle_velocities_f32.argtypes = (
        [P] * 4 + [I] * 5 + [F] * 3 + [I] * 3 + [P] * 2)
    lib.conp2_rattle_velocities_f32.restype = I
    lib.conp2_window_gather_f32.argtypes = [P, P] + [I] * 7 + [P, P]
    lib.conp2_window_gather_f32.restype = I
    lib.conp2_integrate_half_f32.argtypes = (
        [P] * 9 + [I] * 6 + [F] + [D] * 4 + [I] * 2 + [P] * 6)
    lib.conp2_integrate_half_f32.restype = I
    return lib


def kernel_route(name: str, t: torch.Tensor) -> bool:
    """The dtype rule of every kernel wrapper, read from the tensor ``t``
    that the wrapper dispatches on: True (launch the CUDA kernel) for a
    CUDA float32 tensor; False (the plain PyTorch version) for a CPU
    tensor, and for a CUDA float64 tensor, where the plain version runs on
    the device (the kernels are float32 only, as the JAX package gates its
    Pallas kernels off in float64); raises TypeError for a CUDA tensor of
    any other dtype.  The choice rests on the device and dtype alone: a
    kernel that fails to build or launch raises, it never falls back."""
    if t.device.type == "cpu":
        return False
    if t.is_cuda and t.dtype == torch.float32:
        return True
    if t.is_cuda and t.dtype == torch.float64:
        return False
    raise TypeError(f"{name}: the CUDA kernel takes float32 and the plain "
                    f"version float64 on the card; got {t.dtype} on "
                    f"{t.device}")


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


def stream_ptr(device: torch.device = None) -> int:
    """The current CUDA stream of ``device`` (default: the current device)
    as an int, read without building a Stream object."""
    index = torch.cuda.current_device() if device is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
