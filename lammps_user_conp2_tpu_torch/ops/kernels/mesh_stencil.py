"""The dense PPPM mesh's stencil spread and readout: the CUDA kernels of
``csrc/mesh_stencil.cu``.

``ops/pppm.py`` routes its dense-path functions here for CUDA float32
tensors (``build.kernel_route``): ``spread`` (and so ``spread_rhok``) and
``spread_zplanes`` to ``spread``; ``gather``, ``gather3``,
``gather_zplanes`` and ``gather3_ad`` to ``gather``.  CPU tensors and CUDA
float64 tensors keep the dense weight-matrix versions of ``ops/pppm.py``
(``_spread_dense`` and the rest), which are the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

spread_launches = build.LaunchCounter("mesh_spread")
gather_launches = build.LaunchCounter("mesh_gather")

ORDERS = range(2, 8)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _geom(grid, nzo):
    return ((grid.order, grid.nx, grid.ny, grid.nz, nzo)
            + tuple(float(v) for v in grid.box_lo)
            + (grid.nx / grid.box[0], grid.ny / grid.box[1],
               grid.nz / grid.zprd_grid))


def _tables(grid, zp_inv, device):
    """(cf, zinv, znode): the coefficients and, on the planes, the slot map
    and the planes' z nodes as device int32 constants of the grid (built
    at the first call, before any graph capture)."""
    from ..pppm import _coeffs, _devconst
    cf = _coeffs(grid, torch.float32, device)
    if zp_inv is None:
        return cf, None, None
    key = np.asarray(zp_inv).tobytes()
    zinv = _devconst(grid, ("zp_slot_i32", key), lambda: zp_inv,
                     torch.int32, device)
    znode = _devconst(grid, ("zp_node_i32", key),
                      lambda: np.flatnonzero(np.asarray(zp_inv) >= 0),
                      torch.int32, device)
    return cf, zinv, znode


def _ptr(t):
    return None if t is None else t.data_ptr()


def spread(grid, x, q, zp_inv=None):
    """The stencil spread on the card: (nx, ny, nz), or (nx, ny, P) on the
    planes of ``zp_inv``; x (N, 3), q (N,) CUDA float32.  ``ops/pppm.py``
    calls it where ``kernel_route`` says the kernel."""
    x, q = x.contiguous(), q.contiguous()
    build.check_cuda("mesh_spread", torch.float32, x, q)
    if grid.order not in ORDERS:
        raise ValueError(f"mesh_spread: order {grid.order} not in 2..7")
    cf, zinv, znode = _tables(grid, zp_inv, x.device)
    nzo = grid.nz if znode is None else znode.shape[0]
    out = torch.empty((grid.nx, grid.ny, nzo), dtype=torch.float32,
                      device=x.device)
    status = build.load_library().conp2_stencil_spread_f32(
        x.data_ptr(), q.data_ptr(), cf.data_ptr(), _ptr(zinv), _ptr(znode),
        x.shape[0], *_geom(grid, nzo), out.data_ptr(), build.stream_ptr())
    build.check_status("mesh_spread", status)
    spread_launches.count += 1
    return out


def gather(grid, fields, x, *, scale=None, zp_inv=None, ad=False):
    """The stencil readout on the card: (N, len(fields)) of 1 to 3 fields,
    or with ``ad`` (N, 3), the gradient of the one field times delinv;
    times ``scale`` where given: a number (b's sign) or (N,), one per row
    (the charges).  Fields (nx, ny, nz), or (nx, ny, P) read through
    ``zp_inv``, CUDA float32, read through their strides (alike for all
    fields, else copied)."""
    x = x.contiguous()
    if any(f.stride() != fields[0].stride() for f in fields):
        fields = [f.contiguous() for f in fields]
    build.check_cuda("mesh_gather", torch.float32, x)
    if not all(f.is_cuda and f.dtype == torch.float32 for f in fields):
        raise TypeError("mesh_gather: the fields must be CUDA float32")
    per_row = isinstance(scale, torch.Tensor)
    if per_row:
        scale = scale.contiguous()
        build.check_cuda("mesh_gather", torch.float32, scale)
    sign = 1.0 if scale is None or per_row else float(scale)
    if grid.order not in ORDERS:
        raise ValueError(f"mesh_gather: order {grid.order} not in 2..7")
    if not 1 <= len(fields) <= 3 or (ad and len(fields) != 1):
        raise ValueError("mesh_gather: 1 to 3 fields, or 1 with ad")
    cf, zinv, _ = _tables(grid, zp_inv, x.device)
    nzo = fields[0].shape[2]
    if any(f.shape != (grid.nx, grid.ny, nzo) for f in fields):
        raise ValueError("mesh_gather: fields must be (nx, ny, nz or P)")
    n = x.shape[0]
    out = torch.empty((n, 3 if ad else len(fields)), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    ptrs = [f.data_ptr() for f in fields] + [None] * (3 - len(fields))
    delinv = (grid.nx / grid.box[0], grid.ny / grid.box[1],
              grid.nz / grid.zprd_grid)      # rounded to float32 by ctypes
    status = build.load_library().conp2_stencil_readout_f32(
        *ptrs, len(fields), int(ad), *fields[0].stride(), x.data_ptr(),
        scale.data_ptr() if per_row else None, sign, cf.data_ptr(),
        _ptr(zinv), n, *_geom(grid, nzo), *delinv, out.data_ptr(),
        build.stream_ptr())
    build.check_status("mesh_gather", status)
    gather_launches.count += 1
    return out
