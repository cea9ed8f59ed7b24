"""Build the port's objects from plain numpy arrays.

The inputs are what ``np.asarray`` gives for each field of the JAX
package's objects (``System``, ``ConpContext``, ``MDState``), so a test can
hand both packages the same setup or the same state and hold the per-step
path apart from the setup.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.electrodes import ConpContext
from .models.system import MDState, System


def system_from_numpy(fields: dict) -> System:
    """System from a mapping of its field names to values (numpy arrays,
    plus ``units_name``, the ``periodic`` tuple and the ``groups`` dict)."""
    names = [f.name for f in dataclasses.fields(System)]
    kw = {}
    for name in names:
        val = fields[name]
        if name == "groups":
            val = {k: np.asarray(v) for k, v in val.items()}
        elif name == "periodic":
            val = tuple(bool(p) for p in val)
        elif name != "units_name":
            val = np.asarray(val)
        kw[name] = val
    return System(**kw)


def context_from_numpy(fields: dict, *, device=None,
                       dtype=torch.float64) -> ConpContext:
    """ConpContext of the INV solve from the JAX context's fields (ainv, d,
    elesetq, totsetq, eleinitq, elecheck_ele, ele_idx; others ignored)."""
    f = lambda k: torch.tensor(np.asarray(fields[k]), dtype=dtype,
                               device=device)
    return ConpContext(
        ainv=f("ainv"), d=f("d"), elesetq=f("elesetq"),
        totsetq=f("totsetq"), eleinitq=f("eleinitq"),
        elecheck_ele=torch.tensor(np.asarray(fields["elecheck_ele"]),
                                  device=device),
        ele_idx=torch.tensor(np.asarray(fields["ele_idx"]),
                             dtype=torch.int64, device=device))


def state_from_numpy(fields: dict, *, device=None,
                     dtype=torch.float64) -> MDState:
    """MDState from the JAX state's fields (x, v, q, f, step, nhc_xi,
    nhc_vxi, scalar_out, energy; others ignored)."""
    f = lambda k: torch.tensor(np.asarray(fields[k]), dtype=dtype,
                               device=device)
    return MDState(x=f("x"), v=f("v"), q=f("q"), f=f("f"),
                   step=int(np.asarray(fields["step"])), nhc_xi=f("nhc_xi"),
                   nhc_vxi=f("nhc_vxi"), scalar_out=f("scalar_out"),
                   energy=f("energy"))
