"""Build the port's objects from plain numpy arrays.

The inputs are what ``np.asarray`` gives for each field of the JAX
package's objects (``System``, ``ConpContext``, ``MDState``), so a test can
hand both packages the same setup or the same state and hold the per-step
path apart from the setup.  The context of a PPPM-mode solver carries over
like any other (A^-1, elesetq, ...); the derived state (Verlet list, mesh
tile assignment) is rebuilt from x by the port's engine.  Nothing here
imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.electrodes import ConpContext
from .models.system import MDState, System
from .utils.device import DEFAULT_DTYPE, resolve_device


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
                       dtype=DEFAULT_DTYPE) -> ConpContext:
    """ConpContext from the JAX context's fields (ainv, amat, real_block,
    diag_extra, d, elesetq, totsetq, eleinitq, elecheck_ele, ele_idx,
    setzvec, vmult; others ignored), on ``device`` (None: the card); A^-1
    in float64, the rest in ``dtype``."""
    device = resolve_device(device)
    f = lambda k: torch.tensor(np.asarray(fields[k]), dtype=dtype,
                               device=device)
    return ConpContext(
        ainv=torch.tensor(np.asarray(fields["ainv"]), dtype=torch.float64,
                          device=device), amat=f("amat"),
        real_block=f("real_block"), diag_extra=f("diag_extra"),
        d=f("d"), elesetq=f("elesetq"),
        totsetq=f("totsetq"), eleinitq=f("eleinitq"),
        elecheck_ele=torch.tensor(np.asarray(fields["elecheck_ele"]),
                                  device=device),
        ele_idx=torch.tensor(np.asarray(fields["ele_idx"]),
                             dtype=torch.int64, device=device),
        setzvec=f("setzvec"), vmult=f("vmult"))


def state_from_numpy(fields: dict, *, device=None, dtype=DEFAULT_DTYPE,
                     engine=None) -> MDState:
    """MDState from the JAX state's fields (x, v, q, f, step, nhc_xi,
    nhc_vxi, scalar_out, energy; others ignored), on ``device`` (None: the
    card); the step also as the device counter.  With ``engine``, its
    derived state (Verlet list, mesh tile assignment) is built at x."""
    device = resolve_device(device)
    f = lambda k: torch.tensor(np.asarray(fields[k]), dtype=dtype,
                               device=device)
    step = int(np.asarray(fields["step"]))
    st = MDState(x=f("x"), v=f("v"), q=f("q"), f=f("f"), step=step,
                 nhc_xi=f("nhc_xi"), nhc_vxi=f("nhc_vxi"),
                 scalar_out=f("scalar_out"), energy=f("energy"),
                 step_t=torch.tensor(step, dtype=torch.int64, device=device))
    if engine is not None:
        st.nbr, st.tasg = engine.derived_state(st.x)
    return st
