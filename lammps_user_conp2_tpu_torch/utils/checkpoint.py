"""Checkpoint and resume.

The reference has no restart integration (SURVEY.md section 5), only the
A-matrix files and rerun from a dump.  A checkpoint here holds what a run
needs to go on bit for bit: every ``MDState`` tensor in its own dtype (the
device step counter ``step_t`` and the fix scalar ``scalar_out``, which
the CG warm start, ``nevery`` and callable targets read, included), the
solver's context (``models.conp.CTX_TENSORS``), the atoms' tags, and a
digest of the set-up that includes the tag order.  The Verlet list and the
mesh-tile assignment are derived state: the file keeps the positions they
were built at, and ``load_checkpoint`` rebuilds them from those, so the
resumed run meets the same lists and rebuilds as the uninterrupted one.
Plain ``.npz``.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..models.conp import CTX_TENSORS
from ..models.system import MDState


def config_digest(engine) -> str:
    """sha256 of the set-up a checkpoint fits: atom count, box, dt, cutoff,
    mode, g_ewald and the tag order."""
    conp = engine.conp
    payload = {
        "natoms": engine.system.natoms,
        "box": list(engine.system.box),
        "dt": engine.md.dt,
        "cutoff": engine.md.cutoff,
        "mode": conp.cfg.mode.value if conp is not None else None,
        "g_ewald": engine.ksp_force.g_ewald,
        "tags": hashlib.sha256(np.ascontiguousarray(
            engine.system.tag, dtype=np.int64).tobytes()).hexdigest(),
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()
                          ).hexdigest()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, engine, state: MDState) -> None:
    """Write ``state`` and the engine's solver context to ``path`` (.npz)."""
    arrays = {"tags": np.asarray(engine.system.tag, np.int64),
              "step": np.asarray(state.step, np.int64)}
    for k in ("x", "v", "q", "f", "nhc_xi", "nhc_vxi", "scalar_out",
              "energy", "step_t"):
        arrays[f"state_{k}"] = _np(getattr(state, k))
    # the list and the tiles are built together (``Engine.derived_state``)
    built = state.nbr if state.nbr is not None else state.tasg
    if built is not None:
        arrays["derived_x_ref"] = _np(built.x_ref)
    if state.nbr is not None:
        arrays["nbr_overflow"] = _np(state.nbr.overflow)
    if engine.conp is not None:
        for k in CTX_TENSORS:
            arrays[f"ctx_{k}"] = _np(getattr(engine.conp, k))
    arrays["digest"] = np.frombuffer(config_digest(engine).encode(),
                                     dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, engine) -> MDState:
    """The state saved at ``path`` on the engine's device; raises
    ValueError when the file was written by another set-up (its digest,
    its tags or its A^-1 differ).  The solver context is copied into the
    engine's buffers in place (a captured graph keeps reading them)."""
    z = np.load(path)
    if not np.array_equal(z["tags"], np.asarray(engine.system.tag)):
        raise ValueError("checkpoint tags differ from the system's (another "
                         "atom order or another system)")
    digest = bytes(z["digest"]).decode()
    if digest != config_digest(engine):
        raise ValueError("checkpoint was written by an incompatible set-up "
                         f"(digest {digest[:12]} != current)")
    dev = engine.type_idx.device
    if engine.conp is not None:
        saved = z["ctx_ainv"]
        cur = _np(engine.conp.ainv)
        if saved.shape != cur.shape or not np.allclose(saved, cur, atol=1e-10):
            raise ValueError("checkpoint A^-1 differs from the current set-up")
        for k in CTX_TENSORS:
            buf = getattr(engine.conp, k)
            a = z[f"ctx_{k}"]
            if tuple(a.shape) != tuple(buf.shape):
                raise ValueError(f"checkpoint context {k} has shape "
                                 f"{a.shape}, the set-up {tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(a))
    kw = {k: torch.from_numpy(z[f"state_{k}"]).to(dev)
          for k in ("x", "v", "q", "f", "nhc_xi", "nhc_vxi", "scalar_out",
                    "energy", "step_t")}
    state = MDState(step=int(z["step"]), **kw)
    if "derived_x_ref" in z.files:
        # the list and the tiles as they were built, from the positions of
        # their last build, with the list's sticky overflow flag
        state.nbr, state.tasg = engine.derived_state(
            torch.from_numpy(z["derived_x_ref"]).to(dev))
        if state.nbr is not None and "nbr_overflow" in z.files:
            state.nbr.overflow = state.nbr.overflow | torch.from_numpy(
                z["nbr_overflow"]).to(dev)
    if (state.nbr is None) != (engine.ncfg is None):
        raise ValueError("checkpoint's Verlet list does not fit the engine")
    return state
