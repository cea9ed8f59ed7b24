"""The device and dtype the port's entry points run on by default.

The entry points (``setup_conp``, ``build_engine``, ``build_constraints``,
``make_nhc_params``, ``interop.context_from_numpy`` and
``interop.state_from_numpy``) run on the card unless
the caller asks for the CPU with ``device="cpu"``; with no CUDA device
visible they raise instead of running on the CPU.  Their default dtype is
float32, the dtype the hand kernels take.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    RuntimeError when no CUDA device is visible."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: the port runs on the card by "
                "default; pass device='cpu' (and dtype=torch.float64 for "
                "the reference precision) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
