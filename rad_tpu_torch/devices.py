"""Where the port's entry points run when the caller names no device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA device when none is given.

    With no device given and no CUDA device visible this raises: the port
    runs on the card unless the caller asks for the CPU, where the kernels'
    plain twins run, with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda:0")
    raise RuntimeError("no CUDA device visible and no device given: pass "
                       "device=\"cpu\" to run on the CPU with the kernels' "
                       "plain torch twins")
