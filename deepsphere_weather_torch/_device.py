"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA is an error.

    The entry points default to "cuda" and never fall back to the CPU:
    callers that want the CPU (the tests) ask for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device
