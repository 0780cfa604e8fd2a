"""Device selection and the allocator setting shared by the port's entry
points."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "ask_expandable_segments"]

# the allocator's environment variables, in the order PyTorch reads them
_ALLOC_CONF = ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA is an error.

    The entry points default to "cuda" and never fall back to the CPU:
    callers that want the CPU (the tests) ask for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def ask_expandable_segments() -> bool:
    """Give the CUDA caching allocator expandable segments from here on,
    unless the user chose: an `expandable_segments` entry in
    PYTORCH_ALLOC_CONF or PYTORCH_CUDA_ALLOC_CONF stands as given, and so
    does a `backend` entry (cudaMallocAsync keeps no segments). The
    variable's other entries are kept. Returns whether this call asked.

    The entry points call it before their first CUDA allocation (the CLIs'
    `main`, the experiment drivers that do not go through it, the ranks
    `cli.launch` spawns). With the default segments a large member stack
    fragments the card: the 7-member step of the shipped Healpix_100km
    MaxPool knn configuration (fp32 HEALPix-64, batch 16, AR6, remat)
    failed on an NVIDIA H100 80GB to allocate 7.88 GiB with about 16 GiB
    reserved but unallocated, in blocks of at most 5.25 GiB, though its
    own peak is 71.2 GiB (PERF.md). Expandable segments map freed pages
    into one growing range, so a block is found wherever the free pages
    lie. They cost nothing in a warm step; a step right after
    torch.cuda.empty_cache() maps its pages again."""
    confs = [os.environ.get(name, "") for name in _ALLOC_CONF]
    keys = {item.partition(":")[0].strip()
            for conf in confs for item in conf.split(",")}
    if "expandable_segments" in keys or "backend" in keys:
        return False
    # the variable PyTorch reads, with the setting added, so that every
    # option the user gave stays in force however the allocator parses it
    conf = next((c for c in confs if c.strip()), "")
    setting = ",".join(c for c in (conf.strip(" ,"),
                                   "expandable_segments:True") if c)
    apply = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    if apply is None:
        apply = torch.cuda.memory._set_allocator_settings
    apply(setting)
    return True
