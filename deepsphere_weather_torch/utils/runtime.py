"""Runtime settings shared by the CLI drivers.

Port of `deepsphere_weather_tpu/utils/runtime.py`. The reference
centralizes torch runtime knobs in ``set_pytorch_settings``
(reference: modules/utils_config.py:432-473); here
`set_deterministic_training` seeds the host and torch generators and puts
torch in deterministic mode. The JAX package's other function,
`enable_compilation_cache` (XLA's persistent cache), has no counterpart:
the port's compiled code is its CUDA kernels, which `kernels/build.py`
builds once per source hash and keeps.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["set_deterministic_training"]

# the cuBLAS workspace setting under which torch allows deterministic mode
CUBLAS_WORKSPACE = ":4096:8"


def set_deterministic_training(enabled: bool, seed: int = 0) -> bool:
    """The reference's ``set_pytorch_deterministic``: seed ``random``,
    ``numpy`` and ``torch``, and call
    ``torch.use_deterministic_algorithms(True)``, so that an op without a
    deterministic implementation raises instead of varying run to run.
    cuBLAS is deterministic only with a fixed workspace, which
    ``CUBLAS_WORKSPACE_CONFIG`` sets: it is set here (unless the caller
    chose one) before the driver's CUDA work. The block-sparse kernels sum
    without atomics, so they are deterministic as they are.

    Returns ``enabled``; when False this is a no-op (the reference acts
    on the True branch only)."""
    if not enabled:
        return False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    random.seed(int(seed))
    np.random.seed(int(seed) % (2**32))
    torch.manual_seed(int(seed))
    torch.use_deterministic_algorithms(True)
    return True
