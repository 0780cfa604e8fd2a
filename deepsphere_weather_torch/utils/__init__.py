"""Checkpoints, runtime settings, timing, profiling and model summaries."""

from .checkpoint import Checkpointer  # noqa: F401
from .runtime import set_deterministic_training  # noqa: F401
from .timing import Timer, device_sync  # noqa: F401
from .profiling import (  # noqa: F401
    profile_model,
    profile_step,
    scalability_sweep,
    summarize_model,
)
