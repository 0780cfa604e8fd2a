"""Checkpoints, runtime settings and timing."""

from .checkpoint import Checkpointer  # noqa: F401
from .runtime import set_deterministic_training  # noqa: F401
from .timing import Timer, device_sync  # noqa: F401
