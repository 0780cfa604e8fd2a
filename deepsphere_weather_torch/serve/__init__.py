"""Serving: the packaged block rollout and the forecast service."""

from .export import TorchRollout, export_rollout  # noqa: F401
from .service import ForecastService  # noqa: F401
