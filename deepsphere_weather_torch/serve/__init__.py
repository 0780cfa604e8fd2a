"""Serving: the exported block rollout, its artifacts on disk and the
forecast service."""

from .export import (  # noqa: F401
    ExportedRollout,
    export_ensemble_rollout,
    export_rollout,
    load_artifact,
    save_artifact,
)
from .service import ForecastService  # noqa: F401
