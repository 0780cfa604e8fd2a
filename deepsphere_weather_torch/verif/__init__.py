"""Verification: deterministic skills and their summaries."""

from .deterministic import (  # noqa: F401
    SkillDataset,
    categorical_metrics,
    deterministic,
    deterministic_metrics,
    global_summary,
    latitudinal_summary,
    longitudinal_summary,
)
