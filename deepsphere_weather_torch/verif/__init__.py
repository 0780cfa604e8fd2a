"""Verification: deterministic and probabilistic skills, their summaries,
the benchmark forecasts and external baseline skills."""

from .deterministic import (  # noqa: F401
    SkillDataset,
    categorical_metrics,
    deterministic,
    deterministic_metrics,
    global_summary,
    latitudinal_summary,
    longitudinal_summary,
)
from .benchmarks import climatology_skills, persistence_skills  # noqa: F401
from .probabilistic import (  # noqa: F401
    crps_ensemble,
    ensemble_spread_skill,
    probabilistic,
    rank_histogram,
)
from .external import load_external_skill  # noqa: F401
