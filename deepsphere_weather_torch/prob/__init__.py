"""Probabilistic forecasting: SWAG, BatchNorm re-estimation and
member-parallel ensembles (port of `deepsphere_weather_tpu/prob`)."""

from .swag import SWAG, SWAGState  # noqa: F401
from .bn import bn_update, make_bn_stats_fn  # noqa: F401
from .predictions import (  # noqa: F401
    AutoregressiveSWAGPredictions,
    EnsembleForecastDataset,
    build_ensemble_store,
    ensemble_median,
)
from .ensemble_rollout import (  # noqa: F401
    ensemble_rollout_predictions,
    make_ensemble_rollout,
)
