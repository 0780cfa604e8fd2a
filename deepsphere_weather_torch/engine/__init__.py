"""Autoregressive execution: the loss, the training steps, the AR
scheduler, the optimizer, the training driver and the predictions."""

from .loss import AreaWeights, weighted_mse  # noqa: F401
from .optim import Adam, clip_by_global_norm_, make_optimizer  # noqa: F401
from .prediction import (  # noqa: F401
    AutoregressivePredictions,
    ForecastDataset,
    rechunk_forecasts_for_verification,
)
from .scheduler import ARScheduler, EarlyStopping  # noqa: F401
from .step import (  # noqa: F401
    assemble_input,
    keep_first_feedback,
    make_ar_loss_fn,
    make_cached_train_step,
    make_cached_validation_fn,
    make_rollout_block,
    make_train_step,
    make_validation_fn,
    reduce_gradients,
)
from .training import ARTrainingInfo, AutoregressiveTraining  # noqa: F401
