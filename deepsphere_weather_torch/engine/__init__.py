"""Autoregressive execution: the loss, the training steps, the AR
scheduler and the prediction rollout."""

from .loss import AreaWeights, weighted_mse  # noqa: F401
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
