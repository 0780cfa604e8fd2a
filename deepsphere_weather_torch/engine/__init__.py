"""Autoregressive execution: the prediction rollout."""

from .step import keep_first_feedback, make_rollout_block  # noqa: F401
