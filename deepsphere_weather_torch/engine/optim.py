"""The training driver's optimizer: Adam(lr, eps=1e-7) with optax's
global-norm clipping.

Port of the optimizer factory of `deepsphere_weather_tpu/cli/
train_predict.py` (`_make_optimizer`): `optax.adam(lr, eps=1e-7)`, with
`optax.clip_by_global_norm(gradient_clipping)` chained before it when
`gradient_clipping > 0`, and wrapped in `optax.inject_hyperparams` when a
learning-rate lever (`lr_decay_on_growth`, `lr_plateau_decay`) is on, so
that the training loop can set the learning rate. In torch the learning
rate is always settable (`param_groups[*]["lr"]`); `inject_lr` records
that the JAX driver would have injected it, which the checkpoint layout
(`utils/checkpoint.py`) and the divergence rescue (which needs a settable
rate in the JAX package) follow.

optax's rule, which torch's `clip_grad_norm_` does not follow (it scales
by max_norm / (norm + 1e-6) whenever the norm exceeds max_norm): with
the global norm n of all gradients, each gradient g is kept when
n < max_norm and becomes (g / n) * max_norm otherwise. The clip runs as a
step pre-hook, inside `optimizer.step()`: after the gradients were reduced
over a mesh (`engine.step.reduce_gradients`), so every rank clips the
same global gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["Adam", "clip_by_global_norm_", "make_optimizer"]

ADAM_EPS = 1e-7


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """In place, optax.clip_by_global_norm's rule over `grads` (module
    docstring); returns the global norm (fp32, on the gradients' device,
    no host synchronization)."""
    grads = [g for g in grads if g is not None]
    # optax.global_norm: the root of the sum of every leaf's squared sum
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class Adam(torch.optim.Adam):
    """torch.optim.Adam(lr, eps=1e-7) with optax's global-norm clipping
    when `gradient_clipping > 0`; `inject_lr` marks a learning rate the
    JAX driver would inject (module docstring)."""

    def __init__(self, params, lr: float, gradient_clipping: float = 0.0,
                 inject_lr: bool = False):
        super().__init__(params, lr=lr, eps=ADAM_EPS)
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.inject_lr = bool(inject_lr)
        if self.gradient_clipping > 0:
            self.register_step_pre_hook(self._clip)

    def _clip(self, optimizer, args, kwargs):
        clip_by_global_norm_([p.grad for group in self.param_groups
                              for p in group["params"]],
                             self.gradient_clipping)


def make_optimizer(params, training_settings: Dict) -> Adam:
    """The JAX driver's `_make_optimizer` from the config's
    training_settings: learning_rate, gradient_clipping, and the
    lr levers that make the JAX driver inject the learning rate."""
    inject = (float(training_settings.get("lr_decay_on_growth", 1.0)) != 1.0
              or float(training_settings.get("lr_plateau_decay", 0.0)
                       or 0.0) > 0)
    return Adam(params, lr=float(training_settings["learning_rate"]),
                gradient_clipping=float(
                    training_settings.get("gradient_clipping", 0.0) or 0.0),
                inject_lr=inject)
