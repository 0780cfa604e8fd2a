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
same global gradient. Over a member stack (`models.MemberStack`,
`member_axis=True`) each member is clipped by its own global norm, over
its slice of every stacked gradient, as the JAX package clips inside its
member vmap.

`swa_schedule` is the learning rate of `cli/finetune_swag`'s optimizer
(JAX `_swag_optimizer`): optax's `linear_schedule` from the base rate to
the SWA target over `swa_start` updates, then constant. optax evaluates a
schedule at the update count before the update, so the first update uses
the base rate; `Adam(lr_schedule=...)` sets each update's rate so, in
float32 as optax computes it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["Adam", "clip_by_global_norm_", "make_optimizer",
           "swa_schedule"]

ADAM_EPS = 1e-7


def clip_by_global_norm_(grads, max_norm: float,
                         member_axis: bool = False) -> torch.Tensor:
    """In place, optax.clip_by_global_norm's rule over `grads` (module
    docstring); returns the global norm (fp32, on the gradients' device,
    no host synchronization). With `member_axis`, every gradient is
    member-stacked [M, ...] and each member is clipped by its own norm
    ([M] returned)."""
    grads = [g for g in grads if g is not None]
    # optax.global_norm: the root of the sum of every leaf's squared sum
    if member_axis:
        norm = torch.stack([g.float().square().reshape(g.shape[0], -1).sum(1)
                            for g in grads]).sum(0).sqrt()
    else:
        norm = torch.stack([g.float().square().sum() for g in grads]
                           ).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        shape = (-1,) + (1,) * (g.dim() - 1) if member_axis else ()
        k, n = keep.reshape(shape), norm.reshape(shape).to(g.dtype)
        g.copy_(torch.where(k, g, (g / n) * max_norm))
    return norm


def swa_schedule(base_lr: float, target_lr: float,
                 swa_start: int) -> Callable[[int], float]:
    """count -> learning rate of the SWA recipe (module docstring):
    optax.linear_schedule(base_lr, target_lr, swa_start) in float32, or
    the constant target_lr when swa_start is 0."""
    if swa_start <= 0:
        return lambda count: float(np.float32(target_lr))
    scale = np.float32(base_lr - target_lr)
    end, steps = np.float32(target_lr), np.float32(swa_start)

    def schedule(count: int) -> float:
        c = np.float32(min(max(int(count), 0), swa_start))
        return float(scale * (np.float32(1) - c / steps) + end)

    return schedule


class Adam(torch.optim.Adam):
    """torch.optim.Adam(lr, eps=1e-7 unless given) with optax's
    global-norm clipping
    when `gradient_clipping > 0` (per member with `member_axis`);
    `inject_lr` marks a learning rate the JAX driver would inject;
    `lr_schedule` (count -> lr, `swa_schedule`) sets each update's rate
    from the number of updates before it (module docstring)."""

    def __init__(self, params, lr: float, gradient_clipping: float = 0.0,
                 inject_lr: bool = False, member_axis: bool = False,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 eps: float = ADAM_EPS):
        super().__init__(params, lr=lr, eps=eps)
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.inject_lr = bool(inject_lr)
        self.member_axis = bool(member_axis)
        self.lr_schedule = lr_schedule
        self.updates = 0
        if self.gradient_clipping > 0:
            self.register_step_pre_hook(self._clip)
        if lr_schedule is not None:
            self.register_step_pre_hook(self._schedule)
            self.register_step_post_hook(self._count)

    def _clip(self, optimizer, args, kwargs):
        clip_by_global_norm_([p.grad for group in self.param_groups
                              for p in group["params"]],
                             self.gradient_clipping, self.member_axis)

    def _schedule(self, optimizer, args, kwargs):
        for group in self.param_groups:
            group["lr"] = self.lr_schedule(self.updates)

    def _count(self, optimizer, args, kwargs):
        self.updates += 1


def make_optimizer(params, training_settings: Dict,
                   member_axis: bool = False) -> Adam:
    """The JAX driver's `_make_optimizer` from the config's
    training_settings: learning_rate, gradient_clipping, and the
    lr levers that make the JAX driver inject the learning rate;
    `member_axis` for the parameters of a `models.MemberStack`."""
    inject = (float(training_settings.get("lr_decay_on_growth", 1.0)) != 1.0
              or float(training_settings.get("lr_plateau_decay", 0.0)
                       or 0.0) > 0)
    return Adam(params, lr=float(training_settings["learning_rate"]),
                gradient_clipping=float(
                    training_settings.get("gradient_clipping", 0.0) or 0.0),
                inject_lr=inject, member_axis=member_axis)
