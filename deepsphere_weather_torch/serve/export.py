"""The block rollout packaged for serving.

Port of `export_rollout` from `deepsphere_weather_tpu/serve/export.py`:
`TorchRollout` holds the model with its parameters, the static features and
the same `meta` dict as the JAX artifact, and exposes

    call(hist)              when the model takes no BC features
    call(hist, bc_block)    otherwise

with hist [batch_size, H, V, F_dyn] (scaled units) and bc_block
[batch_size, block_size, n_input_k, V, F_bc]; it returns
(new_hist, preds [batch_size, block_size, n_out, V, F_dyn]) on the model's
device. It is built in-process; writing it to disk as an artifact is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.ar import ARIndexer
from ..engine.step import make_rollout_block

__all__ = ["TorchRollout", "export_rollout"]


@dataclasses.dataclass
class TorchRollout:
    model: torch.nn.Module
    static: Optional[torch.Tensor]
    meta: dict
    rollout_fn: Callable

    @property
    def has_bc(self) -> bool:
        return self.meta["n_bc_features"] > 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _shape_check(self, name, t, want):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}; got {tuple(t.shape)}")

    def call(self, hist, bc_block=None):
        m = self.meta
        dev = self.device
        hist = torch.as_tensor(hist, dtype=torch.float32, device=dev)
        self._shape_check("hist", hist, (m["batch_size"], m["history_size"],
                                         m["n_node"], m["n_dynamic_features"]))
        if self.has_bc:
            if bc_block is None:
                raise ValueError("this rollout requires a bc_block "
                                 f"[B, {m['block_size']}, {m['n_input_k']}, "
                                 f"V, {m['n_bc_features']}]")
            bc_block = torch.as_tensor(bc_block, dtype=torch.float32,
                                       device=dev)
            self._shape_check("bc_block", bc_block, (
                m["batch_size"], m["block_size"], m["n_input_k"],
                m["n_node"], m["n_bc_features"]))
        elif bc_block is not None:
            raise ValueError("this rollout takes no boundary conditions")
        h, _, preds = self.rollout_fn(hist, None, bc_block, self.static)
        return h, preds


def export_rollout(model, params=None, *, input_k: Sequence[int],
                   output_k: Sequence[int], forecast_cycle: int,
                   batch_size: int, block_size: int,
                   static: Optional[np.ndarray] = None,
                   n_bc_features: int = 0,
                   timestep_hours: Optional[float] = None,
                   feature_order: Optional[Sequence[str]] = None) -> TorchRollout:
    """Package the block rollout of `model`, with `params` (a port state
    dict, see `weights.params_from_jax`) loaded when given.

    `static` are the prepared static features [V, F_static] as fed in
    training. Rollouts use stack_most_recent_prediction=True (no keep-first
    mask), as the JAX export does."""
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    indexer = ARIndexer.build(list(input_k), list(output_k), forecast_cycle, 1)
    rollout, H = make_rollout_block(model, indexer, block_size)
    device = next(model.parameters()).device
    static_t = (None if static is None else
                torch.as_tensor(np.asarray(static, np.float32), device=device))
    meta = {
        "format_version": 1,
        "torch_version": torch.__version__,
        "platforms": [device.type],
        "batch_size": batch_size,
        "block_size": block_size,
        "history_size": H,
        "n_node": model.input_n_node,
        "n_dynamic_features": model.output_n_feature,
        "n_bc_features": n_bc_features,
        "n_static_features": 0 if static_t is None else int(static_t.shape[-1]),
        "n_input_k": len(input_k),
        "input_k": [int(k) for k in input_k],
        "output_k": [int(k) for k in output_k],
        "forecast_cycle": int(forecast_cycle),
        "timestep_hours": timestep_hours,
        "feature_order": list(feature_order) if feature_order else None,
    }
    return TorchRollout(model=model, static=static_t, meta=meta,
                        rollout_fn=rollout)
