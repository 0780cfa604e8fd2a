"""Checkpoints in the JAX package's layout: weights, Adam state, schedulers.

Port of `deepsphere_weather_tpu/utils/checkpoint.py`. Arrays are saved as
`.npz` keyed by `/`-joined tree paths and tagged `dsw_tpu_pytree_v1` in a
`__meta__` entry; the scheduler and early-stopping states as JSON. The
keys are the ones the JAX package writes, so a checkpoint written by
either package resumes in the other:

- `model_weights/model.npz`: the parameters, keyed by their JAX tree path
  (`conv1/convblock1/weight`: the state-dict key with `/` for `.`; the
  weight bridge of `weights.py`);
- `training_info/opt_state.npz`: optax's Adam state, which is torch's.
  optax `count` is torch's `step`, `mu` its `exp_avg` and `nu` its
  `exp_avg_sq`, each `mu`/`nu` keyed by the parameter's path. Where the
  Adam state sits in optax's pytree depends on the optimizer the JAX
  driver builds (`cli/train_predict.py` there): `optax.adam` alone puts
  it under `0/` (the state of `scale_by_adam` in adam's chain);
  `clip_by_global_norm` chained before it, under `1/0/`; and
  `inject_hyperparams` around either adds `.inner_state/` before that,
  with its own `.count` and `.hyperparams/learning_rate` at the top. The
  port's `engine.optim.Adam` carries the two switches
  (`gradient_clipping`, `inject_lr`); a plain `torch.optim.Adam` is
  `optax.adam` alone.
- `model_weights/norm_state.npz`: a BatchNorm model's running statistics
  (`conv1/convblock1/mean`, `.../var`: the buffers' names with `/`), the
  JAX `norm_state`; written only when the model has some.
- `training_info/state.json`: the AR scheduler and early-stopping state
  dicts.

A member stack (`models.MemberStack`) saves every array with its leading
[M] axis, as the JAX package saves its vmapped params, norm state and
optimizer state: optax's `count` (and an injected learning rate) is then
an [M] vector too.

No pickle: checkpoints are portable and inspectable.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["save_arrays", "load_arrays", "model_arrays", "load_model_arrays",
           "norm_state_arrays", "load_norm_state_arrays", "optimizer_arrays",
           "load_optimizer_arrays", "adam_prefix", "Checkpointer"]

FORMAT = "dsw_tpu_pytree_v1"


def save_arrays(path, arrays: Dict[str, np.ndarray],
                extra_meta: Optional[Dict] = None):
    """Save {tree path: array} to .npz with the `__meta__` format tag."""
    meta = {"format": FORMAT}
    if extra_meta:
        meta.update(extra_meta)
    out = dict(arrays)
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)


def load_arrays(path) -> Dict[str, np.ndarray]:
    """{tree path: array} of a saved .npz, without `__meta__`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _key(name: str) -> str:
    return name.replace(".", "/")


def model_arrays(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as fp32 numpy arrays keyed by JAX tree path."""
    return {_key(k): v.detach().to("cpu", torch.float32).numpy()
            for k, v in model.state_dict().items()}


def load_model_arrays(model: torch.nn.Module, arrays: Dict[str, np.ndarray]):
    """In place: the model's parameters from {tree path: array}; every
    parameter must be there (KeyError names the first missing key)."""
    state = {}
    for k, v in model.state_dict().items():
        if _key(k) not in arrays:
            raise KeyError(f"checkpoint missing key {_key(k)!r}")
        state[k] = torch.from_numpy(np.asarray(arrays[_key(k)], np.float32)
                                    ).reshape(v.shape)
    model.load_state_dict(state)
    return model


def norm_state_arrays(norm_state: Dict[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """Running statistics {buffer name: tensor} as fp32 numpy arrays keyed
    by JAX tree path."""
    return {_key(k): v.detach().to("cpu", torch.float32).numpy()
            for k, v in norm_state.items()}


@torch.no_grad()
def load_norm_state_arrays(norm_state: Dict[str, torch.Tensor],
                           arrays: Dict[str, np.ndarray]):
    """In place: every tensor of `norm_state` (the model's buffers) from
    {tree path: array}; a single-model array broadcasts over a member
    axis. KeyError names the first missing key."""
    for k, v in norm_state.items():
        if _key(k) not in arrays:
            raise KeyError(f"checkpoint missing key {_key(k)!r}")
        v.copy_(torch.from_numpy(np.asarray(arrays[_key(k)], np.float32)
                                 ).to(v.device).expand_as(v))
    return norm_state


def adam_prefix(optimizer) -> str:
    """Tree path prefix of the Adam state in optax's pytree (module
    docstring)."""
    prefix = "1/0/" if getattr(optimizer, "gradient_clipping", 0.0) > 0 \
        else "0/"
    return (".inner_state/" + prefix) if getattr(optimizer, "inject_lr",
                                                 False) else prefix


def optimizer_arrays(optimizer, model: torch.nn.Module
                     ) -> Dict[str, np.ndarray]:
    """The Adam state of `optimizer` over `model`'s parameters in optax's
    layout (zero moments and count 0 before the first step)."""
    prefix = adam_prefix(optimizer)
    out = {}
    counts = set()
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if st:
            counts.add(int(st["step"]))
            mu, nu = st["exp_avg"], st["exp_avg_sq"]
        else:
            counts.add(0)
            mu = nu = torch.zeros_like(p)
        out[f"{prefix}.mu/{_key(name)}"] = mu.detach().to(
            "cpu", torch.float32).numpy()
        out[f"{prefix}.nu/{_key(name)}"] = nu.detach().to(
            "cpu", torch.float32).numpy()
    if len(counts) != 1:
        raise ValueError(f"parameters at different Adam steps {counts}")
    # a member stack's optax state is vmapped: one count (and lr) a member
    members = getattr(model, "n_members", None)
    shape = () if members is None else (members,)
    count = np.full(shape, counts.pop(), np.int32)
    out[f"{prefix}.count"] = count
    if getattr(optimizer, "inject_lr", False):
        out[".count"] = count
        out[".hyperparams/learning_rate"] = np.full(
            shape, optimizer.param_groups[0]["lr"], np.float32)
    return out


def load_optimizer_arrays(optimizer, model: torch.nn.Module,
                          arrays: Dict[str, np.ndarray]):
    """In place: `optimizer`'s Adam state from optax's layout; with
    `inject_lr`, also its learning rate (the injected hyperparameter)."""
    prefix = adam_prefix(optimizer)

    def get(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing key {key!r}")
        return arrays[key]

    step = float(np.asarray(get(f"{prefix}.count")).reshape(-1)[0])
    for name, p in model.named_parameters():
        moments = [torch.from_numpy(np.asarray(
            get(f"{prefix}.{m}/{_key(name)}"), np.float32)).reshape(
                p.shape).to(p.device) for m in ("mu", "nu")]
        optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                              "exp_avg": moments[0],
                              "exp_avg_sq": moments[1]}
    if getattr(optimizer, "inject_lr", False):
        lr = float(np.asarray(get(".hyperparams/learning_rate")
                              ).reshape(-1)[0])
        for group in optimizer.param_groups:
            group["lr"] = lr
    return optimizer


class Checkpointer:
    """Experiment checkpoint directory manager.

    Layout (the JAX package's, after the reference experiment contract):
      <exp_dir>/model_weights/model.npz          final/best weights
      <exp_dir>/model_weights/norm_state.npz     BatchNorm running stats
      <exp_dir>/model_weights/model_epoch_N.npz  per-epoch (optional)
      <exp_dir>/training_info/state.json         scheduler + early stopping
      <exp_dir>/training_info/opt_state.npz      optimizer state
    """

    def __init__(self, exp_dir):
        self.exp_dir = Path(exp_dir)
        (self.exp_dir / "model_weights").mkdir(parents=True, exist_ok=True)
        (self.exp_dir / "training_info").mkdir(parents=True, exist_ok=True)

    def save_model(self, model, name: str = "model.npz"):
        save_arrays(self.exp_dir / "model_weights" / name, model_arrays(model))

    def load_model(self, model, name: str = "model.npz"):
        """In place: `model`'s parameters from the checkpoint."""
        return load_model_arrays(
            model, load_arrays(self.exp_dir / "model_weights" / name))

    def save_training_state(self, optimizer, model, scheduler_state: Dict,
                            early_stopping_state: Dict,
                            extra: Optional[Dict] = None):
        save_arrays(self.exp_dir / "training_info" / "opt_state.npz",
                    optimizer_arrays(optimizer, model))
        state = {"ar_scheduler": scheduler_state,
                 "early_stopping": early_stopping_state}
        if extra:
            state.update(extra)
        (self.exp_dir / "training_info" / "state.json").write_text(
            json.dumps(state, indent=1, default=float))

    def load_training_state(self, optimizer, model) -> Dict:
        """In place: `optimizer`'s state; returns the state.json dict."""
        load_optimizer_arrays(optimizer, model, load_arrays(
            self.exp_dir / "training_info" / "opt_state.npz"))
        return json.loads(
            (self.exp_dir / "training_info" / "state.json").read_text())

    def save_norm_state(self, norm_state: Dict[str, torch.Tensor],
                        name: str = "norm_state.npz"):
        """BatchNorm running statistics (nothing saved when empty)."""
        if norm_state:
            save_arrays(self.exp_dir / "model_weights" / name,
                        norm_state_arrays(norm_state))

    def load_norm_state(self, norm_state: Dict[str, torch.Tensor],
                        name: str = "norm_state.npz"):
        """In place: `norm_state` (the model's buffers) from the saved
        statistics; returns it, or None when the file is absent."""
        path = self.exp_dir / "model_weights" / name
        if not path.exists():
            return None
        return load_norm_state_arrays(norm_state, load_arrays(path))

    def has_checkpoint(self, name: str = "model.npz") -> bool:
        return (self.exp_dir / "model_weights" / name).exists()

    def load_scheduler_state(self):
        """The saved AR-scheduler state dict, or None if absent."""
        path = self.exp_dir / "training_info" / "state.json"
        if not path.exists():
            return None
        return json.loads(path.read_text()).get("ar_scheduler")
