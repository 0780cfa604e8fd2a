"""SWAG: Stochastic Weight Averaging-Gaussian over a model's parameters.

Port of `deepsphere_weather_tpu/prob/swag.py` (reference
modules/swag.py:50-250). The posterior is flat fp32 vectors over every
parameter:

- `mean` and `sq_mean`, the running first and second moments
  (`collect_model`);
- `cov_cols`, a ring of `max_num_models` deviation columns (w - mean at
  each collection), with its head and count;
- `sample` draws w = mean + sqrt(scale) (sqrt(var) z1 + D z2 /
  sqrt(K - 1)) (the reference's `sample_fullrank`), or its blockwise form
  (`block=True`: scale multiplies the terms directly).

The flat order is the JAX params tree's leaf order (its keys sorted at
every level), not `named_parameters()` order, so that `model_swag.npz`
(the same keys: mean, sq_mean, cov_cols, scalars) written by either
package loads in the other.

Randomness: `sample` draws z1 [n] and then z2 [max_num_models] from an
explicit `torch.Generator`; `sample_from` is the formula alone, to which
the tests feed the JAX package's own draws (`jax.random` draws cannot be
reproduced in torch).

For BatchNorm models every sampled parameter set needs its running
statistics re-estimated (`prob.bn.bn_update`) before eval-mode
prediction; `prob.predictions.AutoregressiveSWAGPredictions` does it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["SWAGState", "SWAG", "jax_leaf_order"]

_VAR_CLAMP = 1e-30


def jax_leaf_order(names) -> List[str]:
    """Dotted parameter names in the JAX tree's leaf order (dict keys
    sorted at every level)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _params_of(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return {k: v.detach() for k, v in params.named_parameters()}
    return params


@dataclasses.dataclass
class SWAGState:
    mean: torch.Tensor         # [n] flattened
    sq_mean: torch.Tensor      # [n]
    cov_cols: torch.Tensor     # [max_num_models, n] deviation columns (ring)
    n_models: int
    n_cols: int                # number of valid columns
    col_head: int              # ring write position


class SWAG:
    """SWAG posterior over the parameters of `params_template` (a module or
    {name: tensor}), kept on their device."""

    def __init__(self, params_template, no_cov_mat: bool = False,
                 max_num_models: int = 40, var_clamp: float = _VAR_CLAMP):
        template = _params_of(params_template)
        self._names = jax_leaf_order(template)
        self._shapes: List[Tuple[int, ...]] = [tuple(template[k].shape)
                                               for k in self._names]
        n = sum(int(np.prod(s)) for s in self._shapes)
        device = template[self._names[0]].device
        self.no_cov_mat = no_cov_mat
        self.max_num_models = int(max_num_models)
        self.var_clamp = var_clamp
        k = 1 if no_cov_mat else self.max_num_models
        z = torch.zeros(n, dtype=torch.float32, device=device)
        self.state = SWAGState(mean=z, sq_mean=z.clone(),
                               cov_cols=torch.zeros((k, n), device=device),
                               n_models=0, n_cols=0, col_head=0)

    def _flatten(self, params) -> torch.Tensor:
        params = _params_of(params)
        return torch.cat([params[k].detach().reshape(-1).float().to(
            self.state.mean.device) for k in self._names])

    def _unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, k = {}, 0
        for name, shape in zip(self._names, self._shapes):
            n = int(np.prod(shape))
            out[name] = flat[k: k + n].reshape(shape)
            k += n
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect_model(self, params) -> SWAGState:
        """Update the running moments with a parameter snapshot (a module
        or {name: tensor})."""
        w = self._flatten(params)
        s = self.state
        n = s.n_models
        mean = s.mean * (n / (n + 1.0)) + w / (n + 1.0)
        sq_mean = s.sq_mean * (n / (n + 1.0)) + (w ** 2) / (n + 1.0)
        cov_cols, n_cols, head = s.cov_cols, s.n_cols, s.col_head
        if not self.no_cov_mat:
            cov_cols = cov_cols.clone()
            cov_cols[head] = w - mean
            head = (head + 1) % self.max_num_models
            n_cols = min(n_cols + 1, self.max_num_models)
        self.state = SWAGState(mean=mean, sq_mean=sq_mean, cov_cols=cov_cols,
                               n_models=n + 1, n_cols=n_cols, col_head=head)
        return self.state

    # ------------------------------------------------------------------
    def variance(self) -> torch.Tensor:
        s = self.state
        return torch.clamp(s.sq_mean - s.mean ** 2, min=self.var_clamp)

    @torch.no_grad()
    def sample_from(self, z1: torch.Tensor, z2: Optional[torch.Tensor],
                    scale: float = 1.0, cov: bool = True,
                    block: bool = False) -> Dict[str, torch.Tensor]:
        """The sampling formula for given standard normal draws: z1 [n]
        and, with `cov`, z2 [max_num_models]."""
        if cov and self.no_cov_mat:
            raise RuntimeError("covariance columns were not collected "
                               "(no_cov_mat=True)")
        s = self.state
        dev = s.mean.device
        z1 = torch.as_tensor(z1, dtype=torch.float32, device=dev)
        cov_term = None
        if cov:
            z2 = torch.as_tensor(z2, dtype=torch.float32, device=dev)
            mask = (torch.arange(self.max_num_models, device=dev)
                    < s.n_cols).float()
            cov_term = (s.cov_cols * mask[:, None] * z2[:, None]).sum(0)
        std = torch.sqrt(self.variance())
        if block:
            # the reference's sample_blockwise (swag.py:83-109): scale
            # multiplies the terms directly (no sqrt)
            w = s.mean + scale * std * z1
            if cov:
                w = w + (scale / math.sqrt(self.max_num_models - 1)
                         ) * cov_term
            return self._unflatten(w)
        # the reference's sample_fullrank (swag.py:111-161)
        rand = std * z1
        if cov:
            rand = rand + cov_term / math.sqrt(self.max_num_models - 1)
        return self._unflatten(s.mean + math.sqrt(scale) * rand)

    def sample(self, generator: Optional[torch.Generator] = None,
               scale: float = 1.0, cov: bool = True,
               block: bool = False) -> Dict[str, torch.Tensor]:
        """Draw a parameter sample ({name: tensor}): z1, then z2 with
        `cov`, from `generator` (on the posterior's device)."""
        if cov and self.no_cov_mat:
            raise RuntimeError("covariance columns were not collected "
                               "(no_cov_mat=True)")
        dev = self.state.mean.device
        z1 = torch.randn(self.state.mean.shape, generator=generator,
                         device=dev)
        z2 = (torch.randn((self.max_num_models,), generator=generator,
                          device=dev) if cov else None)
        return self.sample_from(z1, z2, scale=scale, cov=cov, block=block)

    def sample_members(self, generator: Optional[torch.Generator],
                       n_members: int, scale: float = 1.0,
                       cov: bool = True) -> Dict[str, torch.Tensor]:
        """Member-stacked samples {name: [M, ...]}, drawn in turn."""
        from ..weights import stack_states

        return stack_states([self.sample(generator, scale=scale, cov=cov)
                             for _ in range(n_members)])

    # ------------------------------------------------------------------
    @property
    def mean_params(self) -> Dict[str, torch.Tensor]:
        return self._unflatten(self.state.mean)

    def export_numpy_params(self, export_cov_mat: bool = False):
        """(mean, var[, cov columns]) as numpy (reference swag.py:207-236)."""
        s = self.state
        mean = s.mean.cpu().numpy()
        var = self.variance().cpu().numpy()
        if export_cov_mat:
            return mean, var, s.cov_cols[: s.n_cols].cpu().numpy()
        return mean, var

    # ------------------------------------------------------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        s = self.state
        return {"mean": s.mean.cpu().numpy(),
                "sq_mean": s.sq_mean.cpu().numpy(),
                "cov_cols": s.cov_cols.cpu().numpy(),
                "scalars": np.asarray([s.n_models, s.n_cols, s.col_head])}

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]):
        n_models, n_cols, head = (int(x) for x in arrays["scalars"])
        cov = np.asarray(arrays["cov_cols"])
        # a buffer of another row count than this instance's: sampling
        # reads rows [0, max_num_models), so reconcile it here or refuse
        rows = 1 if self.no_cov_mat else self.max_num_models
        if cov.shape[0] != rows:
            if n_cols > min(cov.shape[0], rows):
                raise ValueError(
                    f"SWAG checkpoint has {n_cols} covariance columns in a "
                    f"{cov.shape[0]}-row buffer but this instance holds "
                    f"{rows} (max_num_models={self.max_num_models}, "
                    f"no_cov_mat={self.no_cov_mat}); rebuild the SWAG "
                    f"wrapper with the checkpoint's settings")
            resized = np.zeros((rows, cov.shape[1]), dtype=cov.dtype)
            keep = min(rows, cov.shape[0])
            resized[:keep] = cov[:keep]
            cov, head = resized, n_cols % rows
        dev = self.state.mean.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.state = SWAGState(mean=t(arrays["mean"]),
                               sq_mean=t(arrays["sq_mean"]),
                               cov_cols=t(cov), n_models=n_models,
                               n_cols=n_cols, col_head=head)

    def save(self, path):
        np.savez_compressed(path, **self.state_arrays())

    def load(self, path):
        with np.load(path) as z:
            self.load_state_arrays({k: z[k] for k in z.files})
