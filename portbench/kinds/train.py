"""Traffic kind "train": `make_cached_train_step` over a resident series
on the device (the configuration's `device_cache` path). Each step trains
`batch` windows drawn without repeat from a seeded shuffle of every valid
reference time, and only their [batch, W] time indices cross from the
host (`shard_window_indices`). The AR depth, strategy, remat, learning
rate and clipping are the configuration's; the AR loss weights are
`ar_absolute_weights`, normalised.

What is compared (`checks.train_numbers`): the set-up steps, which go
through the window's own step function, against the reference following
the same batches with plain autograd, optax's clipping and Adam.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import checks, workload
from portbench.reference.model import adam_train, ar_windows


class Workload(workload.Workload):
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, ref):
        super().__init__(cfg, traffic, seed, device, ref)
        from deepsphere_weather_torch.engine import (make_cached_train_step,
                                                     make_optimizer)

        self.optimizer = make_optimizer(self.model.parameters(), self.ts)
        self.step = make_cached_train_step(
            self.model, self.indexer, self.optimizer, self.ar_iterations + 1,
            self.ts["ar_training_strategy"],
            remat=bool(self.ts.get("remat", False)))
        w = np.asarray(traffic["ar_absolute_weights"], np.float32)
        self.ar_weights = w / w.sum()
        self.w_dev = torch.as_tensor(self.ar_weights, device=self.device)
        self.area_w = torch.full((self.nodes,), 1.0 / self.nodes,
                                 device=self.device)
        self.offsets, _, _ = ar_windows(
            self.ar["input_k"], self.ar["output_k"],
            self.ar["forecast_cycle"], self.ar_iterations)
        self.t0s = np.arange(-min(self.offsets),
                             self.series["steps"] - max(self.offsets))
        self.order: List[int] = []
        self.windows: List[np.ndarray] = []
        self.losses: List[torch.Tensor] = []
        self.per_unit = {"samples": self.batch}
        self.per_time = 1                        # per-layer times a step

    def next_windows(self) -> np.ndarray:
        """[batch, W] time indices: the next batch of a seeded shuffle of
        every valid reference time, reshuffled when it runs out."""
        if len(self.order) < self.batch:
            self.order = list(self.rng.permutation(self.t0s))
        t0 = np.asarray(self.order[:self.batch])
        del self.order[:self.batch]
        return t0[:, None] + np.asarray(self.offsets)[None, :]

    def run_unit(self):
        from deepsphere_weather_torch.parallel.mesh import shard_window_indices

        widx = self.next_windows()
        self.windows.append(widx)
        total, _ = self.step(self.data, shard_window_indices(
            widx, None, self.device), self.w_dev, self.area_w)
        self.losses.append(total)

    def setup_units(self, n: int) -> Dict:
        """The first n steps; what the reference is held against: each
        step's loss, the first gradient as Adam took it (its first moment
        after one step over 1 - beta1) and the parameters before them and
        after."""
        params0 = {k: v.detach().clone() for k, v in
                   self.model.named_parameters()}
        grads = None
        for i in range(n):
            self.run_unit()
            if i == 0:
                b1 = self.optimizer.param_groups[0]["betas"][0]
                grads = {k: (self.optimizer.state[v]["exp_avg"] / (1 - b1))
                         .detach().clone()
                         for k, v in self.model.named_parameters()}
        self.sync()
        return {"losses": [float(t) for t in self.losses[:n]],
                "grads": grads, "params0": params0,
                "params": {k: v.detach().clone() for k, v in
                           self.model.named_parameters()},
                "windows": list(self.windows[:n])}

    def failed(self) -> int:
        return int(sum(not math.isfinite(float(t)) for t in self.losses))

    def unit_counts(self, forward_flops: float, products: List):
        """A step's operations (AR + 1 calls, a backward twice its
        forward) and its Laplacian products: each forward product's L^T g
        in the backward too, but for the first ConvBlock's of the first
        call, whose input, the data, needs no gradient."""
        calls = self.ar_iterations + 1
        prods = products * calls
        return forward_flops * calls * 3, prods + prods[self.K - 1:]

    def program_readings(self, setup: Dict, seed: int) -> Dict:
        return setup

    def reference_readings(self, setup: Dict, make_net, prec: str = "fp32",
                           half_batch: bool = False) -> Dict:
        """The reference's losses, first gradients and parameters after the
        set-up steps, on the program's batches; `half_batch` plants a
        fault: each batch's first half only."""
        data, ar, dev = self.data, self.ar, self.device
        _, in_pos, out_pos = ar_windows(ar["input_k"], ar["output_k"],
                                        ar["forecast_cycle"],
                                        self.ar_iterations)
        batches = []
        for w in setup["windows"]:
            w = torch.as_tensor(w[:len(w) // 2] if half_batch else w,
                                device=dev)
            batches.append((data["dynamic"][w], data["bc"][w]))
        area_w = torch.full((self.nodes,), 1.0 / self.nodes, device=dev)
        losses, grads, params = adam_train(
            make_net(prec), self.params, batches, data["static"], in_pos,
            out_pos, self.ar_weights, area_w, float(self.ts["learning_rate"]),
            float(self.ts.get("gradient_clipping") or math.inf))
        return {"losses": losses, "grads": grads, "params0": self.params,
                "params": params}

    compare = staticmethod(checks.train_numbers)

    def fault_readings(self, setup, make_net, prog, ref) -> Dict:
        return {"fault_half_batch": self.compare(self.reference_readings(
            setup, make_net, half_batch=True), ref)}

    def free(self):
        self.step = self.optimizer = None
        super().free()
