"""AR scheduler and early stopping (numpy; the port's own copy).

`ARScheduler` and `EarlyStopping` from
`deepsphere_weather_tpu/engine/scheduler.py`, with the same semantics and
the same `state_dict` layout, so each side loads the other's state.

`ARScheduler` carries per-AR-iteration loss weights that grow over
training:

- absolute weights start from `initial_ar_absolute_weights` (missing
  entries start at 0 and grow)
- `.step()` is called every scoring interval; non-fixed weights below 1
  grow by the method's rule (LinearStep: += factor; ExponentialStep:
  geometric approach to 1; Constant: stay)
- `.update()` appends a new AR iteration (weight 0 unless provided),
  called when EarlyStopping's patience runs out before `ar_iterations`
  is reached
- `.ar_weights` returns the normalized weights; `.current_ar_iterations`
  the number of *extra* AR steps (len(weights) - 1)

The training strategy fixes which weights never change: 'RNN' fixes
iteration 0, 'AR' fixes all already-grown iterations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ARScheduler", "EarlyStopping"]


class ARScheduler:
    VALID_METHODS = ("Constant", "LinearStep", "ExponentialStep", "DiracDelta")

    def __init__(self, method: str = "LinearStep", factor: float = 0.001,
                 fixed_ar_weights: Optional[Sequence[int]] = None,
                 initial_ar_absolute_weights: Optional[Sequence[float]] = None,
                 max_ar_iterations: Optional[int] = None):
        if method not in self.VALID_METHODS:
            raise ValueError(f"method must be one of {self.VALID_METHODS}")
        self.method = method
        self.factor = float(factor)
        self.fixed_ar_weights = set(int(i) for i in (fixed_ar_weights or []))
        init = list(initial_ar_absolute_weights or [1.0])
        self.absolute_weights: List[float] = [float(w) for w in init]
        self.max_ar_iterations = max_ar_iterations

    # ------------------------------------------------------------------
    @property
    def current_ar_iterations(self) -> int:
        return len(self.absolute_weights) - 1

    @property
    def ar_absolute_weights(self) -> np.ndarray:
        return np.asarray(self.absolute_weights, dtype=np.float32)

    @property
    def ar_weights(self) -> np.ndarray:
        w = self.ar_absolute_weights
        if self.method == "DiracDelta":
            out = np.zeros_like(w)
            out[-1] = 1.0
            return out
        s = w.sum()
        return w / s if s > 0 else w

    def padded_weights(self, length: int) -> np.ndarray:
        """Normalized weights zero-padded to a fixed length (jit-friendly)."""
        w = self.ar_weights
        out = np.zeros(length, dtype=np.float32)
        out[: len(w)] = w
        return out

    # ------------------------------------------------------------------
    def step(self):
        """Grow non-fixed, not-yet-saturated weights (per scoring interval)."""
        if self.method in ("Constant", "DiracDelta"):
            return
        for i in range(len(self.absolute_weights)):
            if i in self.fixed_ar_weights:
                continue
            w = self.absolute_weights[i]
            if w >= 1.0:
                continue
            if self.method == "LinearStep":
                w = min(w + self.factor, 1.0)
            elif self.method == "ExponentialStep":
                w = min(w + self.factor * (1.0 - w), 1.0)
            self.absolute_weights[i] = w

    @property
    def ramp_in_progress(self) -> bool:
        """True while any growable weight is still below saturation —
        the loss definition is non-stationary, so plateau judgements
        (early stopping / AR growth) are meaningless. LinearStep reaches
        1.0 exactly; ExponentialStep approaches asymptotically, hence
        the 0.999 threshold."""
        if self.method in ("Constant", "DiracDelta"):
            return False
        return any(w < 0.999 for i, w in enumerate(self.absolute_weights)
                   if i not in self.fixed_ar_weights)

    def can_update(self) -> bool:
        if self.max_ar_iterations is None:
            return True
        return self.current_ar_iterations < self.max_ar_iterations

    def update(self, initial_weight: float = 0.0):
        """Add one AR iteration (called on early-stopping plateau)."""
        if not self.can_update():
            raise RuntimeError("already at max_ar_iterations")
        if self.method == "Constant":
            initial_weight = 1.0
        self.absolute_weights.append(float(initial_weight))

    def fix_all_grown(self):
        """'AR' training strategy: freeze every existing weight."""
        self.fixed_ar_weights |= set(range(len(self.absolute_weights)))

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "method": self.method,
            "factor": self.factor,
            "fixed_ar_weights": sorted(self.fixed_ar_weights),
            "absolute_weights": list(self.absolute_weights),
            "max_ar_iterations": self.max_ar_iterations,
        }

    @classmethod
    def from_state_dict(cls, state: Dict) -> "ARScheduler":
        obj = cls(method=state["method"], factor=state["factor"],
                  fixed_ar_weights=state["fixed_ar_weights"],
                  initial_ar_absolute_weights=state["absolute_weights"],
                  max_ar_iterations=state.get("max_ar_iterations"))
        return obj


class EarlyStopping:
    """Patience-based stopping on a monitored metric."""

    def __init__(self, patience: int = 10, minimum_improvement: float = 0.0,
                 minimum_iterations: int = 0,
                 stopping_metric: str = "validation_total_loss",
                 mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.patience = int(patience)
        self.minimum_improvement = float(minimum_improvement)
        self.minimum_iterations = int(minimum_iterations)
        self.stopping_metric = stopping_metric
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.n_checks = 0

    def check(self, score: float) -> bool:
        """Record a score; returns True when patience is exhausted."""
        self.n_checks += 1
        if self.best is None:
            self.best = score
            return False
        improved = (
            score < self.best - self.minimum_improvement
            if self.mode == "min"
            else score > self.best + self.minimum_improvement
        )
        if improved:
            self.best = score
            self.counter = 0
        else:
            self.counter += 1
        if self.n_checks < self.minimum_iterations:
            return False
        return self.counter >= self.patience

    def reset_counter(self):
        """Reset patience (after the AR scheduler adds an iteration)."""
        self.counter = 0

    def reset(self):
        """Full reset: patience, best score AND the minimum_iterations
        clock. Used at AR-growth events (early_stopping_reset_on_growth
        = "full") so each AR stage's plateau is judged against its own
        loss definition — the grown loss includes harder leadtimes and
        sits above the previous stage's best, which otherwise burns the
        whole patience budget without a single 'improved' check."""
        self.best = None
        self.counter = 0
        self.n_checks = 0

    def state_dict(self) -> Dict:
        return {"patience": self.patience,
                "minimum_improvement": self.minimum_improvement,
                "minimum_iterations": self.minimum_iterations,
                "stopping_metric": self.stopping_metric, "mode": self.mode,
                "best": self.best, "counter": self.counter,
                "n_checks": self.n_checks}

    @classmethod
    def from_state_dict(cls, state: Dict) -> "EarlyStopping":
        obj = cls(patience=state["patience"],
                  minimum_improvement=state["minimum_improvement"],
                  minimum_iterations=state["minimum_iterations"],
                  stopping_metric=state["stopping_metric"], mode=state["mode"])
        obj.best = state["best"]
        obj.counter = state["counter"]
        obj.n_checks = state["n_checks"]
        return obj
