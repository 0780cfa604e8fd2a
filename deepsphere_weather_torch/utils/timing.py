"""Device-aware timing (port of `deepsphere_weather_tpu/utils/timing.py`;
reference: xforecasting get_time_function, which synchronizes CUDA)."""

from __future__ import annotations

import time
from typing import List

import torch

__all__ = ["device_sync", "Timer"]


def device_sync(device=None):
    """Wait for the card's queued work (`torch.cuda.synchronize`); a no-op
    without CUDA or for a CPU device."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


class Timer:
    """Median-of-N wall-time measurement, synchronized with the card."""

    def __init__(self, device=None):
        self.device = device
        self.samples: List[float] = []

    def measure(self, fn, n: int = 10, warmup: int = 2):
        for _ in range(warmup):
            fn()
            device_sync(self.device)
        self.samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            device_sync(self.device)
            self.samples.append(time.perf_counter() - t0)
        return self.median

    @property
    def median(self) -> float:
        s = sorted(self.samples)
        return s[len(s) // 2]
