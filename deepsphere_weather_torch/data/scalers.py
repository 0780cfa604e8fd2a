"""Per-feature global standardization, numpy only (no pandas).

The port's copy of `GlobalStandardScaler` from
`deepsphere_weather_tpu/data/scalers.py`, with the same `.npz` + JSON
header file format, so a scaler saved by either stack loads in the other.
The time-grouped scalers (anomaly, climatology) need pandas' calendar
fields there; they and the min-max and sequential scalers are not ported
yet, and `load_scaler` raises for them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["GlobalStandardScaler", "load_scaler"]


class GlobalStandardScaler:
    """Per-feature global standardization over (time, node)."""

    kind = "global_standard"

    def __init__(self, mean=None, std=None, feature_order: Optional[List[str]] = None):
        self.mean = mean
        self.std = std
        self.feature_order = feature_order

    def fit(self, data: np.ndarray, feature_order=None) -> "GlobalStandardScaler":
        """data: [T, V, F]. Constant features (std 0) scale by 1."""
        # float64 accumulators: float32 sums over a large strided
        # (time, node) reduction lose most of their digits
        self.mean = data.mean(axis=(0, 1), dtype=np.float64)
        std = data.std(axis=(0, 1), dtype=np.float64)
        self.std = np.where(std > 0, std, 1.0)
        self.feature_order = feature_order
        return self

    def transform(self, x, time=None):
        return (x - self.mean) / self.std

    def inverse_transform(self, x, time=None):
        return x * self.std + self.mean

    def save(self, path):
        header = {"feature_order": self.feature_order, "kind": self.kind}
        np.savez_compressed(Path(path), __header__=json.dumps(header),
                            mean=self.mean, std=self.std)

    @classmethod
    def _from_state(cls, header, arrays):
        return cls(mean=arrays["mean"], std=arrays["std"],
                   feature_order=header.get("feature_order"))


def load_scaler(path):
    """Load a saved scaler (global standard only in this port)."""
    with np.load(Path(path), allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    if header["kind"] != GlobalStandardScaler.kind:
        raise NotImplementedError(
            f"scaler kind {header['kind']!r} is not ported yet")
    return GlobalStandardScaler._from_state(header, arrays)
