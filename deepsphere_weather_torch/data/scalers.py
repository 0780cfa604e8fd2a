"""Scalers, numpy only (no pandas).

The port's copy of the global scalers of
`deepsphere_weather_tpu/data/scalers.py`: `GlobalStandardScaler` and
`GlobalMinMaxScaler` (per-feature statistics over time and node, fitted
from an array or streamed over a `SphericalDataset`), `SequentialScaler`
(composition) and `load_scaler`, with the same `.npz` + JSON header file
format, so a scaler saved by either package loads in the other.

The time-grouped scalers (`AnomalyScaler`, `Climatology`) group times
with pandas' calendar fields there; the machine with the card has no
pandas, and they are not ported yet (ROADMAP Queue 1 item 4):
`load_scaler` raises NotImplementedError for their files.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["GlobalStandardScaler", "GlobalMinMaxScaler", "SequentialScaler",
           "load_scaler"]


class _BaseScaler:
    kind = "base"

    def _state(self):
        raise NotImplementedError

    def save(self, path):
        header, arrays = self._state()
        header["kind"] = self.kind
        np.savez_compressed(Path(path), __header__=json.dumps(header),
                            **arrays)


class GlobalStandardScaler(_BaseScaler):
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

    def fit_dataset(self, ds, chunk: int = 1024) -> "GlobalStandardScaler":
        """Streaming fit over a SphericalDataset (constant memory)."""
        n, s1, s2 = 0, 0.0, 0.0
        for lo in range(0, ds.n_time, chunk):
            block = ds.read_stacked(np.arange(lo, min(lo + chunk, ds.n_time)))
            x = block.reshape(-1, block.shape[-1]).astype(np.float64)
            n += x.shape[0]
            s1 = s1 + x.sum(axis=0)
            s2 = s2 + (x ** 2).sum(axis=0)
        self.mean = s1 / n
        std = np.sqrt(np.maximum(s2 / n - self.mean ** 2, 0))
        self.std = np.where(std > 0, std, 1.0)
        self.feature_order = list(ds.feature_order)
        return self

    def transform(self, x, time=None):
        return (x - self.mean) / self.std

    def inverse_transform(self, x, time=None):
        return x * self.std + self.mean

    def _state(self):
        return ({"feature_order": self.feature_order},
                {"mean": self.mean, "std": self.std})

    @classmethod
    def _from_state(cls, header, arrays):
        return cls(mean=arrays["mean"], std=arrays["std"],
                   feature_order=header.get("feature_order"))


class GlobalMinMaxScaler(_BaseScaler):
    """Per-feature min-max scaling to [0, 1]."""

    kind = "global_minmax"

    def __init__(self, vmin=None, vmax=None, feature_order=None):
        self.vmin, self.vmax = vmin, vmax
        self.feature_order = feature_order

    def fit(self, data: np.ndarray, feature_order=None):
        self.vmin = data.min(axis=(0, 1)).astype(np.float64)
        self.vmax = data.max(axis=(0, 1)).astype(np.float64)
        self.feature_order = feature_order
        return self

    def fit_dataset(self, ds, chunk: int = 1024):
        vmin = np.full(ds.n_feature, np.inf)
        vmax = np.full(ds.n_feature, -np.inf)
        for lo in range(0, ds.n_time, chunk):
            block = ds.read_stacked(np.arange(lo, min(lo + chunk, ds.n_time)))
            vmin = np.minimum(vmin, block.min(axis=(0, 1)))
            vmax = np.maximum(vmax, block.max(axis=(0, 1)))
        self.vmin, self.vmax = vmin, vmax
        self.feature_order = list(ds.feature_order)
        return self

    def _range(self):
        d = np.asarray(self.vmax) - np.asarray(self.vmin)
        # constant features (zero range) scale by 1 to stay finite
        return np.where(d > 0, d, 1.0)

    def transform(self, x, time=None):
        return (x - self.vmin) / self._range()

    def inverse_transform(self, x, time=None):
        return x * self._range() + self.vmin

    def _state(self):
        return ({"feature_order": self.feature_order},
                {"vmin": self.vmin, "vmax": self.vmax})

    @classmethod
    def _from_state(cls, header, arrays):
        return cls(vmin=arrays["vmin"], vmax=arrays["vmax"],
                   feature_order=header.get("feature_order"))


class SequentialScaler(_BaseScaler):
    """Composition of scalers applied in order (xscaler.SequentialScaler,
    reference train_predict_state.py:205-212). Saved as a directory of
    `header.json` and one file per scaler."""

    kind = "sequential"

    def __init__(self, *scalers):
        self.scalers = list(scalers)

    def transform(self, x, time=None):
        for s in self.scalers:
            x = s.transform(x, time=time)
        return x

    def inverse_transform(self, x, time=None):
        for s in reversed(self.scalers):
            x = s.inverse_transform(x, time=time)
        return x

    def save(self, path):
        path = Path(path)
        header = {"kind": self.kind, "n": len(self.scalers)}
        path.mkdir(parents=True, exist_ok=True)
        (path / "header.json").write_text(json.dumps(header))
        for i, s in enumerate(self.scalers):
            s.save(path / f"scaler_{i}.npz")

    @classmethod
    def load(cls, path):
        path = Path(path)
        header = json.loads((path / "header.json").read_text())
        return cls(*[load_scaler(path / f"scaler_{i}.npz")
                     for i in range(header["n"])])


_KINDS = {
    "global_standard": GlobalStandardScaler,
    "global_minmax": GlobalMinMaxScaler,
}
# time-grouped kinds of the JAX package, not ported yet
_NOT_PORTED = ("anomaly", "climatology")


def load_scaler(path):
    """Load a saved scaler file (or a SequentialScaler directory)."""
    path = Path(path)
    if path.is_dir() and (path / "header.json").exists():
        return SequentialScaler.load(path)
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    kind = header["kind"]
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"scaler kind {kind!r} ({path}) groups times with pandas in the "
            "JAX package and is not ported yet (ROADMAP Queue 1 item 4)")
    if kind not in _KINDS:
        raise ValueError(f"unknown scaler kind {kind!r} in {path}")
    return _KINDS[kind]._from_state(header, arrays)
