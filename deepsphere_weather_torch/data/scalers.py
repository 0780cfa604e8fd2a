"""Scalers, numpy only (no pandas).

The port's copy of `deepsphere_weather_tpu/data/scalers.py`:
`GlobalStandardScaler` and `GlobalMinMaxScaler` (per-feature statistics
over time and node, fitted from an array or streamed over a
`SphericalDataset`), the time-grouped `AnomalyScaler` and `Climatology`
(per time group, node and feature), `SequentialScaler` (composition) and
`load_scaler`, with the same `.npz` + JSON header file format, so a
scaler saved by either package loads in the other.

The JAX package takes the calendar fields of `time_group_indices` from
pandas; here they are computed from `datetime64` with numpy alone, to the
same values: `weekofyear` is the ISO week (1-3 January can fall in week
52 or 53 of the year before, 29-31 December in week 1 of the next),
`dayofyear` runs to 366 in leap years.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["GlobalStandardScaler", "GlobalMinMaxScaler", "AnomalyScaler",
           "Climatology", "SequentialScaler", "load_scaler",
           "time_group_indices"]

_NS = "datetime64[ns]"
_GROUP_SIZES = {"month": 12, "weekofyear": 53, "dayofyear": 366, "hour": 24}


def _group_sizes(time_groups) -> int:
    """Total group count; compound groupings (e.g. ['hour', 'month'])
    multiply."""
    if isinstance(time_groups, str):
        return _GROUP_SIZES[time_groups]
    n = 1
    for g in time_groups:
        n *= _GROUP_SIZES[g]
    return n


def _single_group_indices(t: np.ndarray, group: str) -> np.ndarray:
    """0-based calendar field of datetime64[ns] times."""
    days = t.astype("datetime64[D]")
    if group == "month":
        return t.astype("datetime64[M]").astype(np.int64) % 12
    if group == "dayofyear":
        return (days - t.astype("datetime64[Y]")).astype(np.int64)
    if group == "hour":
        return (t.astype("datetime64[h]") - days).astype(np.int64)
    if group == "weekofyear":
        # ISO 8601: a week runs Monday to Sunday and belongs to the year
        # of its Thursday; week 1 holds the year's first Thursday
        d = days.astype(np.int64)
        weekday = (d + 3) % 7                 # 1970-01-01 was a Thursday
        thursday = (d - weekday + 3).astype("datetime64[D]")
        doy = (thursday - thursday.astype("datetime64[Y]")).astype(np.int64)
        return doy // 7
    raise ValueError(f"unknown time_groups {group!r}")


def time_group_indices(time: np.ndarray, time_groups) -> np.ndarray:
    """0-based group index per timestamp.

    `time_groups` is a single rule name or a sequence of them; compound
    groupings use a mixed-radix index (e.g. ['hour', 'month'] -> 24*12
    groups)."""
    t = np.asarray(time, dtype=_NS).reshape(-1)
    if isinstance(time_groups, str):
        return _single_group_indices(t, time_groups)
    out = np.zeros(len(t), dtype=np.int64)
    for g in time_groups:
        out = out * _GROUP_SIZES[g] + _single_group_indices(t, g)
    return out


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


class AnomalyScaler(_BaseScaler):
    """Per time-group, per-node anomaly scaler: transform subtracts the
    group/node/feature mean; `standardized` also divides by the group
    std."""

    kind = "anomaly"

    def __init__(self, time_groups="month", standardized: bool = True,
                 mean=None, std=None, feature_order=None,
                 reference_period: Optional[Tuple[str, str]] = None):
        self.time_groups = time_groups
        self.standardized = standardized
        self.mean = mean          # [G, V, F]
        self.std = std
        self.feature_order = feature_order
        self.reference_period = reference_period
        self.fitted = None        # [G] bool mask of groups seen at fit

    def fit(self, data: np.ndarray, time: np.ndarray, feature_order=None):
        time = np.asarray(time, dtype=_NS)
        if self.reference_period is not None:
            lo = np.datetime64(self.reference_period[0])
            hi = np.datetime64(self.reference_period[1])
            sel = (time >= lo) & (time < hi)
            data, time = data[sel], time[sel]
        G = _group_sizes(self.time_groups)
        gidx = time_group_indices(time, self.time_groups)
        T, V, F = data.shape
        mean = np.zeros((G, V, F))
        std = np.ones((G, V, F))
        fitted = np.zeros(G, dtype=bool)
        for g in range(G):
            sel = gidx == g
            if sel.any():
                fitted[g] = True
                mean[g] = data[sel].mean(axis=0, dtype=np.float64)
                s = data[sel].std(axis=0, dtype=np.float64)
                std[g] = np.where(s > 0, s, 1.0)
        self.mean, self.std = mean, std
        self.fitted = fitted
        self.feature_order = feature_order
        return self

    def _check_groups(self, g):
        """Transforming a time group absent from the fit data would
        silently return the RAW field (mean 0 / std 1): error instead."""
        if getattr(self, "fitted", None) is None:
            return
        bad = np.unique(np.asarray(g)[~self.fitted[np.asarray(g)]])
        if bad.size:
            raise ValueError(
                f"AnomalyScaler({self.time_groups!r}): time group(s) "
                f"{bad.tolist()} were absent from the fit data "
                f"(reference_period={self.reference_period}); cannot "
                f"transform timestamps in those groups")

    def _groups(self, time):
        return time_group_indices(np.asarray(time, dtype=_NS),
                                  self.time_groups)

    def transform(self, x, time=None):
        g = self._groups(time)
        self._check_groups(g)
        out = x - self.mean[g]
        if self.standardized:
            out = out / self.std[g]
        return out

    def inverse_transform(self, x, time=None):
        g = self._groups(time)
        self._check_groups(g)
        out = x * self.std[g] if self.standardized else x
        return out + self.mean[g]

    def _state(self):
        arrays = {"mean": self.mean, "std": self.std}
        if getattr(self, "fitted", None) is not None:
            arrays["fitted"] = self.fitted
        return ({"time_groups": self.time_groups,
                 "standardized": self.standardized,
                 "feature_order": self.feature_order,
                 "reference_period": list(self.reference_period)
                 if self.reference_period else None},
                arrays)

    @classmethod
    def _from_state(cls, header, arrays):
        obj = cls(time_groups=header["time_groups"],
                  standardized=header["standardized"],
                  mean=arrays["mean"], std=arrays["std"],
                  feature_order=header.get("feature_order"),
                  reference_period=tuple(header["reference_period"])
                  if header.get("reference_period") else None)
        if "fitted" in arrays:   # older files: assume all groups fitted
            obj.fitted = arrays["fitted"].astype(bool)
        return obj


class Climatology(AnomalyScaler):
    """Climatology = group mean (+ variability); `.forecast(times)` is the
    climatological forecast."""

    kind = "climatology"

    def forecast(self, times: np.ndarray) -> np.ndarray:
        """Climatological forecast fields at the given times -> [T, V, F]."""
        g = self._groups(times)
        return self.mean[g].astype(np.float32)


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
    "anomaly": AnomalyScaler,
    "climatology": Climatology,
}


def load_scaler(path):
    """Load a saved scaler file (or a SequentialScaler directory)."""
    path = Path(path)
    if path.is_dir() and (path / "header.json").exists():
        return SequentialScaler.load(path)
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    kind = header["kind"]
    if kind not in _KINDS:
        raise ValueError(f"unknown scaler kind {kind!r} in {path}")
    return _KINDS[kind]._from_state(header, arrays)
