"""Labeled spherical datasets over the chunked store (xarray-lite).

The port's copy of `deepsphere_weather_tpu/data/dataset.py` (numpy
only):

- `SphericalDataset`: named (time, node) variables + time/lat/lon coords,
  zarr-backed, with time subsetting and stacked [T, V, F] reads
- `DatasetView`: a contiguous time slice of one (the train/val/test
  splits)
- `StaticDataset`: (node,) variables (orography, lsm, ...)
- `save_dynamic` / `save_static`: the canonical store layout, and
  `train_val_test_split_indices`, the fractional split

Feature order is the sorted variable-name order unless specified, and is
recorded in store attrs so train/predict layouts can be revalidated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .zarrstore import ZarrArray, ZarrGroup, create_group, open_group

__all__ = ["SphericalDataset", "StaticDataset", "save_dynamic", "save_static", "train_val_test_split_indices"]

_NS = "datetime64[ns]"


class SphericalDataset:
    """Time-series of fields on a spherical sampling, dims (time, node)."""

    def __init__(self, group: ZarrGroup, feature_order: Optional[List[str]] = None):
        self.group = group
        names = [n for n in group.array_names()
                 if n not in ("time", "lat", "lon")]
        if feature_order is None:
            feature_order = group.attrs.get("feature_order", sorted(names))
        missing = set(feature_order) - set(names)
        if missing:
            raise ValueError(f"variables {missing} not in store")
        self.feature_order = list(feature_order)
        self.variables: Dict[str, ZarrArray] = {
            n: group[n] for n in self.feature_order}
        self.time = np.asarray(group["time"][...]).view(_NS)
        self.lat = np.asarray(group["lat"][...]) if "lat" in group else None
        self.lon = np.asarray(group["lon"][...]) if "lon" in group else None
        first = self.variables[self.feature_order[0]]
        self.n_time, self.n_node = first.shape
        assert self.n_time == len(self.time)

    @classmethod
    def open(cls, path, feature_order=None) -> "SphericalDataset":
        return cls(open_group(path), feature_order=feature_order)

    # ------------------------------------------------------------------
    @property
    def n_feature(self) -> int:
        return len(self.feature_order)

    @property
    def timestep(self) -> np.timedelta64:
        return self.time[1] - self.time[0]

    def time_indices_between(self, start=None, end=None) -> np.ndarray:
        """Indices with start <= time < end (numpy datetime64 or ISO strings)."""
        mask = np.ones(self.n_time, dtype=bool)
        if start is not None:
            mask &= self.time >= np.datetime64(start)
        if end is not None:
            mask &= self.time < np.datetime64(end)
        return np.nonzero(mask)[0]

    def read_stacked(self, t_index: Sequence[int]) -> np.ndarray:
        """Read times `t_index` for all variables -> [len(t), node, feature]."""
        t_index = np.asarray(t_index)
        if len(t_index) == 0:
            return np.zeros((0, self.n_node, self.n_feature), dtype=np.float32)
        lo, hi = int(t_index.min()), int(t_index.max()) + 1
        out = np.empty((len(t_index), self.n_node, self.n_feature),
                       dtype=np.float32)
        rel = t_index - lo
        for f, name in enumerate(self.feature_order):
            block = self.variables[name][lo:hi, :]
            out[:, :, f] = block[rel]
        return out

    def read_all(self) -> np.ndarray:
        return self.read_stacked(np.arange(self.n_time))

    def subset(self, lo: int, hi: int) -> "DatasetView":
        """Contiguous time-sliced view (train/val/test splits)."""
        return DatasetView(self, lo, hi)

    def subset_between(self, start=None, end=None) -> "DatasetView":
        idx = self.time_indices_between(start, end)
        if len(idx) == 0:
            raise ValueError(f"no timesteps in [{start}, {end})")
        return DatasetView(self, int(idx[0]), int(idx[-1]) + 1)


class DatasetView:
    """Time-sliced view of a SphericalDataset (same read interface)."""

    def __init__(self, ds: "SphericalDataset", lo: int, hi: int):
        self._ds = ds
        self._lo = lo
        self.lo, self.hi = lo, hi        # absolute index bounds in ds
        self.time = ds.time[lo:hi]
        self.n_time = hi - lo
        self.n_node = ds.n_node
        self.feature_order = ds.feature_order
        self.lat, self.lon = ds.lat, ds.lon

    @property
    def timestep(self):
        return self._ds.timestep

    @property
    def n_feature(self) -> int:
        return len(self.feature_order)

    def read_stacked(self, t_index) -> np.ndarray:
        return self._ds.read_stacked(np.asarray(t_index) + self._lo)

    def read_all(self) -> np.ndarray:
        return self.read_stacked(np.arange(self.n_time))


class StaticDataset:
    """Time-invariant fields on a sampling, dims (node,)."""

    def __init__(self, group: ZarrGroup, feature_order: Optional[List[str]] = None):
        self.group = group
        names = [n for n in group.array_names() if n not in ("lat", "lon")]
        if feature_order is None:
            feature_order = group.attrs.get("feature_order", sorted(names))
        self.feature_order = list(feature_order)
        self.variables = {n: group[n] for n in self.feature_order}
        first = self.variables[self.feature_order[0]]
        self.n_node = first.shape[0]

    @classmethod
    def open(cls, path, feature_order=None) -> "StaticDataset":
        return cls(open_group(path), feature_order=feature_order)

    @property
    def n_feature(self) -> int:
        return len(self.feature_order)

    def read_stacked(self) -> np.ndarray:
        """-> [node, feature]."""
        out = np.empty((self.n_node, self.n_feature), dtype=np.float32)
        for f, name in enumerate(self.feature_order):
            out[:, f] = self.variables[name][...]
        return out


def train_val_test_split_indices(n_time: int,
                                 train_frac: float = 0.7,
                                 val_frac: float = 0.15):
    """(i_train, i_val) boundaries of the train/val/test time split.

    One shared definition (reference: fixed-year split,
    train_predict_state.py:217-219; fractional split works for any time
    range) — the drivers previously hard-coded 0.7/0.85 independently,
    so a change in one would silently leak train data into another
    driver's test window."""
    i_train = int(n_time * train_frac)
    i_val = int(n_time * (train_frac + val_frac))
    return i_train, i_val


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def save_dynamic(path, variables: Dict[str, np.ndarray], time: np.ndarray,
                 lat: np.ndarray, lon: np.ndarray,
                 time_chunk: int = 24 * 7, compressor="zlib",
                 overwrite: bool = True) -> SphericalDataset:
    """Write a (time, node) dataset in the framework's canonical layout.

    Default chunking matches the reference's time_chunked convention
    {node: -1, time: 24*7} (reference scripts/03c:307-318).
    """
    g = create_group(path, overwrite=overwrite,
                     attrs={"feature_order": sorted(variables)})
    names = sorted(variables)
    T, V = variables[names[0]].shape
    for n in names:
        # chunk layout is permanent: always the canonical time_chunk even
        # if the first ingest batch is shorter (zarr allows a chunk larger
        # than the array; clamping to T froze tiny chunks for append-mode
        # ingest that starts with a small batch)
        arr = g.create_array(n, shape=(T, V),
                             chunks=(time_chunk, V),
                             dtype=np.float32, compressor=compressor)
        arr[...] = variables[n].astype(np.float32)
    t = g.create_array("time", shape=(T,), chunks=(T,), dtype=np.int64,
                       compressor=None,
                       attrs={"units": "nanoseconds since 1970-01-01"})
    t[...] = np.asarray(time, dtype=_NS).view(np.int64)
    for cname, cval in (("lat", lat), ("lon", lon)):
        c = g.create_array(cname, shape=(V,), chunks=(V,), dtype=np.float64,
                           compressor=None)
        c[...] = cval
    return SphericalDataset(g)


def save_static(path, variables: Dict[str, np.ndarray],
                lat: np.ndarray, lon: np.ndarray,
                overwrite: bool = True) -> StaticDataset:
    g = create_group(path, overwrite=overwrite,
                     attrs={"feature_order": sorted(variables)})
    names = sorted(variables)
    V = variables[names[0]].shape[0]
    for n in names:
        arr = g.create_array(n, shape=(V,), chunks=(V,), dtype=np.float32,
                             compressor=None)
        arr[...] = variables[n].astype(np.float32)
    for cname, cval in (("lat", lat), ("lon", lon)):
        c = g.create_array(cname, shape=(V,), chunks=(V,), dtype=np.float64,
                           compressor=None)
        c[...] = cval
    return StaticDataset(g)
