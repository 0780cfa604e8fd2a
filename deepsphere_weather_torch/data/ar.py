"""Autoregressive sample-index machinery (numpy; the port's own copy).

`ARIndexer` and `get_ar_model_tensor_info` from
`deepsphere_weather_tpu/data/ar.py`: the translation from
(input_k, output_k, forecast_cycle, ar_iterations) AR settings to concrete
time-window indices, as in the external `xforecasting` dataset layer.

Semantics (reference defaults utils_config.py:79-88; 6h config
configs/.../MaxPool-Graph_knn.json):
- input_k / output_k are offsets in *data timesteps* relative to the
  forecast reference position of each AR iteration
- AR iteration i is shifted by i * forecast_cycle timesteps
- `stack_most_recent_prediction=True`: a lag slot whose time was already
  predicted is filled with the model's own (most recent) prediction

The indexer precomputes, once per AR configuration:
- `rel_offsets`: the sorted unique set of window offsets a sample needs
- `input_pos[i, j]` / `output_pos[i, j]`: positions into that window for
  AR iteration i — static arrays the jitted lax.scan rollout indexes with
  the (traced) iteration counter, so growing AR iterations never triggers
  a recompile (SURVEY.md §7 hard part 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ARIndexer", "check_ar_settings", "get_ar_model_tensor_info"]


def check_ar_settings(input_k: Sequence[int], output_k: Sequence[int],
                      forecast_cycle: int, ar_iterations: int,
                      stack_most_recent_prediction: bool = True):
    """Validate AR settings (xforecasting check_ar_settings parity)."""
    input_k = [int(k) for k in input_k]
    output_k = [int(k) for k in output_k]
    if not input_k or not output_k:
        raise ValueError("input_k and output_k must be non-empty")
    if max(input_k) >= min(output_k):
        raise ValueError("input_k must all precede output_k")
    if sorted(input_k) != input_k or sorted(output_k) != output_k:
        raise ValueError("input_k and output_k must be sorted ascending")
    if int(forecast_cycle) < 1:
        raise ValueError("forecast_cycle must be >= 1")
    if int(ar_iterations) < 0:
        raise ValueError("ar_iterations must be >= 0")
    return input_k, output_k, int(forecast_cycle), int(ar_iterations)


@dataclasses.dataclass
class ARIndexer:
    """Precomputed window geometry for an AR configuration."""

    input_k: List[int]
    output_k: List[int]
    forecast_cycle: int
    ar_iterations: int                      # maximum AR iterations (inclusive count of extra steps)
    rel_offsets: np.ndarray                 # [W] sorted window offsets (0 = forecast ref)
    input_pos: np.ndarray                   # [N+1, n_in]  positions into window
    output_pos: np.ndarray                  # [N+1, n_out]
    min_offset: int
    max_offset: int
    # True (default): a window slot predicted by several AR iterations is
    # fed back with the MOST RECENT prediction; False keeps the FIRST
    # (xforecasting stack_most_recent_prediction semantics, SURVEY.md
    # §2.9). The two only diverge when output windows overlap across
    # iterations (never with output_k=[0]).
    stack_most_recent_prediction: bool = True

    @classmethod
    def build(cls, input_k, output_k, forecast_cycle, ar_iterations,
              stack_most_recent_prediction: bool = True) -> "ARIndexer":
        input_k, output_k, fc, n_ar = check_ar_settings(
            input_k, output_k, forecast_cycle, ar_iterations,
            stack_most_recent_prediction)
        offsets = set()
        for i in range(n_ar + 1):
            for k in input_k:
                offsets.add(i * fc + k)
            for k in output_k:
                offsets.add(i * fc + k)
        rel = np.array(sorted(offsets), dtype=np.int64)
        pos = {o: p for p, o in enumerate(rel)}
        in_pos = np.array(
            [[pos[i * fc + k] for k in input_k] for i in range(n_ar + 1)],
            dtype=np.int32)
        out_pos = np.array(
            [[pos[i * fc + k] for k in output_k] for i in range(n_ar + 1)],
            dtype=np.int32)
        return cls(input_k=input_k, output_k=output_k, forecast_cycle=fc,
                   ar_iterations=n_ar, rel_offsets=rel,
                   input_pos=in_pos, output_pos=out_pos,
                   min_offset=int(rel.min()), max_offset=int(rel.max()),
                   stack_most_recent_prediction=bool(
                       stack_most_recent_prediction))

    @property
    def has_overlapping_outputs(self) -> bool:
        """True when several AR iterations predict the same time (the only
        regime where stack_most_recent_prediction matters)."""
        times = [i * self.forecast_cycle + k
                 for i in range(self.ar_iterations + 1)
                 for k in self.output_k]
        return len(times) != len(set(times))

    # ------------------------------------------------------------------
    @property
    def window_size(self) -> int:
        return len(self.rel_offsets)

    def valid_reference_positions(self, n_time: int,
                                  current_ar_iterations: Optional[int] = None
                                  ) -> np.ndarray:
        """Time indices usable as forecast reference position t0."""
        n = self.ar_iterations if current_ar_iterations is None \
            else current_ar_iterations
        lo = -min(min(self.input_k), 0)
        max_off = n * self.forecast_cycle + max(self.output_k)
        hi = n_time - max_off
        return np.arange(lo, max(hi, lo), dtype=np.int64)

    def window_time_indices(self, t0: int) -> np.ndarray:
        """Absolute dataset time indices of a sample's window."""
        return t0 + self.rel_offsets

    def reference_positions_for_times(self, dataset_time: np.ndarray,
                                      forecast_reference_times: np.ndarray
                                      ) -> np.ndarray:
        """Map explicit forecast_reference_times to window start positions,
        with the validation the reference enumerates
        (dev/w_debug_predictions.py:194-237)."""
        frt = np.asarray(forecast_reference_times, dtype="datetime64[ns]")
        if frt.ndim == 0:
            frt = frt[None]
        if len(frt) == 0:
            raise ValueError("forecast_reference_times is empty")
        if len(np.unique(frt)) != len(frt):
            raise ValueError("forecast_reference_times contains duplicates")
        sidx = np.searchsorted(dataset_time, frt)
        bad = (sidx >= len(dataset_time)) | (dataset_time[np.minimum(
            sidx, len(dataset_time) - 1)] != frt)
        if bad.any():
            raise ValueError(
                f"forecast_reference_times not in dataset: {frt[bad]}")
        t0 = sidx
        if (t0 + self.min_offset < 0).any():
            raise ValueError(
                "insufficient history before some forecast_reference_times "
                f"(need {-self.min_offset} steps)")
        return t0.astype(np.int64)


def get_ar_model_tensor_info(ar_settings: Dict, data_dynamic,
                             data_static=None, data_bc=None) -> Dict:
    """Build the tensor_info contract dict
    (xforecasting.utils.io.get_ar_model_tensor_info parity).

    Feature order is static + bc + dynamic
    (reference: modules/my_models_graph.py:319-325 commented contract).
    """
    input_k, output_k, fc, n_ar = check_ar_settings(
        ar_settings["input_k"], ar_settings["output_k"],
        ar_settings["forecast_cycle"], ar_settings["ar_iterations"])
    n_dyn = data_dynamic.n_feature
    n_bc = data_bc.n_feature if data_bc is not None else 0
    n_static = data_static.n_feature if data_static is not None else 0
    n_node = data_dynamic.n_node
    input_n_feature = n_static + n_bc + n_dyn
    input_n_time = len(input_k)
    output_n_time = len(output_k)
    feature_order = {
        "static": list(data_static.feature_order) if data_static else [],
        "bc": list(data_bc.feature_order) if data_bc else [],
        "dynamic": list(data_dynamic.feature_order),
    }
    return {
        "input_k": input_k,
        "output_k": output_k,
        "forecast_cycle": fc,
        "ar_iterations": n_ar,
        "input_n_feature": input_n_feature,
        "output_n_feature": n_dyn,
        "input_n_time": input_n_time,
        "output_n_time": output_n_time,
        "input_shape_info": {"dynamic": {"node": n_node}},
        "output_shape_info": {"dynamic": {"node": n_node}},
        "input_shape": [input_n_time, n_node, input_n_feature],
        "output_shape": [output_n_time, n_node, n_dyn],
        "dim_order": {"dynamic": ["sample", "time", "node", "feature"]},
        "feature_order": feature_order,
    }
