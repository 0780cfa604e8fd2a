"""Forecast service over an exported rollout (`serve.export`).

Port of `ForecastService` from `deepsphere_weather_tpu/serve/service.py`:

- loading from an artifact directory (`from_dir`),
- input scaling / output inverse scaling with the scalers,
- batch padding to the rollout's batch size (oversized batches split),
- block-chunked rollouts of any length (`n_steps`): the history carry stays
  on the device between blocks,
- ensemble artifacts: every member starts from the same history, the
  forecasts gain a leading member axis (`summarize` reduces it),
- request micro-batching: concurrent single-sample `submit()` calls are
  coalesced into one padded device batch, waiting at most
  `max_batch_delay_s` for it to fill.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .export import ExportedRollout, load_artifact

__all__ = ["ForecastService"]


class _Request:
    __slots__ = ("history", "bc", "n_steps", "future")

    def __init__(self, history, bc, n_steps, future):
        self.history = history
        self.bc = bc
        self.n_steps = n_steps
        self.future = future


class ForecastService:
    """Serve forecasts from an exported block rollout.

    >>> svc = ForecastService.from_dir("artifacts/healpix16")
    >>> fc = svc.predict(history, n_steps=20)      # [B, 20, n_out, V, F]
    """

    def __init__(self, rollout: ExportedRollout, scaler=None, scaler_bc=None,
                 max_batch_delay_s: float = 0.005):
        self.rollout = rollout
        self.meta = rollout.meta
        self.scaler = scaler
        self.scaler_bc = scaler_bc
        self.max_batch_delay_s = max_batch_delay_s
        self._lock = threading.Lock()
        self._queue: List[_Request] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    @classmethod
    def from_dir(cls, path, **kwargs) -> "ForecastService":
        rollout, scaler, scaler_bc = load_artifact(Path(path))
        return cls(rollout, scaler=scaler, scaler_bc=scaler_bc, **kwargs)

    @property
    def n_members(self) -> int:
        """> 0 for ensemble artifacts (member-stacked rollout)."""
        return int(self.meta.get("n_members", 0))

    def _validate(self, history: np.ndarray, bc, n_steps: int):
        m = self.meta
        H, V, F = m["history_size"], m["n_node"], m["n_dynamic_features"]
        history = np.asarray(history, np.float32)
        squeeze = history.ndim == 3
        if squeeze:
            history = history[None]
        if history.shape[1:] != (H, V, F):
            raise ValueError(
                f"history must be [B, {H}, {V}, {F}] (or unbatched "
                f"[{H}, {V}, {F}]); got {history.shape}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        n_bc = m["n_bc_features"]
        if n_bc > 0:
            if bc is None:
                raise ValueError(
                    f"artifact requires boundary conditions "
                    f"[B, n_steps, {m['n_input_k']}, {V}, {n_bc}]")
            bc = np.asarray(bc, np.float32)
            if squeeze and bc.ndim == 4:
                bc = bc[None]
            want = (history.shape[0], n_steps, m["n_input_k"], V, n_bc)
            if bc.shape != want:
                raise ValueError(f"bc must be {want}; got {bc.shape}")
        elif bc is not None:
            raise ValueError("artifact takes no boundary conditions")
        return history, bc, squeeze

    def _scale_history(self, history):
        if self.scaler is None:
            return history
        return np.asarray(self.scaler.transform(history), np.float32)

    def _scale_bc(self, bc):
        if bc is None or self.scaler_bc is None:
            return bc
        return np.asarray(self.scaler_bc.transform(bc), np.float32)

    def _run_blocks(self, hist_scaled: np.ndarray, bc_scaled,
                    n_steps: int) -> np.ndarray:
        """hist [B, H, V, F] scaled -> preds (scaled) [B, n_steps, n_out, V,
        F], or [M, B, n_steps, n_out, V, F] for ensemble artifacts (every
        member starts from the same history)."""
        m = self.meta
        bs, block, M = m["batch_size"], m["block_size"], self.n_members
        batch_axis = 1 if M else 0
        B = hist_scaled.shape[0]
        if B > bs:
            outs = [self._run_blocks(hist_scaled[i:i + bs],
                                     None if bc_scaled is None
                                     else bc_scaled[i:i + bs], n_steps)
                    for i in range(0, B, bs)]
            return np.concatenate(outs, axis=batch_axis)
        pad = bs - B
        if pad:
            hist_scaled = np.concatenate(
                [hist_scaled, np.repeat(hist_scaled[-1:], pad, axis=0)])
        n_blocks = -(-n_steps // block)
        dev = self.rollout.device
        if bc_scaled is not None:
            total = n_blocks * block
            if bc_scaled.shape[1] < total:   # hold last BC for the remainder
                extra = np.repeat(bc_scaled[:, -1:],
                                  total - bc_scaled.shape[1], axis=1)
                bc_scaled = np.concatenate([bc_scaled, extra], axis=1)
            if pad:
                bc_scaled = np.concatenate(
                    [bc_scaled, np.repeat(bc_scaled[-1:], pad, axis=0)])
            bc_scaled = torch.as_tensor(bc_scaled, device=dev)
        hist = torch.as_tensor(hist_scaled, device=dev)
        if M:   # the analysis state, every member's carry
            hist = hist[None].expand((M,) + hist.shape).contiguous()
        chunks = []
        for b in range(n_blocks):
            if bc_scaled is None:
                hist, preds = self.rollout.call(hist)
            else:
                hist, preds = self.rollout.call(
                    hist, bc_scaled[:, b * block:(b + 1) * block])
            chunks.append(preds)
        preds = torch.cat(chunks, dim=batch_axis + 1).cpu().numpy()
        if M:
            return preds[:, :B, :n_steps]
        return preds[:B, :n_steps]

    def predict(self, history, n_steps: int, bc=None,
                scaled: bool = False) -> np.ndarray:
        """Forecast `n_steps` AR steps from `history`.

        history: [B, H, V, F_dyn] (or unbatched [H, V, F_dyn]) in physical
        units (scaled=True if already scaled); bc: [B, n_steps, n_input_k,
        V, F_bc] when the rollout uses boundary conditions. Returns
        [B, n_steps, n_out, V, F_dyn] in physical units (batch axis squeezed
        for an unbatched input)."""
        history, bc, squeeze = self._validate(history, bc, n_steps)
        if not scaled:
            history = self._scale_history(history)
            bc = self._scale_bc(bc)
        preds = self._run_blocks(history, bc, n_steps)
        if not scaled and self.scaler is not None:
            preds = np.asarray(self.scaler.inverse_transform(preds),
                               np.float32)
        if not squeeze:
            return preds
        return preds[:, 0] if self.n_members else preds[0]

    @staticmethod
    def summarize(members: np.ndarray, axis: int = 0) -> dict:
        """Ensemble member reductions: mean, median and spread (std over
        members)."""
        members = np.asarray(members)
        ddof = 1 if members.shape[axis] > 1 else 0
        return {"mean": members.mean(axis=axis),
                "median": np.median(members, axis=axis),
                "spread": members.std(axis=axis, ddof=ddof)}

    def leadtimes(self, n_steps: int) -> np.ndarray:
        """Leadtimes [n_steps, n_out]: hours when timestep_hours is known,
        timestep units otherwise."""
        m = self.meta
        steps = (np.arange(n_steps)[:, None] * m["forecast_cycle"]
                 + np.asarray(m["output_k"])[None, :])
        th = m.get("timestep_hours")
        return steps * th if th else steps

    def submit(self, history, n_steps: int, bc=None) -> Future:
        """Enqueue one unbatched request; concurrent requests are coalesced
        into a single padded device batch. The Future resolves to what
        `predict(history, n_steps, bc)` returns."""
        history, bc, squeeze = self._validate(history, bc, n_steps)
        if not squeeze and history.shape[0] != 1:
            raise ValueError("submit() takes single-sample requests; "
                             "use predict() for batches")
        fut: Future = Future()
        req = _Request(history, bc, n_steps, fut)
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.append(req)
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._drain,
                                                daemon=True)
                self._worker.start()
        return fut

    def _drain(self):
        bs = self.meta["batch_size"]
        while True:
            deadline = time.monotonic() + self.max_batch_delay_s
            while True:
                with self._lock:
                    n = len(self._queue)
                if n >= bs or time.monotonic() >= deadline:
                    break
                time.sleep(self.max_batch_delay_s / 10)
            with self._lock:
                batch, self._queue = self._queue[:bs], self._queue[bs:]
                if not batch:
                    self._worker = None
                    return
            try:
                n_steps = max(r.n_steps for r in batch)
                hist = self._scale_history(
                    np.concatenate([r.history for r in batch]))
                bc = None
                if self.meta["n_bc_features"] > 0:
                    bc = self._scale_bc(np.concatenate(
                        [self._pad_bc(r.bc, n_steps) for r in batch]))
                preds = self._run_blocks(hist, bc, n_steps)
                if self.scaler is not None:
                    preds = np.asarray(
                        self.scaler.inverse_transform(preds), np.float32)
                for i, r in enumerate(batch):
                    r.future.set_result(
                        preds[:, i, :r.n_steps] if self.n_members
                        else preds[i, :r.n_steps])
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    @staticmethod
    def _pad_bc(bc, n_steps):
        if bc.shape[1] >= n_steps:
            return bc
        extra = np.repeat(bc[:, -1:], n_steps - bc.shape[1], axis=1)
        return np.concatenate([bc, extra], axis=1)

    def close(self):
        with self._lock:
            self._closed = True
