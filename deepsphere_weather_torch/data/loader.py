"""Autoregressive dataset + prefetching loader (host side).

The port's copy of `deepsphere_weather_tpu/data/loader.py` (numpy only):
`AutoregressiveDataset` maps the dataset time axis to AR training
samples and keeps a pre-scaled mirror of the whole period in host RAM
when it fits; `AutoregressiveDataLoader` assembles batches in a thread
pool with a bounded prefetch queue, in the order
`np.random.default_rng(shuffle_seed + epoch)` gives, so the same seed
gives the same batches in both packages. Its `transfer` hook (e.g.
`parallel.shard_batch` or a copy to the card) runs in the pool workers,
so the upload overlaps the consumer's steps.

Batch dict layout (consumed by engine/):
- 'dynamic' : [B, W, V, F_dyn]  scaled truth window (W = indexer window)
- 'bc'      : [B, W, V, F_bc]   boundary conditions, scaled when a
  scaler_bc is given (or None)
- 'static'  : [V, F_static]     static features (or None)
- 'window_time' : [B, W] int64 ns timestamps
- 'forecast_start_time' : [B] int64 ns (first output time of iteration 0)
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .ar import ARIndexer

__all__ = ["AutoregressiveDataset", "AutoregressiveDataLoader"]


class AutoregressiveDataset:
    """AR samples over (dynamic, bc, static) datasets.

    Mirrors xforecasting.AutoregressiveDataset: `update_AR_iterations`
    mutates the usable sample set mid-training
    (reference: dev/w_debug_dataloader.py:486-516);
    `subset_reference_positions` restricts reference times (prediction
    mode lives in engine.AutoregressivePredictions, so the reference's
    training_mode flag has no equivalent here).
    """

    def __init__(self, data_dynamic, indexer: ARIndexer,
                 data_bc=None, data_static=None, scaler=None,
                 scaler_bc=None,
                 subset_reference_positions: Optional[np.ndarray] = None,
                 preload="auto"):
        self.data_dynamic = data_dynamic
        self.data_bc = data_bc
        self.data_static = data_static
        self.scaler = scaler
        self.scaler_bc = scaler_bc
        self.indexer = indexer
        self.current_ar_iterations = indexer.ar_iterations
        self._subset = subset_reference_positions
        self._static_cache = (data_static.read_stacked()
                              if data_static is not None else None)
        self._refresh_positions()
        # In-RAM pre-scaled mirror: scale ONCE per timestep instead of
        # once per window (stride-1 AR windows re-transform every timestep
        # ~W times), and let the loader gather whole batches with one
        # fancy-index. Cuts host batch-assembly from ~20 ms to ~2 ms at
        # HEALPix-16 — the producer-side cost that was pacing training.
        # 'auto' preloads when the scaled mirror fits DSW_PRELOAD_BYTES
        # (default 6 GB; a too-small cap silently demotes HEALPix-64
        # multi-year runs to the slow streaming loader); big stores
        # (HEALPix-64 ERA5 is ~30 GB) fall back to windowed reads through
        # the decompressed-chunk cache.
        self._mirror = None
        if preload is True or preload == "auto":
            import os
            budget = int(os.environ.get("DSW_PRELOAD_BYTES", 6 << 30))
            # never claim more than half of what the host actually has
            # free right now: the 6 GB default would swap/OOM smaller
            # hosts that previously fell back to windowed streaming
            avail = self._available_memory_bytes()
            if avail is not None:
                budget = min(budget, avail // 2)
            nbytes = (data_dynamic.n_time * data_dynamic.n_node
                      * data_dynamic.n_feature * 4)
            if data_bc is not None:
                nbytes += (data_bc.n_time * data_bc.n_node
                           * data_bc.n_feature * 4)
            if preload is True or nbytes <= budget:
                self._build_mirror()
            elif preload == "auto":
                import warnings
                warnings.warn(
                    f"preload='auto': pre-scaled mirror ({nbytes / 1e9:.1f} "
                    f"GB) exceeds the budget ({budget / 1e9:.1f} GB = "
                    "min(DSW_PRELOAD_BYTES, half of free RAM)) — using the "
                    "windowed streaming reader", stacklevel=2)

    @staticmethod
    def _available_memory_bytes():
        """MemAvailable from /proc/meminfo (Linux); None if unreadable."""
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        return int(line.split()[1]) * 1024
        except (OSError, ValueError, IndexError):
            return None
        return None

    def _build_mirror(self):
        t_all = np.arange(self.data_dynamic.n_time)
        times = self.data_dynamic.time[t_all]
        dyn = self.data_dynamic.read_stacked(t_all).astype(np.float32)
        if self.scaler is not None:
            dyn = np.asarray(self.scaler.transform(dyn, time=times),
                             dtype=np.float32)
        bc = None
        if self.data_bc is not None:
            bc = self.data_bc.read_stacked(t_all).astype(np.float32)
            if self.scaler_bc is not None:
                bc = np.asarray(self.scaler_bc.transform(bc, time=times),
                                dtype=np.float32)
        self._mirror = (dyn, bc,
                        np.asarray(times, dtype="datetime64[ns]")
                        .view(np.int64))

    def _refresh_positions(self):
        if self._subset is not None:
            self.reference_positions = np.asarray(self._subset, dtype=np.int64)
        else:
            self.reference_positions = self.indexer.valid_reference_positions(
                self.data_dynamic.n_time, self.current_ar_iterations)

    def update_AR_iterations(self, n: int):
        if n > self.indexer.ar_iterations:
            raise ValueError(
                f"cannot grow beyond indexer max {self.indexer.ar_iterations}")
        self.current_ar_iterations = int(n)
        self._refresh_positions()

    def __len__(self) -> int:
        return len(self.reference_positions)

    # ------------------------------------------------------------------
    def get_batch(self, idx) -> Optional[Dict[str, np.ndarray]]:
        """Vectorized gather of a whole batch from the preloaded mirror
        (one fancy-index per field instead of per-sample reads + np.stack).
        Returns None when no mirror is loaded."""
        if self._mirror is None:
            return None
        t0s = self.reference_positions[np.asarray(idx, dtype=np.int64)]
        t_idx = np.clip(t0s[:, None] + self.indexer.rel_offsets[None, :],
                        0, self.data_dynamic.n_time - 1)   # [B, W]
        dyn_all, bc_all, time_ns = self._mirror
        batch = {"dynamic": dyn_all[t_idx], "window_time": time_ns[t_idx]}
        if bc_all is not None:
            batch["bc"] = bc_all[t_idx]
        return batch

    def get_sample(self, i: int) -> Dict[str, np.ndarray]:
        t0 = int(self.reference_positions[i])
        # The window is sized for the indexer's MAX AR iterations; positions
        # beyond current_ar_iterations are never read by the scan (its length
        # is current+1), so clamping keeps reduced-AR samples in-bounds.
        t_idx = np.clip(self.indexer.window_time_indices(t0), 0,
                        self.data_dynamic.n_time - 1)
        if self._mirror is not None:
            dyn_all, bc_all, time_ns = self._mirror
            out = {"dynamic": dyn_all[t_idx],
                   "window_time": time_ns[t_idx]}
            if bc_all is not None:
                out["bc"] = bc_all[t_idx]
            return out
        times = self.data_dynamic.time[t_idx]
        dyn = self.data_dynamic.read_stacked(t_idx)          # [W, V, Fd]
        if self.scaler is not None:
            dyn = self.scaler.transform(dyn, time=times).astype(np.float32)
        out = {"dynamic": dyn,
               "window_time": np.asarray(times, dtype="datetime64[ns]")
               .view(np.int64)}
        if self.data_bc is not None:
            bc = self.data_bc.read_stacked(t_idx).astype(np.float32)
            if self.scaler_bc is not None:
                bc = self.scaler_bc.transform(
                    bc, time=times).astype(np.float32)
            out["bc"] = bc
        return out

    @property
    def static(self) -> Optional[np.ndarray]:
        return self._static_cache

    # ---- device-resident-data support (consumed by engine/parallel) ----
    @property
    def has_mirror(self) -> bool:
        return self._mirror is not None

    def mirror_nbytes(self) -> int:
        """Bytes the pre-scaled mirror (+ static) occupies — the device
        memory cost of caching this dataset on device. 0 when no mirror
        was built."""
        if self._mirror is None:
            return 0
        dyn, bc, _ = self._mirror
        n = dyn.nbytes + (bc.nbytes if bc is not None else 0)
        if self._static_cache is not None:
            n += self._static_cache.nbytes
        return n

    def mirror_arrays(self):
        """(dynamic [T,V,Fd], bc [T,V,Fb]|None, static [V,Fs]|None) —
        the pre-scaled host arrays backing the mirror."""
        if self._mirror is None:
            raise ValueError("no pre-scaled mirror loaded (preload=False "
                             "or the store exceeded DSW_PRELOAD_BYTES)")
        dyn, bc, _ = self._mirror
        return dyn, bc, self._static_cache

    def window_indices(self, idx) -> np.ndarray:
        """[B, W] int32 absolute time indices for sample batch `idx` —
        exactly the rows get_batch would gather (same clamping)."""
        t0s = self.reference_positions[np.asarray(idx, dtype=np.int64)]
        return np.clip(t0s[:, None] + self.indexer.rel_offsets[None, :],
                       0, self.data_dynamic.n_time - 1).astype(np.int32)


class AutoregressiveDataLoader:
    """Batched iterator with shuffling and background prefetch.

    Mirrors the xforecasting loader options: batch_size, drop_last_batch, shuffle(+seed), num_workers (thread pool
    size), prefetch_factor (queue depth).
    """

    def __init__(self, dataset: AutoregressiveDataset, batch_size: int = 16,
                 shuffle: bool = True, shuffle_seed: int = 69,
                 drop_last_batch: bool = True, num_workers: int = 4,
                 prefetch_factor: int = 2,
                 autotune_num_workers: bool = False, epoch: int = 0,
                 transfer=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self.drop_last_batch = drop_last_batch
        self.num_workers = max(int(num_workers), 1)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        # host->device transfer (e.g. parallel.shard_batch) applied in the
        # pool workers so the upload overlaps the consumer's compute (the
        # reference's prefetch_in_gpu / asyncronous_gpu_transfer loader
        # options, utils_config.py:91-103)
        self._transfer = transfer
        # callers that rebuild the loader per epoch pass `epoch` so the
        # shuffle permutation (seeded shuffle_seed + epoch) actually
        # varies — otherwise every epoch trains the identical batch
        # order and drop_last_batch drops the SAME samples every time
        self._epoch = int(epoch)
        if autotune_num_workers:
            self.num_workers = self._autotune_num_workers()

    def _autotune_num_workers(self, candidates=(1, 2, 4, 8),
                              n_batches: int = 4) -> int:
        """Pick the thread count with the best measured batch-assembly
        throughput (reference flag: utils_config.py:100, plumbed at
        train_predict_state.py:413)."""
        import time

        batches = self._batch_indices()[:n_batches]
        if not batches:
            return self.num_workers
        # warm the page cache once so the first candidate isn't charged
        # for cold physical I/O the others then skip
        for idx in batches:
            self._assemble(idx)
        # always consider the configured value too (e.g. num_workers=16)
        cands = sorted(set(candidates) | {self.num_workers})
        best, best_t = self.num_workers, float("inf")
        for nw in cands:
            t0 = time.perf_counter()
            if nw <= 1:
                for idx in batches:
                    self._assemble(idx)
            else:
                with ThreadPoolExecutor(max_workers=nw) as pool:
                    list(pool.map(self._assemble, batches))
            dt = time.perf_counter() - t0
            if dt < best_t:
                best, best_t = nw, dt
        return best

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last_batch:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.shuffle_seed + self._epoch)
            rng.shuffle(order)
        batches = []
        for lo in range(0, n, self.batch_size):
            idx = order[lo: lo + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last_batch:
                continue
            batches.append(idx)
        return batches

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self.dataset.get_batch(idx)
        if batch is None:                      # no mirror: per-sample reads
            samples = [self.dataset.get_sample(int(i)) for i in idx]
            batch = {
                "dynamic": np.stack([s["dynamic"] for s in samples]),
                "window_time": np.stack([s["window_time"] for s in samples]),
            }
            if "bc" in samples[0]:
                batch["bc"] = np.stack([s["bc"] for s in samples])
        st = self.dataset.static
        if st is not None:
            batch["static"] = st
        # first output time of AR iteration 0
        pos0 = self.dataset.indexer.output_pos[0, 0]
        batch["forecast_start_time"] = batch["window_time"][:, pos0]
        return batch

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """Yield the epoch's sample-index batches (same shuffle/epoch
        semantics as __iter__) WITHOUT assembling arrays — the
        device-resident-data path gathers windows on device and only
        needs the indices."""
        batches = self._batch_indices()
        self._epoch += 1
        yield from batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        self._epoch += 1
        if self.num_workers <= 1 and self._transfer is None:
            for idx in batches:
                yield self._assemble(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def _put(item) -> bool:
            """Blocking put that still notices consumer shutdown (a plain
            q.put would block forever once the consumer stops draining,
            leaking the thread AND every batch it holds)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _job(idx):
            item = self._assemble(idx)
            if self._transfer is not None:
                # device upload in the pool worker, overlapped with the
                # consumer's step dispatch
                item = self._transfer(item)
            return item

        def producer():
            # bounded in-flight submission: eager submission of every
            # batch made prefetch_factor meaningless (the pool assembled
            # the whole epoch into memory ahead of the consumer)
            max_inflight = self.num_workers + self.prefetch_factor
            inflight: "deque" = deque()
            it = iter(batches)
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    while not stop.is_set():
                        while len(inflight) < max_inflight:
                            idx = next(it, None)
                            if idx is None:
                                break
                            inflight.append(pool.submit(_job, idx))
                        if not inflight:
                            break
                        try:
                            item = inflight.popleft().result()
                        except Exception as e:  # surface worker errors
                            item = e
                        if not _put(item) or isinstance(item, Exception):
                            return
                finally:
                    for fut in inflight:
                        fut.cancel()
            _put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=30)
