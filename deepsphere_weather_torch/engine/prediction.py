"""Autoregressive prediction engine (xforecasting.AutoregressivePredictions
parity).

Port of `deepsphere_weather_tpu/engine/prediction.py`. Runs the block
rollout of `engine/step.py` (`make_rollout_block`) from explicit
`forecast_reference_times`, inverse-scales, rounds, and streams the
results to a forecast zarr store with dims (forecast_reference_time,
leadtime, node) per variable, default chunks {frt: 1, leadtime: 1,
node: -1}: the same arrays and attributes as the JAX package's store, so
either package's verifier reads either store. `ar_blocks` bounds device
and host memory for long rollouts.

Each block's predictions come to the host with a synchronous `.cpu()` on
the rollout's thread before the next block is queued, so the next block
cannot overwrite them; a writer thread inverse-scales, rounds and
compresses them into the store (and the RAM buffer of `keep_in_memory`)
while the card computes the next block.

`perturbation` perturbs a member of an ensemble as the JAX package does:
one smooth analysis-error field per reference time on the input history
and an independent model-error field on every step's prediction (the
rollout's `noise_block`), drawn from numpy's generator in the JAX order,
so both packages perturb identically.

A BatchNorm model predicts in eval mode with the `norm_state` it is given
(its running statistics from training, or `prob.bn.bn_update`'s for
sampled weights); without one it normalizes with each batch's statistics
and warns, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.ar import ARIndexer
from ..data.dataset import SphericalDataset
from ..data.zarrstore import ZarrGroup, create_group
from .step import keep_first_feedback, make_rollout_block

__all__ = ["AutoregressivePredictions", "ForecastDataset",
           "make_bc_reader", "rechunk_forecasts_for_verification"]


class _InMemoryArray:
    """ndarray with a zarr-array face (`.chunks`, `[...]` reads).

    Backs ForecastDataset.variables when the rollout kept its output in
    host RAM: verification then tiles straight out of memory instead of
    decompressing the forecast store a second time. The advertised node chunk mirrors the ~4 MB heuristic of
    `rechunk_forecasts_for_verification` so the verifier's tile sizing
    behaves identically either way."""

    def __init__(self, arr: np.ndarray, chunks):
        self._arr = arr
        self.chunks = tuple(chunks)
        self.shape = arr.shape
        self.dtype = arr.dtype

    def __getitem__(self, idx):
        return self._arr[idx]


class ForecastDataset:
    """Forecast store: per-variable [frt, leadtime, node] + coords."""

    def __init__(self, group: ZarrGroup, memory: Optional[Dict] = None):
        self.group = group
        self.feature_order = group.attrs["feature_order"]
        self.variables = {n: group[n] for n in self.feature_order}
        self.forecast_reference_time = np.asarray(
            group["forecast_reference_time"][...]).view("datetime64[ns]")
        self.leadtime_hours = np.asarray(group["leadtime"][...])
        self.lat = np.asarray(group["lat"][...])
        self.lon = np.asarray(group["lon"][...])
        self.in_memory = memory is not None
        if memory is not None:
            n_frt, L = len(self.forecast_reference_time), len(
                self.leadtime_hours)
            node_chunk = max(1, int(4e6 // max(n_frt * L * 4, 1)))
            self.variables = {
                n: _InMemoryArray(memory[n], (n_frt, L, node_chunk))
                for n in self.feature_order}

    @classmethod
    def open(cls, path) -> "ForecastDataset":
        return cls(ZarrGroup(path))

    @property
    def n_frt(self):
        return len(self.forecast_reference_time)

    @property
    def n_leadtime(self):
        return len(self.leadtime_hours)

    def read_leadtime(self, lt_index: int) -> np.ndarray:
        """-> [n_frt, node, feature] for one leadtime."""
        out = np.stack([self.variables[n][:, lt_index, :]
                        for n in self.feature_order], axis=-1)
        return out

    def valid_time(self, lt_index: int) -> np.ndarray:
        # second resolution: float .astype('timedelta64[h]') TRUNCATES
        # (0.5h -> 0h), silently misaligning sub-hourly verification
        lt = np.round(self.leadtime_hours[lt_index] * 3600.0)
        return self.forecast_reference_time + lt.astype("timedelta64[s]")


def leadtime_slots(lead_offsets, keep_first_prediction: bool):
    """Map flat (iteration, output) indices to unique store leadtime slots.

    Returns (unique_offsets sorted, {flat_index: slot}) where only the
    chosen occurrence of each duplicated offset gets a slot: the earliest
    iteration's when keep_first_prediction, the latest's otherwise
    (reference keep_first_prediction semantics, SURVEY.md §2.9)."""
    uniq_offsets = np.unique(lead_offsets)
    slot_of_offset = {int(o): s for s, o in enumerate(uniq_offsets)}
    chosen: dict = {}
    for flat, off in enumerate(lead_offsets):
        if keep_first_prediction:
            chosen.setdefault(int(off), flat)
        else:
            chosen[int(off)] = flat
    return uniq_offsets, {flat: slot_of_offset[off]
                          for off, flat in chosen.items()}


def make_bc_reader(data_dynamic, data_bc, bc_generator=None, scaler_bc=None):
    """Build `read_bc(t0, offs) -> [n_in, V, F_bc]` for rollout loops.

    Reads `data_bc` where it covers the absolute offsets, calls
    `bc_generator(times)` beyond it; without a generator the last
    available BC is held with a LOUD one-time warning (a silent clip
    froze seasonal forcing for multi-year runs). `scaler_bc` transforms
    the result the same way the training loader did. Shared by
    AutoregressivePredictions and prob.ensemble_rollout_predictions."""
    dt = data_dynamic.timestep
    warned = [False]

    def read_bc(t0, offs):
        t_in = t0 + offs
        in_range = (data_bc is not None and t_in[0] >= 0
                    and t_in[-1] < data_bc.n_time)
        times = data_dynamic.time[t0] + offs * dt

        def _scaled(bc_vals):
            if scaler_bc is None:
                return bc_vals
            return np.asarray(scaler_bc.transform(bc_vals, time=times),
                              dtype=np.float32)

        if in_range:
            return _scaled(data_bc.read_stacked(t_in))
        if bc_generator is None:
            if not warned[0]:
                warned[0] = True
                import warnings
                warnings.warn(
                    f"rollout needs boundary conditions at dataset offsets "
                    f"up to {t_in.max()} but data_bc covers 0.."
                    f"{data_bc.n_time - 1 if data_bc is not None else -1}: "
                    f"holding the last available BC beyond the store. For "
                    f"long free runs pass bc_generator (e.g. analytic TOA "
                    f"solar) — frozen forcing drifts seasonally.",
                    stacklevel=3)
            return _scaled(data_bc.read_stacked(
                np.clip(t_in, 0, data_bc.n_time - 1)))
        return _scaled(np.asarray(bc_generator(times), dtype=np.float32))

    return read_bc


def AutoregressivePredictions(
    model,
    *,
    norm_state: Optional[Dict[str, torch.Tensor]] = None,
    data_dynamic: SphericalDataset,
    data_bc: Optional[SphericalDataset] = None,
    bc_generator=None,
    data_static=None,
    scaler=None,
    scaler_bc=None,
    # AR settings
    input_k,
    output_k,
    forecast_cycle,
    ar_iterations: int,
    stack_most_recent_prediction: bool = True,
    forecast_reference_times=None,
    batch_size: int = 16,
    ar_blocks: Optional[int] = None,
    keep_first_prediction: bool = True,
    rounding: Optional[int] = None,
    zarr_fpath=None,
    chunks: Optional[Dict] = None,
    # store codec for the forecast variables ("zlib" default; "blosc:zstd"
    # matches the reference's prediction stores — xforecasting
    # AutoregressivePredictions' `compressor` arg, SURVEY.md §2.9)
    compressor: Optional[str] = "zlib",
    # also keep the (inverse-scaled) forecasts in host RAM and serve the
    # returned dataset from there: downstream rechunk/verify then run
    # without re-reading the store. Falls back to store-backed when the
    # raw buffer would exceed DSW_VERIF_RAM_BYTES (default 16 GB) or half
    # of free RAM.
    keep_in_memory: bool = False,
    # ensemble-calibration perturbations: dict with
    #   basis      [V, n_modes] unit-pointwise-variance spatial basis
    #              (data.toy.perturbation_basis)
    #   ic_sigma   [F] per-variable analysis-error std (SCALED space):
    #              one smooth field per reference time added to the whole
    #              input history (perturbed-analysis member)
    #   step_sigma [F] per-variable stochastic model-error std (SCALED
    #              space): an independent smooth field added to every AR
    #              step's prediction before feedback (y = f(x) + eps)
    #   seed       int (vary per member)
    perturbation: Optional[Dict] = None,
    verbose: bool = False,
) -> ForecastDataset:
    """Roll out forecasts; returns the (streamed) ForecastDataset.

    `bc_generator(times) -> [T, V, F_bc]` supplies boundary conditions for
    times outside `data_bc` (xforecasting's bc_generator parity,
    SURVEY.md §2.9) — multi-year free runs outlive the BC store; TOA solar
    is analytic (data.toy.toa_solar_radiation). Without a generator, a
    rollout that outruns the BC data holds the last value and warns
    loudly (frozen forcing drifts seasonally). `scaler_bc` transforms BC
    the same way the training loader did.

    `keep_first_prediction`: when output windows overlap across AR
    iterations the same leadtime is predicted more than once; the store
    keeps the FIRST (earliest-iteration) prediction per leadtime by
    default, or the most recent one when False (reference flag,
    dev/w_debug_predictions.py:318-348).

    The model runs on its own device; the forecast is in the store (and in
    RAM with `keep_in_memory`) on return.
    """
    # Note: ar_iterations here = number of AR steps to roll (prediction
    # horizon), independent of the training value (reference: AR=6 train /
    # AR=20 predict, train_predict_state.py:484).
    indexer = ARIndexer.build(input_k, output_k, forecast_cycle, ar_iterations,
                              stack_most_recent_prediction)
    n_steps = ar_iterations + 1
    if ar_blocks is None or ar_blocks > n_steps:
        ar_blocks = n_steps
    # keep-first feedback threads its written-mask across blocks (part of
    # the rollout state), so ar_blocks memory-bounding works there too
    keep_first = keep_first_feedback(indexer)
    # prediction feasibility: every future input time must be produced by
    # an earlier iteration's output (see engine/step.py rolling buffer).
    # Checked over the FULL horizon with a running produced-offset set
    # (a truncated check let configs whose first infeasible input sits
    # past the truncation produce silently stale forecasts).
    produced = set()
    min_out = min(indexer.output_k)
    for i in range(1, n_steps):
        for ok in indexer.output_k:
            produced.add((i - 1) * indexer.forecast_cycle + ok)
        for k in indexer.input_k:
            off = i * indexer.forecast_cycle + k
            if off >= min_out and off not in produced:
                raise ValueError(
                    f"AR settings infeasible: input offset {off} at "
                    f"iteration {i} is never predicted")

    # --- forecast reference times ---------------------------------------
    if forecast_reference_times is None:
        pos = indexer.valid_reference_positions(data_dynamic.n_time, 0)
        t0s = pos
    else:
        t0s = indexer.reference_positions_for_times(
            data_dynamic.time, forecast_reference_times)
    frts = data_dynamic.time[t0s]

    dt = data_dynamic.timestep
    dt_hours = dt / np.timedelta64(1, "h")
    lead_offsets = np.concatenate(
        [i * indexer.forecast_cycle + np.asarray(indexer.output_k)
         for i in range(n_steps)])
    # overlapping output windows predict some leadtimes more than once;
    # the store holds each leadtime ONCE — keep_first_prediction picks
    # which (iteration, output) occurrence lands there
    uniq_offsets, write_slot = leadtime_slots(lead_offsets,
                                              keep_first_prediction)
    leadtime_hours = uniq_offsets * dt_hours
    n_out = len(indexer.output_k)
    L = len(uniq_offsets)
    V = data_dynamic.n_node
    F = data_dynamic.n_feature

    # --- output store -----------------------------------------------------
    if zarr_fpath is None:
        raise ValueError("zarr_fpath is required")
    if chunks is None:
        chunks = {"forecast_reference_time": 1, "leadtime": 1, "node": -1}
    cf = chunks.get("forecast_reference_time", 1)
    cl = chunks.get("leadtime", 1)
    cn = chunks.get("node", -1)
    cn = V if cn in (-1, None) else cn
    cf = len(frts) if cf in (-1, None) else cf
    cl = L if cl in (-1, None) else cl
    g = create_group(zarr_fpath, overwrite=True,
                     attrs={"feature_order": list(data_dynamic.feature_order)})
    for name in data_dynamic.feature_order:
        g.create_array(name, shape=(len(frts), L, V), chunks=(cf, cl, cn),
                       dtype=np.float32, compressor=compressor)
    a = g.create_array("forecast_reference_time", shape=(len(frts),),
                       chunks=(len(frts),), dtype=np.int64, compressor=None)
    a[...] = np.asarray(frts, dtype="datetime64[ns]").view(np.int64)
    a = g.create_array("leadtime", shape=(L,), chunks=(L,), dtype=np.float64,
                       compressor=None,
                       attrs={"units": "hours"})
    a[...] = leadtime_hours
    for cname, cval in (("lat", data_dynamic.lat), ("lon", data_dynamic.lon)):
        c = g.create_array(cname, shape=(V,), chunks=(V,), dtype=np.float64,
                           compressor=None)
        c[...] = cval

    # --- rollout ----------------------------------------------------------
    device = next(model.parameters()).device
    static = (torch.from_numpy(data_static.read_stacked()).to(device)
              if data_static is not None else None)
    if getattr(model, "has_batch_norm", False) and not norm_state:
        import warnings

        warnings.warn(
            "model has BatchNorm but no norm_state was given: predictions "
            "will normalize with per-batch statistics (torch train-mode "
            "behavior). Pass norm_state=prob.bn.bn_update(...) for "
            "eval-mode parity.")
    rollout_fn, H = make_rollout_block(model, indexer, ar_blocks,
                                       norm_state=norm_state)
    # the last block may be shorter: without BC the block length is the
    # function's, so a tail-sized one avoids running (and discarding) up
    # to ar_blocks-1 model evaluations per batch
    tail = n_steps % ar_blocks
    tail_fn = (make_rollout_block(model, indexer, tail,
                                  norm_state=norm_state)[0]
               if 0 < tail < ar_blocks and n_steps > ar_blocks else None)
    min_k = min(indexer.input_k)
    out_arrays = {name: g[name] for name in data_dynamic.feature_order}
    _read_bc = make_bc_reader(data_dynamic, data_bc, bc_generator, scaler_bc)

    basis = ic_sigma = step_sigma = perturb_rng = None
    if perturbation is not None:
        perturb_rng = np.random.default_rng(int(perturbation.get("seed", 0)))
        basis = np.asarray(perturbation["basis"], np.float32)     # [V, M]
        if perturbation.get("ic_sigma") is not None:
            ic_sigma = np.asarray(perturbation["ic_sigma"], np.float32)
        if perturbation.get("step_sigma") is not None:
            step_sigma = np.asarray(perturbation["step_sigma"], np.float32)
    n_hist_filled = min(indexer.output_k) - min_k

    mem: Optional[Dict[str, np.ndarray]] = None
    if keep_in_memory:
        import os

        from ..data.loader import AutoregressiveDataset

        need = len(frts) * L * V * F * 4
        # default 16 GB: the HEALPix-64 flagship protocol's buffer is
        # ~10.8 GB (1312 frts x 21 leads x 49152 nodes x 2 vars fp32); the
        # free-RAM/2 cap below still protects small hosts
        budget = int(float(os.environ.get("DSW_VERIF_RAM_BYTES", 16e9)))
        free = AutoregressiveDataset._available_memory_bytes()
        if free is not None:
            budget = min(budget, free // 2)
        if need <= budget:
            mem = {name: np.empty((len(frts), L, V), np.float32)
                   for name in data_dynamic.feature_order}
        elif verbose:
            print(f"keep_in_memory: forecast buffer {need / 1e9:.1f} GB "
                  f"exceeds budget {budget / 1e9:.1f} GB — store-backed")

    # --- async writer: inverse scaling and zlib zarr writes run on a
    # background thread so they overlap the next block's device compute.
    # A depth-2 bounded queue caps host memory at two blocks in flight.
    import queue
    import threading

    def write_block(preds_np, lo, B, step0, steps):
        # inverse scale + round + write (unchanged semantics)
        for j in range(steps):
            i = step0 + j
            for oi, ok in enumerate(indexer.output_k):
                flat = i * n_out + oi
                lt_index = write_slot.get(flat)
                if lt_index is None:
                    continue      # a different iteration owns this leadtime
                block = preds_np[:, j, oi]            # [B, V, F]
                if scaler is not None:
                    # per-sample valid times (time-group scalers need them)
                    t_valid = (frts[lo: lo + B]
                               + (lead_offsets[flat] * dt))
                    block = scaler.inverse_transform(block, time=t_valid)
                if rounding is not None:
                    block = np.round(block, rounding)
                for f, name in enumerate(data_dynamic.feature_order):
                    # int index normalizes to a size-1 slice in the store
                    out_arrays[name][lo: lo + B, lt_index, :] = (
                        block[:, None, :, f])
                    if mem is not None:
                        mem[name][lo: lo + B, lt_index, :] = block[:, :, f]

    wq = queue.Queue(maxsize=2)
    werr = []

    def writer():
        while True:
            item = wq.get()
            if item is None:
                return
            try:
                write_block(*item)
            except Exception as e:     # surfaced after join
                werr.append(e)

    wthread = threading.Thread(target=writer, daemon=True)
    wthread.start()

    try:
        with torch.inference_mode():
            for lo in range(0, len(t0s), batch_size):
                sel = t0s[lo: lo + batch_size]
                B = len(sel)
                # init history: truth (scaled) at offsets [min_k, max_out]
                hist = np.zeros((B, H, V, F), dtype=np.float32)
                for b, t0 in enumerate(sel):
                    t_hist = np.arange(t0 + min_k, t0 + min(indexer.output_k))
                    vals = data_dynamic.read_stacked(t_hist)
                    if scaler is not None:
                        vals = scaler.transform(
                            vals,
                            time=data_dynamic.time[t_hist]).astype(np.float32)
                    hist[b, : len(t_hist)] = vals
                if ic_sigma is not None:
                    # one smooth analysis-error field per reference time,
                    # added to every input history step (scaled space)
                    coeff = perturb_rng.standard_normal(
                        (B, basis.shape[1], F)).astype(np.float32)
                    field = np.einsum("vm,bmf->bvf", basis, coeff) * ic_sigma
                    hist[:, :n_hist_filled] += field[:, None]
                hist = torch.from_numpy(hist).to(device)
                wmask = (torch.zeros(H, dtype=torch.bool, device=device)
                         if keep_first else None)

                n_blocks = (n_steps + ar_blocks - 1) // ar_blocks
                step0 = 0
                for blk in range(n_blocks):
                    steps = min(ar_blocks, n_steps - step0)
                    fn = (tail_fn
                          if (tail_fn is not None and steps < ar_blocks)
                          else rollout_fn)
                    # bc for iterations [step0, step0+steps)
                    bc_block = None
                    if data_bc is not None or bc_generator is not None:
                        in_offs = np.asarray(indexer.input_k)
                        bc_rows = [
                            _read_bc(t0, (step0 + j) * indexer.forecast_cycle
                                     + in_offs)
                            for b, t0 in enumerate(sel) for j in range(steps)]
                        n_fb = bc_rows[0].shape[-1]
                        bc_np = np.asarray(bc_rows, dtype=np.float32).reshape(
                            B, steps, len(indexer.input_k), V, n_fb)
                        bc_block = torch.from_numpy(bc_np).to(device)
                    noise_block = None
                    if step_sigma is not None:
                        # an independent model-error field per step, added
                        # before feedback (engine/step.py)
                        coeff = perturb_rng.standard_normal(
                            (B, steps, n_out, basis.shape[1], F)
                        ).astype(np.float32)
                        noise_block = torch.from_numpy(np.ascontiguousarray(
                            np.einsum("vm,bsomf->bsovf", basis, coeff)
                            * step_sigma)).to(device)
                    hist, wmask, preds = fn(hist, wmask, bc_block, static,
                                            noise_block)
                    # the host copy, before the next block is queued
                    wq.put((preds[:, :steps].cpu().numpy(), lo, B, step0,
                            steps))
                    if werr:
                        raise werr[0]
                    step0 += steps
                if verbose:
                    print(f"predicted frts {lo}..{lo + B - 1} / {len(t0s)}")
    finally:
        wq.put(None)
        wthread.join()
    if werr:
        raise werr[0]

    return ForecastDataset(g, memory=mem)


def rechunk_forecasts_for_verification(forecast: ForecastDataset, target_store,
                                       node_chunk: Optional[int] = None,
                                       compressor: Optional[str] = None
                                       ) -> ForecastDataset:
    """Space-chunked copy for verification access patterns
    (xforecasting.rechunk_forecasts_for_verification parity,
    train_predict_state.py:505-510).

    node_chunk=None sizes chunks to ~4 MB (all times for a node BLOCK):
    the reference's literal {node: 1} layout explodes into ~100k tiny
    zlib chunks at HEALPix-64+ (measured ~115 chunk-writes/s), while a
    node block keeps both per-node reads (one chunk) and per-leadtime
    reads (V/block chunks) cheap. Pass node_chunk=1 for the literal
    reference layout.

    compressor=None picks blosc-lz4 when libblosc is loadable (5-6x the
    single-core write throughput of zlib on this data), zlib otherwise.
    With an in-memory source forecast (keep_in_memory rollout) this pass
    is WRITE-only — no store read-back — which together with the faster
    codec removes most of the rechunk's cost.
    """
    if compressor is None:
        from ..native import bloscio
        compressor = "blosc:lz4" if bloscio.available() else "zlib"
    g = create_group(target_store, overwrite=True,
                     attrs={"feature_order": forecast.feature_order})
    n_frt, L = forecast.n_frt, forecast.n_leadtime
    V = len(forecast.lat)
    if node_chunk is None:
        node_chunk = max(1, int(4e6 // max(n_frt * L * 4, 1)))
    for name in forecast.feature_order:
        arr = g.create_array(name, shape=(n_frt, L, V),
                             chunks=(n_frt, L, max(node_chunk, 1)),
                             dtype=np.float32, compressor=compressor)
        arr[...] = forecast.variables[name][...]
    for cname in ("forecast_reference_time", "leadtime", "lat", "lon"):
        src = forecast.group[cname]
        a = g.create_array(cname, shape=src.shape, chunks=src.shape,
                           dtype=src.dtype, compressor=None,
                           attrs=src.attrs)
        a[...] = src[...]
    return ForecastDataset(g)
