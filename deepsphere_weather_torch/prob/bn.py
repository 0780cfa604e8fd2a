"""BatchNorm running-statistics re-estimation (SWAG `bn_update`).

Port of `deepsphere_weather_tpu/prob/bn.py` (reference
modules/utils_swag.py:58-165): after SWAG weights are sampled, one pass
over the training period re-estimates every BatchNorm layer's running
mean and variance. Each batch runs the full AR loop (with the training
rollout's feedback, keep-first included), every model call's statistics
are collected (`stats_out`), and each call applies the batch's momentum
b / (n + b) in order (n the samples seen before it): a cumulative average
over batches. The statistics start from mean 0 / var 1 (the reference's
`reset_bn`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..data.ar import ARIndexer
from ..data.loader import AutoregressiveDataLoader, AutoregressiveDataset
from ..engine.step import _flat_stats, assemble_input, keep_first_feedback

__all__ = ["bn_update", "make_bn_stats_fn"]


def make_bn_stats_fn(model, indexer: ARIndexer, n_scan_iterations: int):
    """fn(batch) -> [{buffer name: tensor}] (one dict per AR iteration) of
    the model calls' batch statistics, following the training rollout
    (the model's predictions fed back; keep-first feedback as the loss
    does)."""
    in_pos = list(indexer.input_pos)
    out_pos = list(indexer.output_pos)
    keep_first = keep_first_feedback(indexer)

    @torch.no_grad()
    def stats_fn(batch: Dict) -> List[Dict[str, torch.Tensor]]:
        dyn = batch["dynamic"]
        bc = batch.get("bc")
        static = batch.get("static")
        dev = dyn.device
        buf = dyn
        written = torch.zeros(dyn.shape[1], dtype=torch.bool, device=dev)
        all_stats = []
        for i in range(n_scan_iterations):
            pin = torch.as_tensor(in_pos[i], dtype=torch.long, device=dev)
            pout = torch.as_tensor(out_pos[i], dtype=torch.long, device=dev)
            x = assemble_input(buf, bc, static, pin)
            stats: Dict = {}
            y = model(x, train=True, stats_out=stats)
            if keep_first:
                prev = buf.index_select(1, pout)
                wm = written[pout]
                y = torch.where(wm[None, :, None, None], prev, y)
                written = written.index_fill(0, pout, True)
            buf = buf.index_copy(1, pout, y)
            all_stats.append(_flat_stats(stats))
        return all_stats

    return stats_fn


@torch.no_grad()
def bn_update(model, *, data_dynamic,
              data_bc=None, data_static=None, scaler=None, scaler_bc=None,
              input_k, output_k, forecast_cycle, ar_iterations,
              batch_size: int = 16, max_batches: Optional[int] = None,
              num_workers: int = 2, verbose: bool = False
              ) -> Dict[str, torch.Tensor]:
    """One pass over `data_dynamic` re-estimating the BatchNorm running
    statistics of `model`'s parameters (load a sample into it first: the
    JAX package's `params` argument).

    Returns the statistics {buffer name: fp32 tensor on the model's
    device} ({} when the model has no BatchNorm); the model's buffers are
    left as they were. `max_batches` bounds the pass (the reference walks
    the whole training period)."""
    if not getattr(model, "has_batch_norm", False):
        return {}
    indexer = ARIndexer.build(input_k, output_k, forecast_cycle,
                              ar_iterations)
    ds = AutoregressiveDataset(data_dynamic, indexer, data_bc=data_bc,
                               data_static=data_static, scaler=scaler,
                               scaler_bc=scaler_bc)
    loader = AutoregressiveDataLoader(ds, batch_size=batch_size,
                                      shuffle=False, num_workers=num_workers)
    n_scan = indexer.ar_iterations + 1
    stats_fn = make_bn_stats_fn(model, indexer, n_scan)
    device = next(model.parameters()).device

    # the reference's reset_bn: running mean 0, var 1 (utils_swag.py:31-55)
    state = model.init_norm_state()
    n_seen = 0
    nb = 0
    for batch in loader:
        b = batch["dynamic"].shape[0]
        momentum = b / (n_seen + b)                # _get_momenta parity
        dev_batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()
                     if k in ("dynamic", "bc", "static") and v is not None}
        # every model call applies the batch's momentum, in the AR order
        for stats in stats_fn(dev_batch):
            for name, s in stats.items():
                state[name] = (1 - momentum) * state[name] + momentum * s
        n_seen += b
        nb += 1
        if max_batches is not None and nb >= max_batches:
            break
    if verbose:
        print(f"bn_update: {nb} batches, {n_seen} samples, "
              f"{n_scan} AR calls each")
    return state
