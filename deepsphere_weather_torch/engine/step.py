"""Block rollout for unbounded autoregressive prediction.

Port of `make_rollout_block` from `deepsphere_weather_tpu/engine/step.py`:
the carry is a rolling history buffer of the last H timesteps of
(predicted or observed) dynamic fields, H = max(output_k) - min(input_k) + 1.
Each step assembles the model input from fixed buffer positions (feature
order static + bc + dynamic), predicts, writes the prediction at its
output positions and rolls the buffer by `forecast_cycle`. `jax.lax.scan`
becomes a Python loop; the training steps and `noise_block` (stochastic
perturbations) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..data.ar import ARIndexer

__all__ = ["keep_first_feedback", "make_rollout_block"]


def keep_first_feedback(indexer: ARIndexer) -> bool:
    """True when the AR feedback must keep the FIRST prediction per slot
    (stack_most_recent_prediction=False with overlapping output windows)."""
    return (not indexer.stack_most_recent_prediction
            and indexer.has_overlapping_outputs)


def make_rollout_block(model, indexer: ARIndexer,
                       block_size: int) -> Tuple[Callable, int]:
    """Build the block-rollout function. Returns (rollout_fn, H).

    rollout_fn(hist, wmask, bc_block, static) ->
    (new_hist, new_wmask, preds [B, block, n_out, V, F]) with hist
    [B, H, V, F_dyn], bc_block [B, block, n_in, V, F_bc] or None (its
    length sets the block; `block_size` otherwise), static [V, F_static] or
    None. `wmask` is the keep-first written-mask: None unless
    keep_first_feedback(indexer); then start with torch.zeros(H, bool) and
    thread the returned mask into the next block.
    """
    fc = indexer.forecast_cycle
    min_k = min(indexer.input_k)
    max_out = max(indexer.output_k)
    H = max_out - min_k + 1
    in_pos = [k - min_k for k in indexer.input_k]
    out_pos = [k - min_k for k in indexer.output_k]
    keep_first = keep_first_feedback(indexer)

    @torch.inference_mode()
    def rollout(hist: torch.Tensor, wmask: Optional[torch.Tensor],
                bc_block: Optional[torch.Tensor],
                static: Optional[torch.Tensor]):
        if keep_first and wmask is None:
            raise ValueError(
                "this indexer keeps FIRST predictions "
                "(stack_most_recent_prediction=False with overlapping "
                "output_k): pass wmask=torch.zeros(H, dtype=torch.bool) for "
                "the first block and thread the returned mask across blocks")
        if not keep_first:
            wmask = None
        ip = torch.as_tensor(in_pos, device=hist.device)
        op = torch.as_tensor(out_pos, device=hist.device)
        n_steps = bc_block.shape[1] if bc_block is not None else block_size
        h = hist
        preds = []
        for i in range(n_steps):
            x_dyn = h.index_select(1, ip)                 # [B, n_in, V, Fd]
            B, T, V, _ = x_dyn.shape
            parts = []
            if static is not None:
                parts.append(static[None, None].expand((B, T) + static.shape))
            if bc_block is not None:
                parts.append(bc_block[:, i])              # [B, n_in, V, Fb]
            parts.append(x_dyn)
            y = model(torch.cat(parts, dim=-1))           # [B, n_out, V, Fd]
            y_write = y
            if keep_first:
                prev = h.index_select(1, op)
                wsel = wmask[op]
                y_write = torch.where(wsel[None, :, None, None], prev, y)
                wmask = wmask.clone()
                wmask[op] = True
                # roll the mask with the buffer; slots entering from the
                # future are unwritten
                wmask = torch.roll(wmask, -fc)
                wmask[-fc:] = False
            h = h.clone()
            h[:, op] = y_write
            h = torch.roll(h, -fc, dims=1)                # advance one cycle
            preds.append(y)
        return h, wmask, torch.stack(preds, dim=1)

    return rollout, H
