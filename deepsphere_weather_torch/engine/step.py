"""AR training steps and the block rollout.

Port of `deepsphere_weather_tpu/engine/step.py`. `jax.lax.scan` becomes a
Python loop over AR iterations, `jax.value_and_grad` becomes
`loss.backward()`, and the optax update a `torch.optim` step (the JAX
package's `optax.adam(lr, eps=1e-7)` is `torch.optim.Adam(params, lr,
eps=1e-7)`: both add eps outside the square root).

- `make_ar_loss_fn`: the multi-step loss. The scaled truth window
  `dynamic` [B, W, V, F] doubles as the rollout buffer: each iteration's
  prediction is written into a copy at its output positions, so later
  iterations read the model's own predictions. Per-iteration losses are
  area-weighted MSE, combined with the normalized AR weights. 'RNN'
  backpropagates through the whole rollout; 'AR' detaches the buffer
  write (`stop_gradient`). `remat=True` recomputes each iteration in the
  backward (`torch.utils.checkpoint`).
- `make_train_step`, `make_validation_fn` and their device-cache variants
  `make_cached_train_step`, `make_cached_validation_fn`, which gather the
  window batch from a device-resident dataset. With a `mesh`
  (`parallel.make_mesh`), the train and validation steps run one rank of a
  node- and data-parallel step: GSPMD's collectives in the JAX package
  (`step.py:211-257`, `:315-330`) are written out here
  (`reduce_gradients`, the reported losses).
- `make_rollout_block`: the rolling-history block rollout for prediction.

Not ported yet: the BatchNorm variants (`with_norm_state`,
`collect_stats`, `eval_mode`), the member (ensemble) steps and
`noise_block`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.ar import ARIndexer
from ..parallel.collectives import all_reduce_
from ..parallel.mesh import ProcessMesh, node_range
from .loss import weighted_mse

__all__ = ["assemble_input", "keep_first_feedback", "make_ar_loss_fn",
           "make_train_step", "make_validation_fn", "make_cached_train_step",
           "make_cached_validation_fn", "make_rollout_block",
           "reduce_gradients"]


def keep_first_feedback(indexer: ARIndexer) -> bool:
    """True when the AR feedback must keep the FIRST prediction per slot
    (stack_most_recent_prediction=False with overlapping output windows)."""
    return (not indexer.stack_most_recent_prediction
            and indexer.has_overlapping_outputs)


def assemble_input(dyn_buf: torch.Tensor, bc: Optional[torch.Tensor],
                   static: Optional[torch.Tensor],
                   pin: torch.Tensor) -> torch.Tensor:
    """Model input of one AR iteration: dyn_buf [B, W, V, Fd], bc
    [B, W, V, Fb] or None, static [V, Fs] or None, pin [n_in] window
    positions. Feature order static + bc + dynamic."""
    x_dyn = dyn_buf.index_select(1, pin)                 # [B, n_in, V, Fd]
    B, T, V, _ = x_dyn.shape
    parts = []
    if static is not None:
        parts.append(static[None, None].expand((B, T) + static.shape))
    if bc is not None:
        parts.append(bc.index_select(1, pin))
    parts.append(x_dyn)
    return torch.cat(parts, dim=-1)


def make_ar_loss_fn(model, indexer: ARIndexer, n_scan_iterations: int,
                    ar_training_strategy: str = "RNN",
                    remat: bool = False,
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Build loss(batch, ar_weights, area_w=None) -> (total, per_iter).

    batch: {'dynamic': [B, W, V, Fd], 'bc': [B, W, V, Fb] (optional),
    'static': [V, Fs] (optional)} on the model's device; ar_weights: at
    least n_scan_iterations weights (normalized over the first
    n_scan_iterations); area_w: [V] loss weights or None (unit weights).
    per_iter is [n_scan_iterations]. On a `mesh` with a node axis, V is
    this rank's node shard of the batch, area_w is still the whole [V_all]
    vector (this function takes the rank's range and normalises by the
    whole sum), and the losses are the rank's shares (`weighted_mse`)."""
    if ar_training_strategy not in ("RNN", "AR"):
        raise ValueError("ar_training_strategy must be 'RNN' or 'AR'")
    in_pos = np.asarray(indexer.input_pos)
    out_pos = np.asarray(indexer.output_pos)
    detach = ar_training_strategy == "AR"
    keep_first = keep_first_feedback(indexer)

    def loss_fn(batch: Dict, ar_weights, area_w=None):
        dyn = batch["dynamic"]
        bc = batch.get("bc")
        static = batch.get("static")
        dev = dyn.device
        pins = torch.as_tensor(in_pos, dtype=torch.long, device=dev)
        pouts = torch.as_tensor(out_pos, dtype=torch.long, device=dev)
        weights, w_sum = _node_weights(area_w, dyn.shape[2], mesh)

        def step(dyn_buf, written, i):
            x = assemble_input(dyn_buf, bc, static, pins[i])
            y_pred = model(x)
            loss = weighted_mse(y_pred, dyn.index_select(1, pouts[i]),
                                weights, w_sum=w_sum)
            y_write = y_pred.detach() if detach else y_pred
            if keep_first:
                # a slot predicted by an earlier iteration keeps that
                # prediction (stack_most_recent_prediction=False)
                prev = dyn_buf.index_select(1, pouts[i])
                wmask = written[pouts[i]]
                y_write = torch.where(wmask[None, :, None, None], prev, y_write)
                written = written.index_fill(0, pouts[i], True)
            return dyn_buf.index_copy(1, pouts[i], y_write), written, loss

        dyn_buf = dyn
        written = torch.zeros(dyn.shape[1], dtype=torch.bool, device=dev)
        losses = []
        for i in range(n_scan_iterations):
            if remat:
                dyn_buf, written, loss = checkpoint(
                    step, dyn_buf, written, i, use_reentrant=False)
            else:
                dyn_buf, written, loss = step(dyn_buf, written, i)
            losses.append(loss)
        per_iter = torch.stack(losses)
        w = torch.as_tensor(ar_weights, dtype=torch.float32,
                            device=dev)[:n_scan_iterations]
        w = w / torch.clamp(w.sum(), min=1e-12)
        return (per_iter * w).sum(), per_iter

    return loss_fn


def _node_weights(area_w, n_local: int, mesh: Optional[ProcessMesh]):
    """(this rank's loss weights, the normaliser of its loss share): on a
    node mesh, the rank's range of the whole area_w and its whole sum (for
    unit weights, None and the node count); else (area_w, None)."""
    if mesh is None or mesh.n_node == 1:
        return area_w, None
    if area_w is None:
        return None, n_local * mesh.n_node
    v0, v1 = node_range(area_w.shape[0], mesh)
    if v1 - v0 != n_local:
        raise ValueError(f"area_w has {area_w.shape[0]} nodes, but the "
                         f"batch shard {n_local} of {n_local * mesh.n_node}")
    return area_w[v0:v1], area_w.sum()


def _reduce(flat: torch.Tensor, mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """In place: the sum over the node group (each rank holds a share),
    then the mean over the data group (each rank a batch shard)."""
    if mesh is not None and mesh.n_node > 1:
        all_reduce_(flat, mesh.node_group, "sum")
    if mesh is not None and mesh.n_data > 1:
        all_reduce_(flat, mesh.data_group, "mean")
    return flat


def reduce_gradients(model, mesh: Optional[ProcessMesh]) -> None:
    """Every parameter gradient of `model`, in place: summed over the node
    group (each rank differentiated its loss share) and averaged over the
    data group (the JAX data-parallel mean), in one flat buffer per
    group. Every rank then holds the gradient of the global loss."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if mesh is None or not grads:
        return
    flat = _reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _global_losses(total, per_iter, mesh):
    """The global (total, per_iter), detached: the ranks' shares reduced
    as the gradients are."""
    total, per_iter = total.detach(), per_iter.detach()
    if mesh is None:
        return total, per_iter
    flat = _reduce(torch.cat([total.reshape(1), per_iter]), mesh)
    return flat[0], flat[1:]


def _optimizer_step(model, optimizer, loss_fn, batch, ar_weights, area_w,
                    mesh=None):
    optimizer.zero_grad(set_to_none=True)
    total, per_iter = loss_fn(batch, ar_weights, area_w)
    total.backward()
    reduce_gradients(model, mesh)
    optimizer.step()
    return _global_losses(total, per_iter, mesh)


def make_train_step(model, indexer: ARIndexer, optimizer,
                    n_scan_iterations: int,
                    ar_training_strategy: str = "RNN",
                    remat: bool = False,
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Train step: (batch, ar_weights, area_w=None) -> (total, per_iter),
    detached, after one update of `optimizer` (over `model`'s
    parameters). Nothing synchronizes with the host.

    With a `mesh`, one rank's step: `batch` is its shard
    (`parallel.shard_batch`), `area_w` the whole [V] weights (the step
    takes the rank's node range), the model's geometry is sharded
    (`models.shard_geometry`), the
    gradients are reduced before the update (`reduce_gradients`) and the
    returned losses are the global ones. Every rank runs the same update,
    so parameters that start equal (`weights.broadcast_params`) stay so."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations,
                              ar_training_strategy, remat=remat, mesh=mesh)

    def train_step(batch: Dict, ar_weights, area_w=None):
        return _optimizer_step(model, optimizer, loss_fn, batch, ar_weights,
                               area_w, mesh)

    return train_step


def make_validation_fn(model, indexer: ARIndexer, n_scan_iterations: int,
                       mesh: Optional[ProcessMesh] = None) -> Callable:
    """(batch, ar_weights, area_w=None) -> (total, per_iter), no gradient;
    with a `mesh` as `make_train_step`'s."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh)

    @torch.no_grad()
    def validate(batch: Dict, ar_weights, area_w=None):
        return _global_losses(*loss_fn(batch, ar_weights, area_w), mesh)

    return validate


def _gather_window_batch(data: Dict, widx: torch.Tensor) -> Dict:
    """One window batch from the device-resident dataset: data
    {'dynamic': [T, V, Fd], 'bc': [T, V, Fb] or None, 'static': [V, Fs] or
    None}, widx [B, W] absolute time indices. Only widx crosses from the
    host per step."""
    widx = widx.to(data["dynamic"].device, torch.long)
    batch = {"dynamic": data["dynamic"][widx]}
    if data.get("bc") is not None:
        batch["bc"] = data["bc"][widx]
    if data.get("static") is not None:
        batch["static"] = data["static"]
    return batch


def make_cached_train_step(model, indexer: ARIndexer, optimizer,
                           n_scan_iterations: int,
                           ar_training_strategy: str = "RNN",
                           remat: bool = False,
                           mesh: Optional[ProcessMesh] = None) -> Callable:
    """Train step over a device-resident dataset: (data, widx, ar_weights,
    area_w=None) -> (total, per_iter); the same update as
    `make_train_step` on the gathered batch. With a `mesh`, `data` is the
    rank's part (`parallel.put_device_dataset`) and `widx` its batch rows
    (`parallel.shard_window_indices`)."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations,
                              ar_training_strategy, remat=remat, mesh=mesh)

    def train_step(data: Dict, widx, ar_weights, area_w=None):
        return _optimizer_step(model, optimizer, loss_fn,
                               _gather_window_batch(data, widx), ar_weights,
                               area_w, mesh)

    return train_step


def make_cached_validation_fn(model, indexer: ARIndexer,
                              n_scan_iterations: int,
                              mesh: Optional[ProcessMesh] = None) -> Callable:
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh)

    @torch.no_grad()
    def validate(data: Dict, widx, ar_weights, area_w=None):
        return _global_losses(
            *loss_fn(_gather_window_batch(data, widx), ar_weights, area_w),
            mesh)

    return validate


def make_rollout_block(model, indexer: ARIndexer,
                       block_size: int) -> Tuple[Callable, int]:
    """Build the block-rollout function. Returns (rollout_fn, H).

    rollout_fn(hist, wmask, bc_block, static, noise_block=None) ->
    (new_hist, new_wmask, preds [B, block, n_out, V, F]) with hist
    [B, H, V, F_dyn], bc_block [B, block, n_in, V, F_bc] or None, static
    [V, F_static] or None. The block is as long as bc_block, else as
    noise_block, else `block_size`. `noise_block` ([B, block, n_out, V, F],
    scaled space) is added to each step's prediction before feedback and
    emission (y = f(x) + eps): the stochastic model-error perturbation of
    ensembles. `wmask` is the keep-first written-mask: None unless
    keep_first_feedback(indexer); then start with torch.zeros(H, bool) and
    thread the returned mask into the next block.

    The function records gradients when they are on: callers that only
    predict run it under `torch.inference_mode()` (or `torch.no_grad()`,
    which `torch.export` traces; it takes no inference tensors).
    """
    fc = indexer.forecast_cycle
    min_k = min(indexer.input_k)
    max_out = max(indexer.output_k)
    H = max_out - min_k + 1
    in_pos = [k - min_k for k in indexer.input_k]
    out_pos = [k - min_k for k in indexer.output_k]
    keep_first = keep_first_feedback(indexer)

    def rollout(hist: torch.Tensor, wmask: Optional[torch.Tensor],
                bc_block: Optional[torch.Tensor],
                static: Optional[torch.Tensor],
                noise_block: Optional[torch.Tensor] = None):
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
        n_steps = (bc_block.shape[1] if bc_block is not None
                   else noise_block.shape[1] if noise_block is not None
                   else block_size)
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
            if noise_block is not None:
                y = y + noise_block[:, i]
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
