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
  backward (`torch.utils.checkpoint` around it, in the member steps around
  the iteration's `vmap` over the members); the JAX package's
  `jax.checkpoint` of the scan body.
- `make_train_step`, `make_validation_fn` and their device-cache variants
  `make_cached_train_step`, `make_cached_validation_fn`, which gather the
  window batch from a device-resident dataset. With a `mesh`
  (`parallel.make_mesh`), the train and validation steps run one rank of a
  node- and data-parallel step: GSPMD's collectives in the JAX package
  (`step.py:211-257`, `:315-330`) are written out here
  (`reduce_gradients`, the reported losses). A BatchNorm model's
  training-mode statistics are then the global batch's
  (`models.layers.batch_stats_over` around every model call).
- BatchNorm models (`models/layers.py`): `collect_stats` makes the loss
  return every AR iteration's batch statistics, `with_norm_state` makes a
  train step fold them into the model's running statistics after the
  update (`fold_running_stats`: one momentum-0.1 update per model call,
  in order, under `no_grad`), and `eval_mode` makes a validation function
  normalize with the running statistics.
- The member (DeepEnsemble) steps `make_member_train_step`,
  `make_cached_member_train_step`, `make_member_validation_fn` and
  `make_cached_member_validation_fn` run every member of a
  `models.MemberStack` at once: each AR iteration's forward is
  `functional_call` of the model under `torch.func.vmap` over the stacked
  tensors, the batch shared, and one `backward()` of the members' summed
  losses gives each member's gradient in its slice of the stacked
  parameters (a member's loss reads only its own slice). So M members hold
  what M single steps hold for their backward, and remat cuts that as it
  cuts the single step's (`torch.func.grad` would keep every iteration's
  backward alive until it returns). Each block-sparse product is one
  launch for all members, forward and backward (the registered op's vmap
  rule and `_MatVec`'s generated one).
  Gradient clipping is per member (`engine.optim.Adam(member_axis=True)`),
  as the JAX package clips inside its vmap; Adam itself is elementwise,
  so one optimizer over the stacked parameters is exact. With a `mesh`
  the stack is this rank's members (`parallel.member_range`): each
  member's gradients are reduced over the node and data groups as the
  single step's are (nothing over the member group), and the per-member
  losses are gathered over the member group into [M], in member order.
- `make_rollout_block`: the rolling-history block rollout for prediction,
  with the model-error perturbation `noise_block` and, for BatchNorm
  models, eval-mode normalization with a given `norm_state`.
- Spans (`utils.tracing`): `dsw.train.step` around each update, with
  `dsw.train.loss`, `dsw.train.backward` and `dsw.train.optimizer` inside
  it; `dsw.train.gather` around the device-cache gather; `dsw.rollout`
  around a block rollout; `dsw.model` around every model call. Any
  `torch.profiler` trace shows them as CPU ops.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.ar import ARIndexer
from ..models.layers import batch_stats_over
from ..parallel.collectives import all_reduce_, gather_rows
from ..parallel.mesh import ProcessMesh, node_range
from ..utils.tracing import span
from .loss import weighted_mse

__all__ = ["assemble_input", "keep_first_feedback", "make_ar_loss_fn",
           "fold_running_stats", "make_train_step", "make_validation_fn",
           "make_cached_train_step", "make_cached_validation_fn",
           "make_member_train_step", "make_cached_member_train_step",
           "make_member_validation_fn", "make_cached_member_validation_fn",
           "make_rollout_block", "reduce_gradients"]


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


def _flat_stats(stats: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A model call's nested statistics -> {buffer name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat_stats(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def make_ar_loss_fn(model, indexer: ARIndexer, n_scan_iterations: int,
                    ar_training_strategy: str = "RNN",
                    remat: bool = False,
                    mesh: Optional[ProcessMesh] = None,
                    collect_stats: bool = False,
                    eval_mode: bool = False,
                    members: bool = False) -> Callable:
    """Build loss(batch, ar_weights, area_w=None, tensors=None) ->
    (total, per_iter), or (total, (per_iter, stats)) with `collect_stats`.

    batch: {'dynamic': [B, W, V, Fd], 'bc': [B, W, V, Fb] (optional),
    'static': [V, Fs] (optional)} on the model's device; ar_weights: at
    least n_scan_iterations weights (normalized over the first
    n_scan_iterations); area_w: [V] loss weights or None (unit weights).
    per_iter is [n_scan_iterations]. On a `mesh` with a node axis, V is
    this rank's node shard of the batch, area_w is still the whole [V_all]
    vector (this function takes the rank's range and normalises by the
    whole sum), and the losses are the rank's shares (`weighted_mse`).

    `tensors` ({name: tensor}, parameters and/or buffers) runs the model
    on them (`torch.func.functional_call`) instead of its own: the member
    validation functions pass one member's under `vmap`. With `members`,
    `tensors` are member-stacked ([M, ...], `MemberStack.tensors()`) and
    each AR iteration runs every member under `torch.func.vmap`, the batch
    shared: total is then [M], per_iter [M, n_scan_iterations] and each
    statistic [M, n_scan_iterations, C].

    BatchNorm models: `collect_stats` returns the statistics of every
    model call, {buffer name: [n_scan_iterations, C]}, detached (they feed
    the running update only); `eval_mode` normalizes with the running
    statistics (the model's buffers, or those in `tensors`): the JAX
    package validates BatchNorm models so, as the reference does under
    model.eval()."""
    if ar_training_strategy not in ("RNN", "AR"):
        raise ValueError("ar_training_strategy must be 'RNN' or 'AR'")
    if collect_stats and eval_mode:
        raise ValueError("collect_stats is a training-mode channel")
    stats_groups = _stats_groups(mesh)
    in_pos = np.asarray(indexer.input_pos)
    out_pos = np.asarray(indexer.output_pos)
    detach = ar_training_strategy == "AR"
    keep_first = keep_first_feedback(indexer)

    def loss_fn(batch: Dict, ar_weights, area_w=None,
                tensors: Optional[Dict[str, torch.Tensor]] = None):
        dyn = batch["dynamic"]
        bc = batch.get("bc")
        static = batch.get("static")
        dev = dyn.device
        pins = torch.as_tensor(in_pos, dtype=torch.long, device=dev)
        pouts = torch.as_tensor(out_pos, dtype=torch.long, device=dev)
        weights, w_sum = _node_weights(area_w, dyn.shape[2], mesh)

        def forward(x, tensors):
            kw = {"train": False} if eval_mode else {}
            stats = {}
            if collect_stats:
                kw["stats_out"] = stats
            with batch_stats_over(stats_groups), span("dsw.model"):
                if tensors is not None:
                    y = torch.func.functional_call(model, tensors, (x,), kw)
                else:
                    y = model(x, **kw)
            return y, _flat_stats(stats)

        def step(dyn_buf, written, i, tensors):
            pin, pout = pins[i], pouts[i]
            x = assemble_input(dyn_buf, bc, static, pin)
            y_pred, stats = forward(x, tensors)
            loss = weighted_mse(y_pred, dyn.index_select(1, pout), weights,
                                w_sum=w_sum)
            y_write = y_pred.detach() if detach else y_pred
            if keep_first:
                # a slot predicted by an earlier iteration keeps that
                # prediction (stack_most_recent_prediction=False)
                prev = dyn_buf.index_select(1, pout)
                wmask = written[pout]
                y_write = torch.where(wmask[None, :, None, None], prev, y_write)
                written = written.index_fill(0, pout, True)
            return (dyn_buf.index_copy(1, pout, y_write), written, loss,
                    stats)

        def iteration(dyn_buf, written, i, tensors):
            if not members:
                return step(dyn_buf, written, i, tensors)
            # the buffer is the shared batch until the first write; the
            # written mask depends on no member
            return torch.func.vmap(
                lambda buf, t: step(buf, written, i, t),
                in_dims=(0 if i else None, 0), out_dims=(0, None, 0, 0))(
                    dyn_buf, tensors)

        dyn_buf = dyn
        written = torch.zeros(dyn.shape[1], dtype=torch.bool, device=dev)
        losses, all_stats = [], []
        for i in range(n_scan_iterations):
            if remat:
                dyn_buf, written, loss, stats = checkpoint(
                    iteration, dyn_buf, written, i, tensors,
                    use_reentrant=False)
            else:
                dyn_buf, written, loss, stats = iteration(dyn_buf, written,
                                                          i, tensors)
            losses.append(loss)
            all_stats.append(stats)
        per_iter = torch.stack(losses, dim=-1)
        w = torch.as_tensor(ar_weights, dtype=torch.float32,
                            device=dev)[:n_scan_iterations]
        w = w / torch.clamp(w.sum(), min=1e-12)
        total = (per_iter * w).sum(-1)
        if collect_stats:
            stats = {k: torch.stack([s[k] for s in all_stats], dim=-2)
                     for k in all_stats[0]}
            return total, (per_iter, stats)
        return total, per_iter

    return loss_fn


@torch.no_grad()
def fold_running_stats(norm_state: Dict[str, torch.Tensor],
                       scan_stats: Dict[str, torch.Tensor],
                       momentum: float = 0.1) -> Dict[str, torch.Tensor]:
    """In place: fold a loss's per-iteration batch statistics into the
    running statistics; returns `norm_state`.

    norm_state: {name: [C]} (or member-stacked [M, C]); scan_stats the
    same names with the scan axis before C ([n_scan, C] or [M, n_scan,
    C]). Each AR iteration's model call applies one momentum update in
    order, as torch BN updates in every training-mode forward (the JAX
    package's `fold_running_stats`)."""
    for name, state in norm_state.items():
        stats = scan_stats[name]
        out = state.clone()
        for i in range(stats.shape[-2]):
            out = (1.0 - momentum) * out + momentum * stats[..., i, :]
        state.copy_(out)
    return norm_state


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


def _stats_groups(mesh: Optional[ProcessMesh]):
    """The (group, ranks) pairs BatchNorm statistics are summed over: the
    node and the data group of a mesh (not the member group: each member
    normalizes with its own statistics)."""
    if mesh is None:
        return ()
    return tuple((g, n) for g, n in ((mesh.node_group, mesh.n_node),
                                     (mesh.data_group, mesh.n_data)) if n > 1)


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
                    mesh=None, with_norm_state=False):
    with span("dsw.train.step"):
        optimizer.zero_grad(set_to_none=True)
        with span("dsw.train.loss"):
            total, aux = loss_fn(batch, ar_weights, area_w)
        with span("dsw.train.backward"):
            total.backward()
        reduce_gradients(model, mesh)
        with span("dsw.train.optimizer"):
            optimizer.step()
        if with_norm_state:
            per_iter, stats = aux
            fold_running_stats(model.norm_state(), stats)
            aux = per_iter
        return _global_losses(total, aux, mesh)


def make_train_step(model, indexer: ARIndexer, optimizer,
                    n_scan_iterations: int,
                    ar_training_strategy: str = "RNN",
                    remat: bool = False,
                    mesh: Optional[ProcessMesh] = None,
                    with_norm_state: bool = False) -> Callable:
    """Train step: (batch, ar_weights, area_w=None) -> (total, per_iter),
    detached, after one update of `optimizer` (over `model`'s
    parameters). Nothing synchronizes with the host.

    `with_norm_state` (BatchNorm models): each AR iteration's batch
    statistics then fold into the model's running statistics after the
    update (`fold_running_stats`), as the JAX step folds them into the
    norm_state it threads.

    With a `mesh`, one rank's step: `batch` is its shard
    (`parallel.shard_batch`), `area_w` the whole [V] weights (the step
    takes the rank's node range), the model's geometry is sharded
    (`models.shard_geometry`), the
    gradients are reduced before the update (`reduce_gradients`) and the
    returned losses are the global ones. Every rank runs the same update,
    so parameters that start equal (`weights.broadcast_params`) stay so."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations,
                              ar_training_strategy, remat=remat, mesh=mesh,
                              collect_stats=with_norm_state)

    def train_step(batch: Dict, ar_weights, area_w=None):
        return _optimizer_step(model, optimizer, loss_fn, batch, ar_weights,
                               area_w, mesh, with_norm_state)

    return train_step


def make_validation_fn(model, indexer: ARIndexer, n_scan_iterations: int,
                       mesh: Optional[ProcessMesh] = None,
                       eval_mode: bool = False) -> Callable:
    """(batch, ar_weights, area_w=None) -> (total, per_iter), no gradient;
    with a `mesh` as `make_train_step`'s. `eval_mode` (BatchNorm models)
    normalizes with the model's running statistics."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh, eval_mode=eval_mode)

    @torch.no_grad()
    def validate(batch: Dict, ar_weights, area_w=None):
        return _global_losses(*loss_fn(batch, ar_weights, area_w), mesh)

    return validate


def _gather_window_batch(data: Dict, widx: torch.Tensor) -> Dict:
    """One window batch from the device-resident dataset: data
    {'dynamic': [T, V, Fd], 'bc': [T, V, Fb] or None, 'static': [V, Fs] or
    None}, widx [B, W] absolute time indices. Only widx crosses from the
    host per step."""
    with span("dsw.train.gather"):
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
                           mesh: Optional[ProcessMesh] = None,
                           with_norm_state: bool = False) -> Callable:
    """Train step over a device-resident dataset: (data, widx, ar_weights,
    area_w=None) -> (total, per_iter); the same update as
    `make_train_step` on the gathered batch (`with_norm_state` as
    there). With a `mesh`, `data` is the rank's part
    (`parallel.put_device_dataset`) and `widx` its batch rows
    (`parallel.shard_window_indices`)."""
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations,
                              ar_training_strategy, remat=remat, mesh=mesh,
                              collect_stats=with_norm_state)

    def train_step(data: Dict, widx, ar_weights, area_w=None):
        return _optimizer_step(model, optimizer, loss_fn,
                               _gather_window_batch(data, widx), ar_weights,
                               area_w, mesh, with_norm_state)

    return train_step


def make_cached_validation_fn(model, indexer: ARIndexer,
                              n_scan_iterations: int,
                              mesh: Optional[ProcessMesh] = None,
                              eval_mode: bool = False) -> Callable:
    loss_fn = make_ar_loss_fn(model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh, eval_mode=eval_mode)

    @torch.no_grad()
    def validate(data: Dict, widx, ar_weights, area_w=None):
        return _global_losses(
            *loss_fn(_gather_window_batch(data, widx), ar_weights, area_w),
            mesh)

    return validate


# ---------------------------------------------------------------------------
# Member-parallel (DeepEnsemble) steps over a `models.MemberStack`
# ---------------------------------------------------------------------------

def _member_losses(total, per_iter, mesh):
    """The members' (total [M], per_iter [M, n_scan]), detached: each
    rank's members reduced over the node and data groups as the single
    step's losses are, then gathered over the member group."""
    total, per_iter = total.detach(), per_iter.detach()
    if mesh is None:
        return total, per_iter
    flat = _reduce(torch.cat([total[:, None], per_iter], dim=1), mesh)
    if mesh.n_member > 1:
        flat = gather_rows(flat, mesh.member_group, 0)
    return flat[:, 0], flat[:, 1:]


def _member_update(stack, optimizer, loss_fn, batch, ar_weights, area_w,
                   with_norm_state, mesh=None):
    """One update of every member: the members' losses (`loss_fn` built
    with `members=True`, the batch shared), one backward of their sum
    (each member's gradient lands in its slice of the stacked
    parameters), reduced over the mesh's node and data groups, then one
    optimizer step over the stacked parameters and, with norm state, the
    per-member fold."""
    with span("dsw.train.step"):
        optimizer.zero_grad(set_to_none=True)
        with span("dsw.train.loss"):
            total, aux = loss_fn(batch, ar_weights, area_w,
                                 tensors=stack.tensors())
        with span("dsw.train.backward"):
            total.sum().backward()
        reduce_gradients(stack, mesh)
        with span("dsw.train.optimizer"):
            optimizer.step()
        if with_norm_state:
            aux, stats = aux
            fold_running_stats(stack.norm_state(), stats)
        return _member_losses(total, aux, mesh)


def _member_loss(stack, indexer, n_scan_iterations, ar_training_strategy,
                 remat, with_norm_state, mesh):
    if getattr(stack, "n_members", None) is None:
        raise TypeError("member steps take a models.MemberStack")
    return make_ar_loss_fn(stack.model, indexer, n_scan_iterations,
                           ar_training_strategy, remat=remat, mesh=mesh,
                           collect_stats=with_norm_state, members=True)


def make_member_train_step(stack, indexer: ARIndexer, optimizer,
                           n_scan_iterations: int,
                           ar_training_strategy: str = "RNN",
                           remat: bool = False,
                           with_norm_state: bool = False,
                           mesh: Optional[ProcessMesh] = None) -> Callable:
    """Member-parallel train step over a `models.MemberStack`:
    (batch, ar_weights, area_w=None) -> (total [M], per_iter [M, n_scan]),
    detached, after one update of `optimizer` (over `stack.parameters()`;
    `engine.optim.Adam(member_axis=True)` clips each member by its own
    global norm). Every member trains on the same batch. With
    `with_norm_state` each member's statistics fold into its own running
    statistics (`stack.norm_state()`, [M, C]). `remat` recomputes each
    AR iteration in the backward (`torch.utils.checkpoint` around the
    iteration's `vmap`).

    With a `mesh`, one rank's step: `stack` holds the rank's members
    (`parallel.member_range`), `batch` and `area_w` are as in
    `make_train_step`'s, and the returned losses are every member's,
    gathered over the member group (module docstring)."""
    loss_fn = _member_loss(stack, indexer, n_scan_iterations,
                           ar_training_strategy, remat, with_norm_state, mesh)

    def train_step(batch: Dict, ar_weights, area_w=None):
        return _member_update(stack, optimizer, loss_fn, batch, ar_weights,
                              area_w, with_norm_state, mesh)

    return train_step


def make_cached_member_train_step(stack, indexer: ARIndexer, optimizer,
                                  n_scan_iterations: int,
                                  ar_training_strategy: str = "RNN",
                                  remat: bool = False,
                                  with_norm_state: bool = False,
                                  mesh: Optional[ProcessMesh] = None
                                  ) -> Callable:
    """`make_member_train_step` over a device-resident dataset: (data,
    widx, ar_weights, area_w=None); the window batch is gathered once and
    shared by every member (`mesh` as in `make_cached_train_step`)."""
    loss_fn = _member_loss(stack, indexer, n_scan_iterations,
                           ar_training_strategy, remat, with_norm_state, mesh)

    def train_step(data: Dict, widx, ar_weights, area_w=None):
        return _member_update(stack, optimizer, loss_fn,
                              _gather_window_batch(data, widx), ar_weights,
                              area_w, with_norm_state, mesh)

    return train_step


def _member_validate(stack, loss_fn, batch, ar_weights, area_w, mesh):
    def one(t):
        return loss_fn(batch, ar_weights, area_w, tensors=t)
    with torch.no_grad():
        return _member_losses(*torch.func.vmap(one)(stack.tensors()), mesh)


def make_member_validation_fn(stack, indexer: ARIndexer,
                              n_scan_iterations: int,
                              eval_mode: bool = False,
                              mesh: Optional[ProcessMesh] = None) -> Callable:
    """(batch, ar_weights, area_w=None) -> (total [M], per_iter [M,
    n_scan]), no gradient; `eval_mode` normalizes each member with its
    own running statistics; `mesh` as in `make_member_train_step`."""
    loss_fn = make_ar_loss_fn(stack.model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh, eval_mode=eval_mode)

    def validate(batch: Dict, ar_weights, area_w=None):
        return _member_validate(stack, loss_fn, batch, ar_weights, area_w,
                                mesh)

    return validate


def make_cached_member_validation_fn(stack, indexer: ARIndexer,
                                     n_scan_iterations: int,
                                     eval_mode: bool = False,
                                     mesh: Optional[ProcessMesh] = None
                                     ) -> Callable:
    loss_fn = make_ar_loss_fn(stack.model, indexer, n_scan_iterations, "RNN",
                              mesh=mesh, eval_mode=eval_mode)

    def validate(data: Dict, widx, ar_weights, area_w=None):
        return _member_validate(stack, loss_fn,
                                _gather_window_batch(data, widx), ar_weights,
                                area_w, mesh)

    return validate


def make_rollout_block(model, indexer: ARIndexer, block_size: int,
                       norm_state: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Tuple[Callable, int]:
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

    A non-empty `norm_state` ({buffer name: tensor}, the running
    statistics of a BatchNorm model) makes every model call normalize in
    eval mode with it; without one a BatchNorm model normalizes with each
    batch's statistics, as the JAX rollout does.

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
    if norm_state:
        def forward(x):
            return torch.func.functional_call(model, norm_state, (x,),
                                              {"train": False})
    else:
        forward = model

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
        with span("dsw.rollout"):
            ip = torch.as_tensor(in_pos, device=hist.device)
            op = torch.as_tensor(out_pos, device=hist.device)
            n_steps = (bc_block.shape[1] if bc_block is not None
                       else noise_block.shape[1] if noise_block is not None
                       else block_size)
            h = hist
            preds = []
            for i in range(n_steps):
                x_dyn = h.index_select(1, ip)             # [B, n_in, V, Fd]
                B, T, V, _ = x_dyn.shape
                parts = []
                if static is not None:
                    parts.append(static[None, None].expand(
                        (B, T) + static.shape))
                if bc_block is not None:
                    parts.append(bc_block[:, i])          # [B, n_in, V, Fb]
                parts.append(x_dyn)
                x = torch.cat(parts, dim=-1)
                with span("dsw.model"):
                    y = forward(x)                        # [B, n_out, V, Fd]
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
                h = torch.roll(h, -fc, dims=1)            # advance one cycle
                preds.append(y)
            return h, wmask, torch.stack(preds, dim=1)

    return rollout, H
