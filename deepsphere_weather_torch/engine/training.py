"""Autoregressive training driver (xforecasting.AutoregressiveTraining parity).

Port of `deepsphere_weather_tpu/engine/training.py`. It drives the train
and validation steps of `engine/step.py` with:

- AR scheduler weight growth per scoring interval, and AR-iteration growth
  when early stopping runs out of patience, with its reset levers
  ("counter" or "full");
- the learning-rate levers `lr_decay_on_growth` and `lr_plateau_decay`
  (ReduceLROnPlateau at the last AR stage), which set
  `param_groups[*]["lr"]`: the JAX package's `_set_opt_lr`;
- validation scoring (`validation_batches` caps the pass), early stopping,
  per-epoch checkpoints (`save_model_each_epoch`) and mid-epoch ones every
  10 scoring intervals while the loss is healthy;
- a reset-immune loss floor (`best_ever`) and the explosion guard, and the
  divergence rescue: a non-finite or exploding loss restores the last
  checkpoint and halves the learning rate, at most 3 times;
- the device-cache choice: when the pre-scaled mirrors fit
  `DSW_DEVICE_CACHE_BYTES` (8 GB by default) they move onto the device
  once and each step gathers its windows there
  (`make_cached_train_step`); otherwise the loader streams assembled
  batches to the device (`make_train_step`);
- an optional node-, data- and member-parallel `mesh`
  (`parallel.make_mesh`): a model whose geometry is whole trains on its
  node shard (`models.shard_geometry`; the whole geometry is back when
  the driver returns); every rank takes the same decisions, from the
  global losses every rank holds; rank 0 writes the checkpoints;
- BatchNorm models: every step folds its batch statistics into the
  running statistics (the model's buffers, `engine.step.fold_running_stats`),
  validation scores in eval mode with them, and checkpoints save them
  (`model_weights/norm_state.npz`, restored by the divergence rescue). As
  in the JAX package, a run starts from fresh statistics (mean 0, var 1)
  unless `initial_norm_state` gives others;
- member-parallel ensembles (`n_members`): `model` is then a
  `models.MemberStack` of that many members, every member advances in one
  step on shared batches (`make_member_train_step`), the scalar metrics
  are member means (early stopping and AR growth act on the mean) and the
  per-member validation losses land in `ARTrainingInfo.per_member_loss`.
  On a mesh with a member axis each rank trains its members
  (`parallel.member_range`, with their slices of the optimizer state);
  the losses of every member are gathered to every rank, and the whole
  stack and its optimizer state are gathered back for each checkpoint
  (today's [M, ...] layout, so a run resumes across layouts) and when the
  driver returns;
- SWAG collection (`swag`, `swag_model`, `swag_freq`, `swa_start`): at a
  scoring interval with `update >= swa_start`, every `swag_freq`-th one
  collects the parameters into `swag_model` (`prob.SWAG`).

The model holds its parameters and the optimizer its state, both updated
in place; a resumed run loads them first (`utils.Checkpointer`). Steps are
queued without a host synchronization; the loss is read once per scoring
interval.

`ARTrainingInfo.plots` draws the training curves through the plotting
package (`plotting/training.py`), imported when it is called: the trainer
itself never loads matplotlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.ar import ARIndexer
from ..data.loader import AutoregressiveDataLoader, AutoregressiveDataset
from ..models.geometry import shard_geometry
from ..parallel.collectives import gather_rows
from ..parallel.mesh import (TRAIN_BATCH_KEYS, member_range, mesh_barrier,
                             put_device_dataset, shard_batch,
                             shard_window_indices)
from ..utils.checkpoint import Checkpointer
from .optim import Adam
from .scheduler import ARScheduler, EarlyStopping
from .step import (make_cached_member_train_step,
                   make_cached_member_validation_fn, make_cached_train_step,
                   make_cached_validation_fn, make_member_train_step,
                   make_member_validation_fn, make_train_step,
                   make_validation_fn)

__all__ = ["ARTrainingInfo", "AutoregressiveTraining"]


def _lr_settable(optimizer) -> bool:
    """Whether the driver may set the learning rate: `engine.optim.Adam`
    says so (`inject_lr`, as the JAX driver injects it); any other torch
    optimizer's rate is settable."""
    return bool(getattr(optimizer, "inject_lr", True))


def _set_opt_lr(optimizer, lr: float):
    if not _lr_settable(optimizer):
        raise ValueError(
            "lr scheduling (lr_decay_on_growth / lr_plateau_decay) needs an "
            "optimizer whose learning rate the driver may set; "
            "engine.optim.make_optimizer builds one (inject_lr=True) when "
            "these training settings are active")
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@dataclasses.dataclass
class ARTrainingInfo:
    """Training metric history (xforecasting.AR_TrainingInfo parity); the
    JAX package's record, saved as the same JSON."""

    iterations: List[int] = dataclasses.field(default_factory=list)
    training_total_loss: List[float] = dataclasses.field(default_factory=list)
    validation_iterations: List[int] = dataclasses.field(default_factory=list)
    validation_total_loss: List[float] = dataclasses.field(default_factory=list)
    per_iteration_loss: List[List[float]] = dataclasses.field(default_factory=list)
    ar_weights_history: List[List[float]] = dataclasses.field(default_factory=list)
    ar_growth_events: List[int] = dataclasses.field(default_factory=list)
    epoch_boundaries: List[int] = dataclasses.field(default_factory=list)
    samples_per_sec: List[float] = dataclasses.field(default_factory=list)
    # member-parallel runs: per-member validation loss at each scoring
    # interval ([n_intervals][n_members]); empty for single-member runs
    per_member_loss: List[List[float]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def save(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.to_dict(), default=float))

    @classmethod
    def load(cls, path) -> "ARTrainingInfo":
        return cls(**json.loads(Path(path).read_text()))

    def plots(self, exp_dir, ylim=None):
        """Render the training/validation curves under
        `exp_dir/figs/training_info/` (reference: ar_training_info.plots,
        train_predict_state.py:449)."""
        from ..plotting.training import plot_training_info

        return plot_training_info(self, exp_dir, ylim=ylim)


@torch.no_grad()
def _start_norm_state(model, initial: Optional[Dict], n_members):
    """The running statistics a run starts from, in place: `initial`, or
    fresh ones (mean 0, var 1) as the JAX driver starts. A member stack
    takes a single-model state broadcast to every member; any other shape
    raises (the JAX package's check)."""
    state = model.norm_state()
    for name, buf in state.items():
        if initial is None:
            buf.fill_(0.0 if name.endswith("mean") else 1.0)
            continue
        given = torch.as_tensor(initial[name], dtype=buf.dtype)
        single = buf.shape[1:] if n_members is not None else buf.shape
        if n_members is not None and given.shape == single:
            given = given.expand_as(buf)
        elif given.shape != buf.shape:
            raise ValueError(
                f"initial_norm_state leaf shape {tuple(given.shape)} "
                f"matches neither the single-model template "
                f"{tuple(single)} nor the member-stacked "
                f"{(n_members,) + tuple(single)}" if n_members is not None
                else f"initial_norm_state {name} has shape "
                     f"{tuple(given.shape)}, the model's {tuple(buf.shape)}")
        buf.copy_(given.to(buf.device))


def _local_optimizer(optimizer, local):
    """An optimizer of `optimizer`'s kind and settings over `local`'s
    parameters (its state filled by `_MemberShard.to_local`)."""
    if isinstance(optimizer, Adam):
        opt = Adam(local.parameters(), lr=optimizer.param_groups[0]["lr"],
                   gradient_clipping=optimizer.gradient_clipping,
                   inject_lr=optimizer.inject_lr, member_axis=True,
                   lr_schedule=optimizer.lr_schedule,
                   eps=optimizer.defaults["eps"])
        opt.updates = optimizer.updates
        return opt
    return type(optimizer)(local.parameters(), **optimizer.defaults)


class _MemberShard:
    """A member rank's part of a whole member stack `full` and its
    optimizer `full_opt`: the stack of its members (`local`) and their
    optimizer (`opt`), with the copies both ways. `to_full` gathers over
    the member group (every rank calls it together)."""

    def __init__(self, full, full_opt, mesh, n_members: int):
        self.full, self.full_opt, self.mesh = full, full_opt, mesh
        self.m0, self.m1 = member_range(n_members, mesh)
        self.local = full.select(self.m0, self.m1)
        self.opt = _local_optimizer(full_opt, self.local)
        self.to_local()

    def _pairs(self):
        return zip(self.full.named_parameters(),
                   self.local.named_parameters())

    @torch.no_grad()
    def to_local(self):
        """The whole stack's and optimizer's members [m0, m1) into the
        local ones."""
        sl = slice(self.m0, self.m1)
        for (_, pf), (_, pl) in self._pairs():
            pl.copy_(pf[sl])
            st = self.full_opt.state.get(pf)
            if st:
                self.opt.state[pl] = {
                    "step": st["step"].clone(),
                    "exp_avg": st["exp_avg"][sl].clone(),
                    "exp_avg_sq": st["exp_avg_sq"][sl].clone()}
        for (_, bf), (_, bl) in zip(self.full.named_buffers(),
                                    self.local.named_buffers()):
            bl.copy_(bf[sl])
        for g in self.opt.param_groups:
            g["lr"] = self.full_opt.param_groups[0]["lr"]

    @torch.no_grad()
    def to_full(self):
        """Every rank's members gathered into the whole stack and its
        optimizer: one gather of all of them, flattened per member."""
        pairs = list(self._pairs())
        stepped = all(self.opt.state.get(pl) for _, (_, pl) in pairs)
        tensors = [pl for _, (_, pl) in pairs] + [
            b for _, b in self.local.named_buffers()]
        if stepped:
            tensors += [self.opt.state[pl][k] for _, (_, pl) in pairs
                        for k in ("exp_avg", "exp_avg_sq")]
        m = self.m1 - self.m0
        flat = gather_rows(torch.cat([t.reshape(m, -1).float()
                                      for t in tensors], 1),
                           self.mesh.member_group, 0)
        parts = iter(flat.split([t[0].numel() for t in tensors], 1))
        full = [pf for (_, pf), _ in pairs] + [
            b for _, b in self.full.named_buffers()]
        for t in full:
            t.copy_(next(parts).reshape(t.shape))
        if stepped:
            for (_, pf), (_, pl) in pairs:
                step = self.opt.state[pl]["step"].clone()
                self.full_opt.state[pf] = {
                    "step": step,
                    "exp_avg": next(parts).reshape(pf.shape).clone(),
                    "exp_avg_sq": next(parts).reshape(pf.shape).clone()}
        for g in self.full_opt.param_groups:
            g["lr"] = self.opt.param_groups[0]["lr"]
        if hasattr(self.full_opt, "updates"):
            self.full_opt.updates = self.opt.updates


def _put_batch(batch: Dict, mesh, device) -> Dict:
    """The loader's transfer: the step's keys of a batch on the device
    (this rank's shard on a mesh); the host time arrays stay behind."""
    batch = {k: batch[k] for k in TRAIN_BATCH_KEYS if batch.get(k) is not None}
    if mesh is not None:
        return shard_batch(batch, mesh)
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def AutoregressiveTraining(
    model,
    *,
    # data
    training_data_dynamic,
    validation_data_dynamic=None,
    training_data_bc=None,
    validation_data_bc=None,
    data_static=None,
    scaler=None,
    scaler_bc=None,
    # AR settings
    input_k,
    output_k,
    forecast_cycle,
    ar_iterations,
    stack_most_recent_prediction: bool = True,
    ar_training_strategy: str = "RNN",
    # loss / optimizer
    area_weights=None,
    learning_rate: float = 0.007,
    optimizer=None,
    ar_scheduler: Optional[ARScheduler] = None,
    early_stopping: Optional[EarlyStopping] = None,
    # per-AR-stage convergence levers (config/settings.py): "full" resets
    # best + counter + clock at each growth; lr_decay_on_growth multiplies
    # the lr per growth; lr_plateau_decay turns the final-stage stop into
    # ReduceLROnPlateau (decay + full reset, at most lr_plateau_max_decays
    # times)
    early_stopping_reset_on_growth: str = "counter",
    lr_decay_on_growth: float = 1.0,
    lr_plateau_decay: float = 0.0,
    lr_plateau_max_decays: int = 2,
    # loop control
    epochs: int = 15,
    training_batch_size: int = 16,
    validation_batch_size: int = 16,
    # validation batches scored per interval; None = the whole validation
    # set (the reference's scoring). A cap scores a fixed prefix of the
    # unshuffled validation period.
    validation_batches: Optional[int] = None,
    scoring_interval: int = 10,
    save_model_each_epoch: bool = False,
    # infra
    exp_dir=None,
    mesh=None,
    remat: bool = False,
    device_cache="auto",
    num_workers: int = 4,
    prefetch_factor: int = 2,
    autotune_num_workers: bool = False,
    shuffle: bool = True,
    shuffle_seed: int = 69,
    # SWAG hooks (reference finetune_swag.py:354-401)
    swag: bool = False,
    swag_model=None,
    swag_freq: int = 10,
    swa_start: int = 0,
    n_members: Optional[int] = None,
    initial_norm_state: Optional[Dict] = None,
    verbose: bool = True,
):
    """Train `model` in place; returns (model, optimizer, ARTrainingInfo).

    `optimizer` defaults to `engine.optim.Adam(model.parameters(),
    learning_rate)` (the JAX package's `optax.adam(lr, eps=1e-7)`; with
    `n_members`, clipping per member). The batches and the area weights go
    to the model's device (a mesh's device on a mesh).

    With `n_members`, `model` is a `models.MemberStack` of that many
    members (on a member mesh too: the driver trains the rank's members
    and gathers them back into `model` and `optimizer`).
    `initial_norm_state` ({buffer name: tensor}) starts a
    BatchNorm model's running statistics; for a member stack a
    single-model state is broadcast to every member.

    On a `mesh` every rank must start with the same parameters
    (`weights.broadcast_params`) and call this together."""
    if n_members is not None and swag:
        raise ValueError("member-parallel training does not compose with "
                         "SWAG collection (collect per member separately)")
    if n_members is not None and getattr(model, "n_members",
                                         None) != n_members:
        raise TypeError(f"n_members={n_members} needs a models.MemberStack "
                        f"of {n_members} members as `model`")
    if n_members is not None:
        member_range(n_members, mesh)     # raises unless M divides
    if early_stopping_reset_on_growth not in ("counter", "full"):
        raise ValueError("early_stopping_reset_on_growth must be 'counter' "
                         "or 'full'")
    indexer = ARIndexer.build(input_k, output_k, forecast_cycle, ar_iterations,
                              stack_most_recent_prediction)
    device = mesh.device if mesh is not None else \
        next(model.parameters()).device
    if optimizer is None:
        # reference: Adam(lr, eps=1e-7) (train_predict_state.py:334)
        optimizer = Adam(model.parameters(), lr=learning_rate,
                         member_axis=n_members is not None)
    if (n_members is not None and getattr(optimizer, "gradient_clipping", 0)
            and not getattr(optimizer, "member_axis", False)):
        raise ValueError("a member stack clips each member by its own norm: "
                         "build the optimizer with member_axis=True")
    has_bn = bool(getattr(model, "has_batch_norm", False))
    if has_bn:
        _start_norm_state(model, initial_norm_state, n_members)
    # a member mesh trains this rank's members; `model` and `optimizer`
    # stay the whole ones, for checkpoints and the caller
    io_model, io_opt = model, optimizer
    members = None
    if n_members is not None and mesh is not None and mesh.n_member > 1:
        members = _MemberShard(model, optimizer, mesh, n_members)
        model, optimizer = members.local, members.opt
    # a whole geometry trains on this rank's node shard
    template = getattr(model, "model", model)
    whole_geometry = None
    if (mesh is not None and mesh.n_node > 1
            and template.geometry.node_ranges is None):
        whole_geometry = template.geometry
        template.geometry = shard_geometry(whole_geometry, mesh)
    writer = mesh is None or mesh.rank == 0
    if ar_scheduler is None:
        ar_scheduler = ARScheduler(method="Constant",
                                   initial_ar_absolute_weights=[1.0] *
                                   (ar_iterations + 1),
                                   max_ar_iterations=ar_iterations)
    ar_scheduler.max_ar_iterations = ar_iterations
    if early_stopping is None:
        early_stopping = EarlyStopping(patience=3000 // max(scoring_interval, 1))
    area_w = (torch.as_tensor(area_weights, dtype=torch.float32).to(device)
              if area_weights is not None else None)

    train_ds = AutoregressiveDataset(
        training_data_dynamic, indexer, data_bc=training_data_bc,
        data_static=data_static, scaler=scaler, scaler_bc=scaler_bc)
    train_ds.update_AR_iterations(ar_scheduler.current_ar_iterations)
    val_ds = None
    if validation_data_dynamic is not None:
        val_ds = AutoregressiveDataset(
            validation_data_dynamic, indexer, data_bc=validation_data_bc,
            data_static=data_static, scaler=scaler, scaler_bc=scaler_bc)
        val_ds.update_AR_iterations(ar_scheduler.current_ar_iterations)

    info = ARTrainingInfo()
    ckpt = Checkpointer(exp_dir) if exp_dir is not None else None

    # device-resident data: when the pre-scaled mirrors fit the budget, the
    # whole training/validation periods move onto the device once and the
    # steps gather their windows there; per step only a [B, W] index
    # batch crosses. Mirrors beyond it keep the streaming loader.
    use_cache = False
    if device_cache and train_ds.has_mirror and (
            val_ds is None or val_ds.has_mirror):
        budget = int(os.environ.get("DSW_DEVICE_CACHE_BYTES", 8 << 30))
        nbytes = train_ds.mirror_nbytes() + (
            val_ds.mirror_nbytes() if val_ds is not None else 0)
        use_cache = device_cache is True or nbytes <= budget
        if not use_cache and verbose:
            print(f"device_cache='auto': mirrors ({nbytes / 1e9:.1f} GB) "
                  f"exceed DSW_DEVICE_CACHE_BYTES ({budget / 1e9:.1f} GB) "
                  "— using the streaming loader", flush=True)
    elif device_cache is True:
        warnings.warn(
            "device_cache=True but no pre-scaled host mirror is loaded "
            "(dataset exceeds DSW_PRELOAD_BYTES or preload=False); "
            "falling back to the streaming loader", stacklevel=2)
    dev_train = (put_device_dataset(train_ds, mesh, device)
                 if use_cache else None)
    dev_val = (put_device_dataset(val_ds, mesh, device)
               if use_cache and val_ds is not None else None)

    def transfer(b):
        return _put_batch(b, mesh, device)

    def window_indices(ds, idx):
        return shard_window_indices(ds.window_indices(idx), mesh, device)

    # the steps of each AR stage, built once (kept across growth events)
    step_cache: Dict[int, tuple] = {}

    def get_steps(n_iters: int):
        if n_iters not in step_cache:
            n_scan = n_iters + 1
            if n_members is not None:
                step_cache[n_iters] = (
                    (make_cached_member_train_step if use_cache
                     else make_member_train_step)(
                        model, indexer, optimizer, n_scan,
                        ar_training_strategy, remat=remat,
                        with_norm_state=has_bn, mesh=mesh),
                    (make_cached_member_validation_fn if use_cache
                     else make_member_validation_fn)(
                        model, indexer, n_scan, eval_mode=has_bn,
                        mesh=mesh))
            else:
                step_cache[n_iters] = (
                    (make_cached_train_step if use_cache
                     else make_train_step)(
                        model, indexer, optimizer, n_scan,
                        ar_training_strategy, remat=remat, mesh=mesh,
                        with_norm_state=has_bn),
                    (make_cached_validation_fn if use_cache
                     else make_validation_fn)(
                        model, indexer, n_scan, mesh=mesh,
                        eval_mode=has_bn))
        return step_cache[n_iters]

    def save_checkpoint():
        # the whole stack, by rank 0; no rank reads one before it is written
        if members is not None:
            members.to_full()
        if writer:
            ckpt.save_model(io_model)
            if has_bn:
                ckpt.save_norm_state(io_model.norm_state())
            ckpt.save_training_state(io_opt, io_model,
                                     ar_scheduler.state_dict(),
                                     early_stopping.state_dict())
        mesh_barrier(mesh)

    def load_checkpoint():
        ckpt.load_model(io_model)
        ckpt.load_training_state(io_opt, io_model)
        if has_bn:
            ckpt.load_norm_state(io_model.norm_state())
        if members is not None:
            members.to_local()

    update = 0
    stop = False
    # current lr for the decay levers (a resumed optimizer carries the
    # decayed value)
    cur_lr = float(optimizer.param_groups[0]["lr"])
    plateau_decays = 0
    rescues = 0
    # reset-immune loss floor for the explosion guard and checkpoint
    # hygiene: early_stopping.best is cleared at every AR-growth reset, so
    # an already-exploding run's first post-growth validation would become
    # the stage's "best" and disarm the guard; best_ever survives resets
    best_ever = np.inf
    swag_counter = 0
    model.train()
    for epoch in range(epochs):
        if stop:
            break
        loader = AutoregressiveDataLoader(
            train_ds, batch_size=training_batch_size, shuffle=shuffle,
            shuffle_seed=shuffle_seed, num_workers=num_workers,
            prefetch_factor=prefetch_factor,
            autotune_num_workers=(autotune_num_workers and epoch == 0
                                  and not use_cache),
            epoch=epoch, transfer=transfer)
        if autotune_num_workers and epoch == 0 and not use_cache:
            num_workers = loader.num_workers  # reuse tuned value onwards
        info.epoch_boundaries.append(update)
        t_interval = time.perf_counter()
        steps_in_interval = 0
        w = w_host = None
        # device-cached data iterates sample-index batches (the window
        # gather runs on the device); the streaming path iterates
        # assembled batches
        batch_stream = (loader.iter_index_batches() if use_cache
                        else iter(loader))
        for batch in batch_stream:
            n_iters = ar_scheduler.current_ar_iterations
            train_step, _ = get_steps(n_iters)
            # AR weights change only at scoring intervals: upload then
            w_now = ar_scheduler.padded_weights(n_iters + 1)
            if w is None or not np.array_equal(w_now, w_host):
                w_host = w_now
                w = torch.as_tensor(w_now, device=device)
            if use_cache:
                total, per_iter = train_step(
                    dev_train, window_indices(train_ds, batch), w, area_w)
            else:
                total, per_iter = train_step(batch, w, area_w)
            update += 1
            steps_in_interval += 1

            if update % scoring_interval == 0:
                # one host synchronization per interval; member runs
                # report the member mean
                total = float(total.mean())
                dt = time.perf_counter() - t_interval
                info.iterations.append(update)
                info.training_total_loss.append(total)
                info.samples_per_sec.append(
                    training_batch_size * steps_in_interval / dt)
                steps_in_interval = 0
                # mid-epoch durability: a full checkpoint every 10 scoring
                # intervals, unless the run is deteriorating (the rescue
                # below restores from here)
                healthy = np.isfinite(total) and (
                    not np.isfinite(best_ever)
                    or total <= 100 * max(best_ever, 1e-8))
                if (ckpt is not None and healthy
                        and (update // scoring_interval) % 10 == 0):
                    save_checkpoint()
                ar_scheduler.step()
                # --- validation -----------------------------------------
                val_loss = total
                per_member = None
                per_iter_val = [float(x) for x in per_iter.reshape(
                    -1, per_iter.shape[-1]).mean(0).cpu().numpy()]
                if val_ds is not None:
                    _, val_fn = get_steps(n_iters)
                    vloader = AutoregressiveDataLoader(
                        val_ds, batch_size=validation_batch_size,
                        shuffle=False, num_workers=num_workers,
                        transfer=transfer)
                    tot, per, nb = None, None, 0
                    vstream = (vloader.iter_index_batches() if use_cache
                               else iter(vloader))
                    for vb in vstream:
                        if use_cache:
                            vt, vp = val_fn(dev_val,
                                            window_indices(val_ds, vb), w,
                                            area_w)
                        else:
                            vt, vp = val_fn(vb, w, area_w)
                        tot = vt if tot is None else tot + vt
                        per = vp if per is None else per + vp
                        nb += 1
                        if (validation_batches is not None
                                and nb >= validation_batches):
                            break
                    if nb:
                        val_loss = float(tot.mean()) / nb
                        if n_members is not None:
                            per_member = [float(x) for x in
                                          (tot / nb).cpu().numpy()]
                        per_iter_val = [float(x) for x in (per / nb).reshape(
                            -1, per.shape[-1]).mean(0).cpu().numpy()]
                info.validation_iterations.append(update)
                info.validation_total_loss.append(val_loss)
                info.per_iteration_loss.append(per_iter_val)
                if per_member is not None:
                    info.per_member_loss.append(per_member)
                info.ar_weights_history.append(
                    [float(x) for x in ar_scheduler.ar_weights])
                if verbose:
                    print(f"[epoch {epoch} update {update}] "
                          f"train {total:.5f} val {val_loss:.5f} "
                          f"AR {n_iters} weights "
                          f"{np.round(ar_scheduler.ar_weights, 3)} "
                          f"({info.samples_per_sec[-1]:.1f} samples/s)",
                          flush=True)

                # --- SWAG collection -----------------------------------
                if swag and swag_model is not None and update >= swa_start:
                    swag_counter += 1
                    if swag_counter % swag_freq == 0:
                        swag_model.collect_model(model)

                # restart the throughput clock after validation and
                # checkpointing, so their time is not charged to the next
                # interval's samples/s
                t_interval = time.perf_counter()

                # --- divergence detection / rescue -----------------------
                # RNN-strategy BPTT at the reference lr can blow up in one
                # step at an AR-growth transition. A non-finite loss
                # poisons every later metric: restore the last checkpoint
                # and halve the lr (when it is settable), at most 3 times.
                if np.isfinite(val_loss):
                    best_ever = min(best_ever, float(val_loss))
                exploded = (
                    np.isfinite(best_ever)
                    and val_loss > 1e4 * max(best_ever, 1e-8))
                if exploded or not (np.isfinite(val_loss)
                                    and np.isfinite(total)):
                    can_rescue = (
                        ckpt is not None and ckpt.has_checkpoint()
                        and rescues < 3 and _lr_settable(optimizer))
                    if can_rescue:
                        rescues += 1
                        cur_lr *= 0.5
                        load_checkpoint()
                        _set_opt_lr(optimizer, cur_lr)
                        early_stopping.reset()
                        kind = "exploding" if exploded else "non-finite"
                        print(f"  !! {kind} loss at update {update}: "
                              f"restored last checkpoint, lr -> "
                              f"{cur_lr:.2e} (rescue {rescues}/3)",
                              flush=True)
                        break     # rebuild loader; continue training
                    raise FloatingPointError(
                        f"training diverged "
                        f"({'exploding' if exploded else 'non-finite'} "
                        f"loss at update {update}) and no rescue is possible "
                        f"(checkpoint={ckpt is not None}, lr-settable="
                        f"{_lr_settable(optimizer)}, rescues={rescues}/3). "
                        "Set training_settings.gradient_clipping (e.g. 1.0) "
                        "— RNN-strategy AR growth at reference lr diverges "
                        "without it.")

                # --- early stopping / AR growth --------------------------
                # "full" mode suspends plateau judgement while the newest
                # AR weight still ramps: the loss definition is
                # non-stationary until the weights saturate
                if (early_stopping_reset_on_growth == "full"
                        and ar_scheduler.ramp_in_progress):
                    continue
                if early_stopping.check(val_loss):
                    if ar_scheduler.can_update():
                        ar_scheduler.update()
                        if ar_training_strategy == "AR":
                            # freeze all previously grown weights
                            ar_scheduler.fixed_ar_weights |= set(
                                range(len(ar_scheduler.absolute_weights) - 1))
                        if early_stopping_reset_on_growth == "full":
                            early_stopping.reset()
                        else:
                            early_stopping.reset_counter()
                        if lr_decay_on_growth != 1.0:
                            cur_lr *= float(lr_decay_on_growth)
                            _set_opt_lr(optimizer, cur_lr)
                        info.ar_growth_events.append(update)
                        train_ds.update_AR_iterations(
                            ar_scheduler.current_ar_iterations)
                        if val_ds is not None:
                            val_ds.update_AR_iterations(
                                ar_scheduler.current_ar_iterations)
                        if verbose:
                            print(f"  -> AR iterations grown to "
                                  f"{ar_scheduler.current_ar_iterations}"
                                  + (f" (lr -> {cur_lr:.2e})"
                                     if lr_decay_on_growth != 1.0 else ""),
                                  flush=True)
                        break  # rebuild loader with new sample set
                    if (lr_plateau_decay
                            and plateau_decays < lr_plateau_max_decays):
                        # final AR stage: ReduceLROnPlateau instead of stop
                        plateau_decays += 1
                        cur_lr *= float(lr_plateau_decay)
                        _set_opt_lr(optimizer, cur_lr)
                        early_stopping.reset()
                        if verbose:
                            print(f"  -> plateau at max AR: lr decayed to "
                                  f"{cur_lr:.2e} "
                                  f"({plateau_decays}/{lr_plateau_max_decays})",
                                  flush=True)
                        continue
                    stop = True
                    if verbose:
                        print("  -> early stopping", flush=True)
                    break
        if ckpt is not None and save_model_each_epoch:
            if members is not None:
                members.to_full()
            if writer:
                ckpt.save_model(io_model, name=f"model_epoch_{epoch}.npz")
        # crash durability: a full checkpoint after every epoch, so that
        # --resume recovers an interrupted run
        if ckpt is not None:
            save_checkpoint()

    if ckpt is not None:
        save_checkpoint()
        if writer:
            info.save(Path(ckpt.exp_dir) / "training_info"
                      / "ar_training_info.json")
    elif members is not None:
        members.to_full()
    if whole_geometry is not None:
        template.geometry = whole_geometry
    return io_model, io_opt, info
