"""Member-parallel ensemble rollout.

Port of `deepsphere_weather_tpu/prob/ensemble_rollout.py`: member
parameters stacked on a leading axis ({name: [M, ...]}, as
`SWAG.sample_members` or `weights.stack_states` give them), and the block
rollout
of `engine.step.make_rollout_block` run for every member at once through
`torch.func.functional_call` under `torch.func.vmap`: the history and the
keep-first mask per member, the boundary conditions and static features
shared. Each block-sparse product folds the members into its columns (the
registered SpMM op's vmap rule): one kernel launch for all members.
BatchNorm members normalize with their batch statistics, as the JAX
rollout without a norm_state does.

On a mesh with a member axis (`parallel.make_mesh(n_member=...)`) each
member rank rolls its members (`parallel.member_range`) on the whole
batch and geometry, as the JAX package shards the rollout over 'member'
alone, and every rank returns every member's outputs, gathered over the
member group (the JAX global array).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.ar import ARIndexer
from ..engine.step import keep_first_feedback, make_rollout_block
from ..parallel.collectives import gather_rows
from ..parallel.mesh import member_range

__all__ = ["make_ensemble_rollout", "ensemble_rollout_predictions"]


class _Rollout(nn.Module):
    """The block rollout of `model` as a module, so that one
    `functional_call` swaps the parameters of every model call in it."""

    def __init__(self, model, rollout):
        super().__init__()
        self.model = model
        self.rollout = rollout

    def forward(self, hist, wmask, bc_block, static):
        return self.rollout(hist, wmask, bc_block, static)


def _gather_members(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every member rank's [m, ...] part of `t`, in member order (a bool
    mask crosses as bytes)."""
    if t.dtype == torch.bool:
        return gather_rows(t.to(torch.uint8), mesh.member_group, 0).bool()
    return gather_rows(t, mesh.member_group, 0)


def make_ensemble_rollout(model, indexer: ARIndexer, block_size: int,
                          mesh=None):
    """Build the member-stacked block rollout. Returns (fn, H) with

        fn(member_params, hist, wmask, bc_block, static) ->
            (new_hist, new_wmask, preds [M, B, block, n_out, V, F])

    member_params {name: [M, ...]}, hist [M, B, H, V, F]; `wmask` is the keep-first mask ([M, H] bool when
    `keep_first_feedback(indexer)`, else None), threaded like the history.
    Run it under `torch.no_grad()` to predict. With a `mesh`, every rank
    passes every member's inputs and gets every member's outputs; it
    rolls its own members (module docstring)."""
    rollout, H = make_rollout_block(model, indexer, block_size)
    wrapper = _Rollout(model, rollout)

    def run(member_params, hist, wmask, bc_block, static):
        params = {f"model.{k}": v for k, v in member_params.items()}

        def one(p, h, wm):
            return torch.func.functional_call(wrapper, p,
                                              (h, wm, bc_block, static))

        in_dims = (0, 0, None if wmask is None else 0)
        out_dims = (0, None if wmask is None else 0, 0)
        return torch.func.vmap(one, in_dims=in_dims, out_dims=out_dims)(
            params, hist, wmask)

    if mesh is None or mesh.n_member == 1:
        return run, H

    def fn(member_params, hist, wmask, bc_block, static):
        sl = slice(*member_range(hist.shape[0], mesh))
        out = run({k: v[sl] for k, v in member_params.items()}, hist[sl],
                  None if wmask is None else wmask[sl], bc_block, static)
        return tuple(None if t is None else _gather_members(t, mesh)
                     for t in out)

    return fn, H


def ensemble_rollout_predictions(model, member_params, *,
                                 data_dynamic, indexer: ARIndexer,
                                 n_steps: int,
                                 data_bc=None, bc_generator=None,
                                 data_static=None, scaler=None,
                                 scaler_bc=None, inverse_scale: bool = True,
                                 t0s: np.ndarray, batch_size: int = 8,
                                 mesh=None) -> np.ndarray:
    """All-member rollout -> predictions [M, n_frt, n_steps, n_out, V, F]
    in host memory, for horizons that fit one block, on the model's
    device.

    Boundary conditions as in `engine.AutoregressivePredictions`
    (`make_bc_reader`: `scaler_bc` as the training loader applied it,
    `bc_generator` beyond the BC store); outputs inverse-scaled to
    physical units when `scaler` is given (unless `inverse_scale=False`).
    With a `mesh`, the member ranks roll their members and every rank
    returns every member's predictions (`make_ensemble_rollout`).
    """
    from ..engine.prediction import make_bc_reader

    fn, H = make_ensemble_rollout(model, indexer, n_steps, mesh=mesh)
    device = next(model.parameters()).device
    tensors = {k: v.to(device) for k, v in member_params.items()}
    n_members = next(iter(tensors.values())).shape[0]
    static = (torch.from_numpy(data_static.read_stacked()).to(device)
              if data_static is not None else None)
    V = data_dynamic.n_node
    F = data_dynamic.n_feature
    dt = data_dynamic.timestep
    min_k = min(indexer.input_k)
    read_bc = make_bc_reader(data_dynamic, data_bc, bc_generator, scaler_bc)
    in_offs = np.asarray(indexer.input_k)
    out_offs = np.asarray(indexer.output_k)
    outs = []
    for lo in range(0, len(t0s), batch_size):
        sel = t0s[lo: lo + batch_size]
        B = len(sel)
        hist = np.zeros((B, H, V, F), dtype=np.float32)
        for b, t0 in enumerate(sel):
            t_hist = np.arange(t0 + min_k, t0 + min(indexer.output_k))
            vals = data_dynamic.read_stacked(t_hist)
            if scaler is not None:
                vals = scaler.transform(
                    vals, time=data_dynamic.time[t_hist]).astype(np.float32)
            hist[b, : len(t_hist)] = vals
        hist_m = torch.from_numpy(hist).to(device)[None].expand(
            (n_members,) + hist.shape).contiguous()
        wmask_m = (torch.zeros((n_members, H), dtype=torch.bool,
                               device=device)
                   if keep_first_feedback(indexer) else None)
        bc_block = None
        if data_bc is not None or bc_generator is not None:
            bc_rows = [read_bc(t0, i * indexer.forecast_cycle + in_offs)
                       for t0 in sel for i in range(n_steps)]
            bc_block = torch.from_numpy(
                np.asarray(bc_rows, dtype=np.float32).reshape(
                    B, n_steps, len(in_offs), V, bc_rows[0].shape[-1])
            ).to(device)
        with torch.no_grad():
            _, _, preds = fn(tensors, hist_m, wmask_m, bc_block, static)
        preds = preds.cpu().numpy()         # [M, B, n_steps, n_out, V, F]
        if scaler is not None and inverse_scale:
            for i in range(n_steps):
                for oi in range(len(out_offs)):
                    t_valid = (data_dynamic.time[sel]
                               + (i * indexer.forecast_cycle
                                  + out_offs[oi]) * dt)
                    preds[:, :, i, oi] = scaler.inverse_transform(
                        preds[:, :, i, oi], time=t_valid)
        outs.append(preds)
    return np.concatenate(outs, axis=1)
