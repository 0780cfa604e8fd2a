"""The block rollout exported as an artifact on disk (`torch.export`).

Port of `deepsphere_weather_tpu/serve/export.py`. An artifact directory is
self-contained:

    rollout.pt2         the `torch.export` program of the block rollout,
                        with the parameters, the static features and the
                        geometry's operator arrays in it as constants
    meta.json           shapes, AR settings, device type, torch version
    scaler_dynamic.npz  (optional) scaler of the dynamic fields
    scaler_bc.npz       (optional) scaler of the boundary conditions

The exported callable (`ExportedRollout.call`) is

    call(hist)              when the model takes no BC features
    call(hist, bc_block)    otherwise

with hist [batch_size, H, V, F_dyn] (scaled units) and bc_block
[batch_size, block_size, n_input_k, V, F_bc]; it returns
(new_hist, preds [batch_size, block_size, n_out, V, F_dyn]) on the
artifact's device. An ensemble artifact (`export_ensemble_rollout`) rolls
every member in one program: hist [n_members, batch_size, ...] in,
[n_members, ...] out, the boundary conditions shared. Its block-sparse
products fold the member axis into their columns (the registered op's
vmap rule, `ops/bcsr.py`): one kernel launch per product for all members.

Loading builds neither the model nor its geometry: the program holds the
registered SpMM op (`deepsphere_weather_torch::spmm`), whose module
`load_artifact` imports first. An artifact is loaded with the torch that
exported it, on its device type: a CUDA artifact raises on a machine
without CUDA.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.ar import ARIndexer
from ..engine.step import make_rollout_block

__all__ = ["ExportedRollout", "export_rollout", "export_ensemble_rollout",
           "save_artifact", "load_artifact"]

_ARTIFACT_NAME = "rollout.pt2"
_META_NAME = "meta.json"


class _Rollout(torch.nn.Module):
    """The block rollout of `model` as a module: (hist[, bc_block]) ->
    (new_hist, preds); the static features are a buffer."""

    def __init__(self, model, rollout, static: Optional[torch.Tensor]):
        super().__init__()
        self.model = model
        self.rollout = rollout
        self.register_buffer("static", static)

    def forward(self, hist, bc_block=None):
        h, _, preds = self.rollout(hist, None, bc_block, self.static)
        return h, preds


class _EnsembleRollout(torch.nn.Module):
    """`_Rollout` over member-stacked parameters: `functional_call` of the
    single rollout under `torch.func.vmap`, the parameters and the history
    mapped on their axis 0, the boundary conditions and the static
    features shared."""

    def __init__(self, single: _Rollout, member_params: Dict[str, torch.Tensor]):
        super().__init__()
        self.single = single
        self.names = list(member_params)
        for i, name in enumerate(self.names):
            self.register_buffer(f"member_{i}", member_params[name])

    def forward(self, hist, bc_block=None):
        params = {f"model.{name}": getattr(self, f"member_{i}")
                  for i, name in enumerate(self.names)}

        def member(p, h):
            return torch.func.functional_call(self.single, p, (h, bc_block))
        return torch.func.vmap(member)(params, hist)


@dataclasses.dataclass
class ExportedRollout:
    """An exported (or loaded) rollout program and its metadata."""

    program: torch.export.ExportedProgram
    meta: dict

    def __post_init__(self):
        self._module = self.program.module()

    @property
    def has_bc(self) -> bool:
        return self.meta["n_bc_features"] > 0

    @property
    def n_members(self) -> int:
        """> 0 for an ensemble (member-stacked) rollout."""
        return int(self.meta.get("n_members", 0))

    @property
    def device(self) -> torch.device:
        return torch.device(self.meta["platforms"][0])

    def _as_input(self, name, t, want):
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}; got "
                             f"{tuple(t.shape)}")
        return t

    def call(self, hist, bc_block=None):
        """One block: (new_hist, preds) on the artifact's device."""
        m = self.meta
        members = (self.n_members,) if self.n_members else ()
        hist = self._as_input("hist", hist, members + (
            m["batch_size"], m["history_size"], m["n_node"],
            m["n_dynamic_features"]))
        args = (hist,)
        if self.has_bc:
            if bc_block is None:
                raise ValueError("this artifact requires a bc_block "
                                 f"[B, {m['block_size']}, {m['n_input_k']}, "
                                 f"V, {m['n_bc_features']}]")
            args += (self._as_input("bc_block", bc_block, (
                m["batch_size"], m["block_size"], m["n_input_k"],
                m["n_node"], m["n_bc_features"])),)
        elif bc_block is not None:
            raise ValueError("this artifact takes no boundary conditions")
        with torch.inference_mode():
            return self._module(*args)


def _prepare(model, params, input_k, output_k, forecast_cycle, block_size,
             static):
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    indexer = ARIndexer.build(list(input_k), list(output_k), forecast_cycle,
                              1)
    rollout, H = make_rollout_block(model, indexer, block_size)
    device = next(model.parameters()).device
    static_t = (None if static is None else
                torch.as_tensor(np.asarray(static, np.float32), device=device))
    return _Rollout(model, rollout, static_t), H, device


def _meta(model, device, H, static, n_members, *, input_k, output_k,
          forecast_cycle, batch_size, block_size, n_bc_features,
          timestep_hours, feature_order) -> dict:
    meta = {
        "format_version": 1,
        "torch_version": torch.__version__,
        "platforms": [device.type],
        "batch_size": batch_size,
        "block_size": block_size,
        "history_size": H,
        "n_node": model.input_n_node,
        "n_dynamic_features": model.output_n_feature,
        "n_bc_features": n_bc_features,
        "n_static_features": 0 if static is None else int(static.shape[-1]),
        "n_input_k": len(input_k),
        "input_k": [int(k) for k in input_k],
        "output_k": [int(k) for k in output_k],
        "forecast_cycle": int(forecast_cycle),
        "timestep_hours": timestep_hours,
        "feature_order": list(feature_order) if feature_order else None,
    }
    if n_members:
        meta["n_members"] = n_members
    return meta


def _export(module, meta, device) -> ExportedRollout:
    """torch.export of `module` at the meta's input shapes, gradients off
    (so that every block-sparse product is the registered op itself)."""
    members = (meta["n_members"],) if meta.get("n_members") else ()
    args = (torch.zeros(members + (meta["batch_size"], meta["history_size"],
                                   meta["n_node"],
                                   meta["n_dynamic_features"]),
                        device=device),)
    if meta["n_bc_features"] > 0:
        args += (torch.zeros((meta["batch_size"], meta["block_size"],
                              meta["n_input_k"], meta["n_node"],
                              meta["n_bc_features"]), device=device),)
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
        if members:
            # lower the pre-dispatch vmap (which torch.export.save does not
            # serialize) to ATen ops: the retrace runs the op's vmap rule,
            # so the graph holds one product per member-stacked matvec
            program = program.run_decompositions({})
    return ExportedRollout(program=program, meta=meta)


def export_rollout(model, params=None, *, input_k: Sequence[int],
                   output_k: Sequence[int], forecast_cycle: int,
                   batch_size: int, block_size: int,
                   static: Optional[np.ndarray] = None,
                   n_bc_features: int = 0,
                   timestep_hours: Optional[float] = None,
                   feature_order: Optional[Sequence[str]] = None
                   ) -> ExportedRollout:
    """Export the block rollout of `model`, with `params` (a port state
    dict, see `weights.params_from_jax`) loaded when given, on the model's
    device.

    `static` are the prepared static features [V, F_static] as fed in
    training. Rollouts use stack_most_recent_prediction=True (no keep-first
    mask), as the JAX export does."""
    single, H, device = _prepare(model, params, input_k, output_k,
                                 forecast_cycle, block_size, static)
    meta = _meta(model, device, H, static, 0, input_k=input_k,
                 output_k=output_k, forecast_cycle=forecast_cycle,
                 batch_size=batch_size, block_size=block_size,
                 n_bc_features=n_bc_features, timestep_hours=timestep_hours,
                 feature_order=feature_order)
    return _export(single, meta, device)


def export_ensemble_rollout(model, member_params: Sequence[Dict], *,
                            input_k: Sequence[int], output_k: Sequence[int],
                            forecast_cycle: int, batch_size: int,
                            block_size: int,
                            static: Optional[np.ndarray] = None,
                            n_bc_features: int = 0,
                            timestep_hours: Optional[float] = None,
                            feature_order: Optional[Sequence[str]] = None
                            ) -> ExportedRollout:
    """Export a member-stacked ensemble rollout: `member_params` holds one
    port state dict per member (stacked DeepEnsemble checkpoints). The
    program rolls all members at once:

        call(hist [M, B, H, V, F] (, bc_block [B, S, n_in, V, Fb]))
            -> (new_hist [M, ...], preds [M, B, S, n_out, V, F])

    Members take the same boundary conditions; each member's predictions
    feed back into its own history. `ForecastService` starts every member
    from one analysis state."""
    if not member_params:
        raise ValueError("member_params is empty")
    single, H, device = _prepare(model, None, input_k, output_k,
                                 forecast_cycle, block_size, static)
    # one module per member, sharing the geometry, stacked by torch.func
    members = []
    for p in member_params:
        m = copy.deepcopy(model, memo={id(model.geometry): model.geometry})
        m.load_state_dict(p)
        members.append(m)
    stacked, _ = torch.func.stack_module_state(members)
    ensemble = _EnsembleRollout(single, {k: v.detach()
                                         for k, v in stacked.items()})
    meta = _meta(model, device, H, static, len(members), input_k=input_k,
                 output_k=output_k, forecast_cycle=forecast_cycle,
                 batch_size=batch_size, block_size=block_size,
                 n_bc_features=n_bc_features, timestep_hours=timestep_hours,
                 feature_order=feature_order)
    return _export(ensemble, meta, device)


def save_artifact(path, rollout: ExportedRollout, scaler=None,
                  scaler_bc=None) -> Path:
    """Write an ExportedRollout (and the scalers given) to a directory."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.export.save(rollout.program, path / _ARTIFACT_NAME)
    (path / _META_NAME).write_text(json.dumps(rollout.meta, indent=1))
    if scaler is not None:
        scaler.save(path / "scaler_dynamic.npz")
    if scaler_bc is not None:
        scaler_bc.save(path / "scaler_bc.npz")
    return path


def load_artifact(path):
    """-> (ExportedRollout, scaler | None, scaler_bc | None). Builds no
    model and no geometry."""
    from ..data.scalers import load_scaler
    from ..ops import bcsr  # noqa: F401  (registers the SpMM op)

    path = Path(path)
    meta = json.loads((path / _META_NAME).read_text())
    if meta["torch_version"] != torch.__version__:
        raise RuntimeError(f"{path} was exported with torch "
                           f"{meta['torch_version']}; this is torch "
                           f"{torch.__version__}: re-export it")
    if "cuda" in meta["platforms"] and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for {meta['platforms']} "
                           "but CUDA is not available here")
    program = torch.export.load(path / _ARTIFACT_NAME)
    scaler = scaler_bc = None
    if (path / "scaler_dynamic.npz").exists():
        scaler = load_scaler(path / "scaler_dynamic.npz")
    if (path / "scaler_bc.npz").exists():
        scaler_bc = load_scaler(path / "scaler_bc.npz")
    return ExportedRollout(program=program, meta=meta), scaler, scaler_bc
