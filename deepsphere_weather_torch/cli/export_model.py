"""Export a trained experiment directory to a serving artifact.

Port of `deepsphere_weather_tpu/cli/export_model.py`: writes the
`torch.export` program of the AR block rollout (trained parameters,
static features and the geometry's operator arrays in it) and the data
scalers, everything `serve.ForecastService.from_dir` needs, without the
model-building code at load time.

Usage:
    python -m deepsphere_weather_torch.cli.export_model \\
        --model_dir EXP/<model-name> --data_dir DATA \\
        --out artifacts/<model-name> [--batch_size 4] [--block_size 10] \\
        [--member_dirs EXP1/<model-name> EXP2/<model-name>] \\
        [--swag_samples N [--sampling_scale 0.5] [--no_swag_cov] \\
         [--seed 0]] [--device cpu]

The artifact is exported on the card unless `--device cpu` asks for the
CPU (without CUDA the default raises); it loads on that device type only.
The scalers are the data directory's GlobalStandardScaler_{dynamic,bc}.npz
files, as the JAX driver reads them, whatever scaler the experiment's
config names.

A BatchNorm model is exported as the JAX package exports it: the rollout
carries no running statistics, so the artifact normalizes with each
batch's statistics, and `swag_samples` members get no `bn_update` (a
reference defect, ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(model_dir, data_dir, out=None, batch_size: int = 4,
         block_size: int = 10, swag_samples: int = 0,
         sampling_scale: float = 0.5, swag_cov: bool = True,
         member_dirs=None, seed: int = 0, verbose: bool = True,
         device="cuda"):
    """Ensemble artifacts, rolled out in one member-stacked program:
    `swag_samples=N` samples N member parameter sets from the experiment's
    SWAG posterior (model_weights/model_swag.npz; a `torch.Generator`
    seeded with `seed` on the export device draws them); `member_dirs`
    stacks the checkpoints of separately trained DeepEnsemble members (of
    `model_dir`'s configuration)."""
    from .._device import resolve_device
    from ..config import get_ar_settings
    from ..data import load_scaler
    from ..serve import export_ensemble_rollout, export_rollout, save_artifact
    from ..utils import Checkpointer
    from .common import load_experiment_model, open_datasets

    if member_dirs and swag_samples:
        raise ValueError("pass either member_dirs or swag_samples, not both")
    model_dir, data_dir = Path(model_dir), Path(data_dir)
    device = resolve_device(device)
    datasets = open_datasets(data_dir)
    data_dynamic, data_bc, data_static = datasets
    scaler_path = data_dir / "Scalers" / "GlobalStandardScaler_dynamic.npz"
    scaler = load_scaler(scaler_path) if scaler_path.exists() else None
    scaler_bc_path = data_dir / "Scalers" / "GlobalStandardScaler_bc.npz"
    scaler_bc = (load_scaler(scaler_bc_path) if scaler_bc_path.exists()
                 else None)
    cfg, model = load_experiment_model(model_dir, datasets, device)
    ar_settings = get_ar_settings(cfg)

    member_params = None
    if member_dirs:
        member_params = []
        for d in member_dirs:
            Checkpointer(Path(d)).load_model(model)
            member_params.append({k: v.clone()
                                  for k, v in model.state_dict().items()})
    elif swag_samples:
        import torch

        from ..prob import SWAG
        swag = SWAG(model)
        swag.load(model_dir / "model_weights" / "model_swag.npz")
        generator = torch.Generator(device=device).manual_seed(int(seed))
        member_params = [swag.sample(generator, scale=sampling_scale,
                                     cov=swag_cov)
                         for _ in range(swag_samples)]

    timestep_hours = float(data_dynamic.timestep / np.timedelta64(1, "h"))
    export_kwargs = dict(
        input_k=ar_settings["input_k"], output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        batch_size=batch_size, block_size=block_size,
        static=data_static.read_stacked() if data_static is not None else None,
        n_bc_features=data_bc.n_feature if data_bc is not None else 0,
        timestep_hours=timestep_hours,
        feature_order=list(data_dynamic.feature_order))
    if member_params is not None:
        rollout = export_ensemble_rollout(model, member_params,
                                          **export_kwargs)
    else:
        rollout = export_rollout(model, **export_kwargs)

    if out is None:
        out = model_dir / "artifact"
    save_artifact(out, rollout, scaler=scaler, scaler_bc=scaler_bc)
    if verbose:
        size = sum(f.stat().st_size for f in Path(out).rglob("*")
                   if f.is_file())
        kind = (f"{rollout.n_members}-member ensemble "
                if member_params is not None else "")
        print(f"exported {model.__class__.__name__} {kind}rollout (batch "
              f"{batch_size} x block {block_size}, {device.type}) to {out} "
              f"({size / 1e6:.1f} MB)")
    return Path(out)


def cli():
    p = argparse.ArgumentParser(description="Export a serving artifact")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--block_size", type=int, default=10)
    p.add_argument("--swag_samples", type=int, default=0)
    p.add_argument("--sampling_scale", type=float, default=0.5)
    p.add_argument("--no_swag_cov", action="store_true")
    p.add_argument("--member_dirs", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args()
    main(a.model_dir, a.data_dir, out=a.out, batch_size=a.batch_size,
         block_size=a.block_size, swag_samples=a.swag_samples,
         sampling_scale=a.sampling_scale, swag_cov=not a.no_swag_cov,
         member_dirs=a.member_dirs, seed=a.seed, device=a.device)


if __name__ == "__main__":
    cli()
