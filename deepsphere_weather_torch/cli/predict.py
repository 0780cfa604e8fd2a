"""Standalone prediction driver (reference: scripts_training/predict_state.py).

Port of `deepsphere_weather_tpu/cli/predict.py`: loads a trained
experiment directory (config.json, tensor_info.json, model weights),
checks the tensor layout against the current data (`check_same_dict`,
reference predict_state.py:162), and runs long AR rollouts from explicit
forecast_reference_times into a zarr store, `ar_blocks` steps at a time
(reference defaults ar_iterations=500, ar_blocks=1000,
predict_state.py:223-224).

Usage:
    python -m deepsphere_weather_torch.cli.predict \\
        --model_dir EXP/<model-name> --data_dir DATA \\
        --forecast_reference_times 2010-11-01T00:00 2010-11-02T00:00 \\
        [--ar_iterations 500] [--ar_blocks 1000] [--device cpu]

The model runs on the card unless `--device cpu` asks for the CPU; without
CUDA the default raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(model_dir, data_dir, forecast_reference_times=None,
         ar_iterations: int = 500, ar_blocks: int = 1000,
         out_path=None, batch_size: int = 16, rounding=None,
         bc_generator=None, verbose: bool = True, device="cuda"):
    """`bc_generator`: callable(times)->[T,V,F_bc] for boundary conditions
    beyond the BC store (rollouts longer than the dataset), or the string
    'toa' for analytic top-of-atmosphere solar radiation."""
    from .._device import resolve_device
    from ..config import get_ar_settings, get_dataloader_settings
    from ..engine import AutoregressivePredictions
    from ..utils import Checkpointer
    from .common import load_experiment_model, open_datasets, resolve_scalers

    model_dir = Path(model_dir)
    device = resolve_device(device)
    datasets = open_datasets(data_dir)
    data_dynamic, data_bc, data_static = datasets
    cfg, model = load_experiment_model(model_dir, datasets, device)
    ar_settings = get_ar_settings(cfg)
    # BatchNorm models: eval-mode prediction needs the running statistics
    # checkpointed by training (norm_state.npz)
    norm_state = None
    if model.has_batch_norm:
        norm_state = Checkpointer(model_dir).load_norm_state(
            model.norm_state())
        if norm_state is None:
            raise FileNotFoundError(
                f"{model_dir}: batch_norm model has no "
                "model_weights/norm_state.npz — retrain or run "
                "prob.bn.bn_update to produce running statistics")
    # the trained model's own scaler composition (from its config.json):
    # predicting with a different scaler than training silently produces
    # garbage in physical units
    scaler, scaler_bc = resolve_scalers(get_dataloader_settings(cfg),
                                        data_dir)

    if forecast_reference_times is not None:
        forecast_reference_times = np.asarray(
            forecast_reference_times, dtype="datetime64[ns]")
    if out_path is None:
        out_path = (model_dir / "model_predictions" / "forecast_chunked"
                    / "long_forecasts.zarr")

    if bc_generator == "toa":
        from ..data.toy import toa_solar_radiation
        lat, lon = data_dynamic.lat, data_dynamic.lon

        def bc_generator(times):  # [T] -> [T, V, 1]
            return toa_solar_radiation(times, lat, lon)[..., None]

    forecast = AutoregressivePredictions(
        model, norm_state=norm_state,
        data_dynamic=data_dynamic, data_bc=data_bc,
        bc_generator=bc_generator, data_static=data_static,
        scaler=scaler, scaler_bc=scaler_bc,
        input_k=ar_settings["input_k"], output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        ar_iterations=ar_iterations, ar_blocks=ar_blocks,
        forecast_reference_times=forecast_reference_times,
        batch_size=batch_size, rounding=rounding,
        zarr_fpath=out_path, verbose=verbose,
    )
    if verbose:
        print(f"forecasts written to {out_path} "
              f"({forecast.n_frt} reference times x "
              f"{forecast.n_leadtime} leadtimes)")
    return forecast


def cli():
    p = argparse.ArgumentParser(description="Long AR rollout prediction")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--forecast_reference_times", nargs="*", default=None)
    p.add_argument("--ar_iterations", type=int, default=500)
    p.add_argument("--ar_blocks", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out_path", default=None)
    p.add_argument("--bc_generator", default=None, choices=[None, "toa"],
                   help="analytic BC source for rollouts beyond the BC store")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args()
    main(args.model_dir, args.data_dir,
         forecast_reference_times=args.forecast_reference_times,
         ar_iterations=args.ar_iterations, ar_blocks=args.ar_blocks,
         batch_size=args.batch_size, out_path=args.out_path,
         bc_generator=args.bc_generator, device=args.device)


if __name__ == "__main__":
    cli()
