"""SWAG fine-tuning and ensemble prediction driver.

Port of `deepsphere_weather_tpu/cli/finetune_swag.py` (reference
scripts_swag/finetune_swag.py:82-640): it loads a trained experiment,
resumes its AR scheduler (fine-tuning continues with the grown AR
weights), wraps its parameters in a SWAG posterior and collects them
once, then continues training with the SWA learning-rate recipe
(`engine.optim.swa_schedule`: the experiment's learning rate decayed to
`target_learning_rate` over `swa_start` updates, then held; the
experiment's gradient clipping) and collects the parameters every
`swag_freq`-th scoring interval. The fine-tune checkpoints land in
`<model_dir>/swag_finetune/` (the experiment's own weights stay), the
posterior in `model_weights/model_swag.npz`. Then `nb_samples` members are
sampled in turn (each BatchNorm model's statistics re-estimated on 50
training batches), predicted on the test period into
`model_predictions/swag/` (member, ensemble and median stores), the
median verified deterministically
(`model_skills/swag_median_global_skill.npz`) and, with 2 or more
members, the ensemble probabilistically
(`model_skills/swag_probabilistic_global_skill.npz`: CRPS, spread,
spread/skill).

Usage:
    python -m deepsphere_weather_torch.cli.finetune_swag \\
        --model_dir EXP/<model-name> --data_dir DATA [--nb_samples 5] \\
        [--epochs 1] [--swag_freq 2] [--swa_start 0] [--seed 0] \\
        [--device cpu]

The model runs on the card unless `--device cpu` asks for the CPU; without
CUDA the default raises. The members are drawn from a `torch.Generator`
seeded with `--seed`.

An experiment whose `n_data_parallel` x `n_node_parallel` mesh has more
than one rank fine-tunes on that many ranks, started here or by torchrun
(`cli/launch.py`); rank 0 alone then writes the posterior, samples,
predicts and verifies, while the others return.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(model_dir, data_dir, epochs: int = 1, nb_samples: int = 5,
         sampling_scale: float = 0.1, swag_freq: int = 2, swa_start: int = 0,
         max_num_models: int = 20, ar_iterations_prediction: int = 10,
         target_learning_rate: float = 0.001, seed: int = 0,
         verbose: bool = True, device="cuda"):
    import torch

    from .._device import ask_expandable_segments, resolve_device
    from ..config import (get_ar_settings, get_dataloader_settings,
                          get_model_settings, get_training_settings,
                          read_config_file)
    from ..engine import (Adam, ARScheduler, AreaWeights,
                          AutoregressiveTraining, swa_schedule)
    from ..prob import SWAG, AutoregressiveSWAGPredictions
    from ..parallel import training_mesh
    from ..sphere import build_sampling
    from ..utils import Checkpointer, set_deterministic_training
    from ..verif import deterministic, global_summary
    from ..verif import probabilistic as prob_verify
    from ..weights import broadcast_params
    from . import launch
    from .common import (load_experiment_model, open_datasets,
                         resolve_scalers, split_datasets)

    ask_expandable_segments()       # before the first CUDA allocation
    resolve_device(device)          # no card: raise before anything else
    # a mesh of more than one rank: start (or join) its ranks, each of
    # which runs this function in the process group
    launched = launch.launch(
        "deepsphere_weather_torch.cli.finetune_swag:main",
        launch.mesh_world(get_training_settings(read_config_file(
            Path(model_dir) / "config.json"))),
        dict(model_dir=model_dir, data_dir=data_dir, epochs=epochs,
             nb_samples=nb_samples, sampling_scale=sampling_scale,
             swag_freq=swag_freq, swa_start=swa_start,
             max_num_models=max_num_models,
             ar_iterations_prediction=ar_iterations_prediction,
             target_learning_rate=target_learning_rate, seed=seed,
             verbose=verbose, device=device))
    if launched is not launch.IN_GROUP:
        return launched

    model_dir = Path(model_dir)
    data_dir = Path(data_dir)
    device = resolve_device(device)
    datasets = open_datasets(data_dir)
    cfg, model = load_experiment_model(model_dir, datasets, device)
    data_dynamic, data_bc, data_static = datasets
    training_settings = get_training_settings(cfg)
    ar_settings = get_ar_settings(cfg)
    set_deterministic_training(
        bool(training_settings.get("deterministic_training", False)),
        seed=int(training_settings.get("seed_model_weights", 0)))
    # the experiment's own scaler composition and time split
    scaler, scaler_bc = resolve_scalers(get_dataloader_settings(cfg),
                                        data_dir)

    # --- SWAG posterior + the pretrained weights collected once
    #     (reference finetune_swag.py:226-231) ----------------------------
    swag = SWAG(model, max_num_models=max_num_models)
    swag.collect_model(model)

    split = split_datasets(training_settings, data_dynamic, data_bc)
    model_settings = get_model_settings(cfg)
    samp = build_sampling(model_settings["sampling"],
                          dict(model_settings["sampling_kwargs"]))
    area_w = AreaWeights(samp, device=device)

    # resume the pretrained run's AR scheduler: fine-tuning continues with
    # the grown AR weights (reference finetune_swag.py:298-303)
    ar_scheduler = None
    sched_state = Checkpointer(model_dir).load_scheduler_state()
    if sched_state is not None:
        ar_scheduler = ARScheduler.from_state_dict(sched_state)
        if verbose:
            print(f"resumed AR scheduler: {ar_scheduler.current_ar_iterations}"
                  f" AR iterations, weights "
                  f"{np.round(ar_scheduler.ar_weights, 3)}")

    # the SWA recipe (reference SWAG_settings.target_learning_rate,
    # Maddox et al. 2019), with the experiment's clipping
    base_lr = float(training_settings.get("learning_rate", 0.007))
    optimizer = Adam(
        model.parameters(), lr=base_lr,
        gradient_clipping=float(training_settings.get("gradient_clipping",
                                                      0.0) or 0.0),
        lr_schedule=swa_schedule(base_lr, float(target_learning_rate),
                                 int(swa_start)))
    # the main trainer's data x node mesh settings (None on 1 x 1)
    mesh = training_mesh(training_settings.get("n_data_parallel", 1),
                         training_settings.get("n_node_parallel", 1),
                         device=device)
    broadcast_params(model, mesh)
    model, _, info = AutoregressiveTraining(
        model,
        mesh=mesh,
        training_data_dynamic=split["train"],
        validation_data_dynamic=split["val"],
        training_data_bc=split["train_bc"],
        validation_data_bc=split["val_bc"],
        data_static=data_static, scaler=scaler, scaler_bc=scaler_bc,
        input_k=ar_settings["input_k"], output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        ar_iterations=ar_settings["ar_iterations"],
        ar_training_strategy=training_settings["ar_training_strategy"],
        area_weights=area_w,
        optimizer=optimizer,
        epochs=epochs,
        training_batch_size=training_settings["training_batch_size"],
        validation_batch_size=training_settings["validation_batch_size"],
        scoring_interval=training_settings["scoring_interval"],
        validation_batches=training_settings.get("validation_batches"),
        ar_scheduler=ar_scheduler,
        swag=True, swag_model=swag, swag_freq=swag_freq, swa_start=swa_start,
        # the fine-tune's own checkpoints: the experiment keeps its weights
        exp_dir=model_dir / "swag_finetune", num_workers=2, verbose=verbose,
    )
    # every rank holds the same posterior; rank 0 alone writes it, samples
    # the members, predicts and verifies
    launch.rank_barrier()
    if launch.rank() != 0:
        return None, None
    swag.save(model_dir / "model_weights" / "model_swag.npz")

    # --- ensemble predictions on the test period --------------------------
    test_dyn = split["test"]
    # BatchNorm models re-estimate running statistics per sampled member
    # (reference bn_update over the training period, utils_swag.py:58-165)
    bn_update_data = None
    if getattr(model, "has_batch_norm", False):
        bn_update_data = dict(
            data_dynamic=split["train"],
            data_bc=split["train_bc"],
            data_static=data_static, scaler=scaler, scaler_bc=scaler_bc,
            input_k=ar_settings["input_k"], output_k=ar_settings["output_k"],
            forecast_cycle=ar_settings["forecast_cycle"],
            ar_iterations=ar_settings["ar_iterations"],
            batch_size=training_settings["training_batch_size"],
            max_batches=50)
    out = AutoregressiveSWAGPredictions(
        model, swag,
        generator=torch.Generator(device=device).manual_seed(int(seed)),
        nb_samples=nb_samples, sampling_scale=sampling_scale,
        out_dir=model_dir / "model_predictions" / "swag",
        bn_update_data=bn_update_data,
        data_dynamic=test_dyn,
        data_bc=split["test_bc"],
        data_static=data_static, scaler=scaler, scaler_bc=scaler_bc,
        input_k=ar_settings["input_k"], output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        ar_iterations=ar_iterations_prediction,
        batch_size=training_settings["training_batch_size"],
    )
    # --- deterministic verification of the ensemble median ----------------
    area = area_w.cpu().numpy()
    skill = deterministic(out["median"], test_dyn)
    gs = global_summary(skill, area)
    gs.save(model_dir / "model_skills" / "swag_median_global_skill.npz")
    # --- probabilistic verification of the whole ensemble (CRPS,
    #     spread/skill; the reference left it a TODO) ---------------------
    if nb_samples >= 2:
        ps = prob_verify(out["ensemble"], test_dyn)
        pgs = global_summary(ps, area)
        pgs.save(model_dir / "model_skills"
                 / "swag_probabilistic_global_skill.npz")
        crps_msg = f"; CRPS at last leadtime: {np.round(pgs['CRPS'][-1], 3)}"
    else:
        crps_msg = " (probabilistic verify skipped: needs >= 2 members)"
    if verbose:
        print(f"SWAG ensemble ({nb_samples} members) verified; "
              f"median RMSE at last leadtime: "
              f"{np.round(gs['RMSE'][-1], 3)}{crps_msg}")
    out["info"] = info
    return out, gs


def cli():
    p = argparse.ArgumentParser(description="SWAG fine-tune + ensemble predict")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--nb_samples", type=int, default=5)
    p.add_argument("--sampling_scale", type=float, default=0.1)
    p.add_argument("--swag_freq", type=int, default=2)
    p.add_argument("--swa_start", type=int, default=0)
    p.add_argument("--max_num_models", type=int, default=20)
    p.add_argument("--target_learning_rate", type=float, default=0.001,
                   help="SWA collection-phase lr (reference "
                        "SWAG_settings.target_learning_rate)")
    p.add_argument("--ar_iterations_prediction", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the members' torch.Generator")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args()
    main(args.model_dir, args.data_dir, epochs=args.epochs,
         nb_samples=args.nb_samples, sampling_scale=args.sampling_scale,
         swag_freq=args.swag_freq, swa_start=args.swa_start,
         max_num_models=args.max_num_models,
         target_learning_rate=args.target_learning_rate,
         ar_iterations_prediction=args.ar_iterations_prediction,
         seed=args.seed, device=args.device)


if __name__ == "__main__":
    cli()
