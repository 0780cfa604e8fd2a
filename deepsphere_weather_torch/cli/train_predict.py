"""Main train + predict + verify driver.

Port of `deepsphere_weather_tpu/cli/train_predict.py` (reference:
scripts_training/train_predict_state.py:136-632): config -> open zarr
stores -> scalers -> train/val/test time split -> tensor_info -> model
build -> area-weighted loss -> Adam -> AR scheduler + early stopping ->
AutoregressiveTraining -> AutoregressivePredictions (AR=20) -> rechunk ->
deterministic verification + global summary -> plots. It writes the JAX
driver's experiment directory, named by the same model name, the plots
under `figs/` included. The plot step imports the plotting package (and
with it matplotlib) only then; on a machine without matplotlib it prints
`plots skipped: matplotlib is not installed` and writes no figure, the
one absent package the driver tolerates.

Usage:
    python -m deepsphere_weather_torch.cli.train_predict \
        --config_file cfg.json --data_dir DATA --exp_dir EXP [--force] \
        [--resume] [--device cpu]

The model runs on the card unless `--device cpu` (or `device="cpu"`) asks
for the CPU, where every kernel runs its plain PyTorch version; without
CUDA the default raises rather than falling back.

A config whose `n_data_parallel` x `n_node_parallel` mesh has more than
one rank starts its ranks itself (or joins torchrun's; `cli/launch.py`):
every rank trains its shard, then rank 0 alone predicts on the whole
geometry, rechunks, verifies and writes, while the others return.

Data directory layout (written by the preprocessing/toy pipeline):
    <data_dir>/Data/dynamic/time_chunked/dynamic.zarr
    <data_dir>/Data/bc/time_chunked/bc.zarr
    <data_dir>/Data/static.zarr
    <data_dir>/Scalers/...
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def main(cfg_path, data_dir, exp_dir, force: bool = False,
         resume: bool = False,
         ar_iterations_prediction: int = 20, seed_override=None,
         verbose: bool = True, device="cuda"):
    import torch

    from .._device import ask_expandable_segments, resolve_device
    from ..config import (
        create_experiment_directories,
        get_ar_settings,
        get_dataloader_settings,
        get_model_name,
        get_model_settings,
        get_training_settings,
        read_config_file,
        write_config_file,
    )
    from ..data import get_ar_model_tensor_info
    from ..data.zarrstore import read_bytes_counter
    from ..engine import (
        AreaWeights,
        AutoregressivePredictions,
        AutoregressiveTraining,
        make_optimizer,
        rechunk_forecasts_for_verification,
    )
    from ..engine.scheduler import ARScheduler, EarlyStopping
    from ..models import get_model
    from ..parallel import training_mesh
    from ..sphere import build_sampling
    from ..utils import Checkpointer, set_deterministic_training
    from ..verif import deterministic, global_summary
    from ..weights import broadcast_params
    from .common import (build_schedulers, open_datasets, resolve_scalers,
                         split_datasets)

    from . import launch

    t_start = time.time()
    cfg = read_config_file(cfg_path)
    model_settings = get_model_settings(cfg)
    training_settings = get_training_settings(cfg)
    ar_settings = get_ar_settings(cfg)
    dl_settings = get_dataloader_settings(cfg)
    if seed_override is not None:
        training_settings["seed_model_weights"] = seed_override
    ask_expandable_segments()       # before the first CUDA allocation
    resolve_device(device)          # no card: raise before anything else
    # a mesh of more than one rank: start (or join) its ranks, each of
    # which runs this function in the process group
    launched = launch.launch(
        "deepsphere_weather_torch.cli.train_predict:main",
        launch.mesh_world(training_settings),
        dict(cfg_path=cfg_path, data_dir=data_dir, exp_dir=exp_dir,
             force=force, resume=resume,
             ar_iterations_prediction=ar_iterations_prediction,
             seed_override=seed_override, verbose=verbose, device=device))
    if launched is not launch.IN_GROUP:
        return launched
    # rank 0 writes (the directories, the config copies, the fitted
    # scaler, the predictions and the skills; the trainer's checkpoints)
    writer = launch.rank() == 0

    # reference: set_pytorch_settings -> deterministic seeding
    # (utils_config.py:444-455); before the first CUDA work
    set_deterministic_training(
        bool(training_settings.get("deterministic_training", False)),
        seed=int(training_settings.get("seed_model_weights", 0)))
    device = resolve_device(device)

    data_dir = Path(data_dir)

    # --- open data --------------------------------------------------------
    data_dynamic, data_bc, data_static = open_datasets(data_dir)

    # --- scaler (config-selected composition, the GlobalStandardScaler
    #     fitted and saved when none is given) ----------------------------
    scaler, scaler_bc = resolve_scalers(dl_settings, data_dir,
                                        data_dynamic=data_dynamic,
                                        fit_default=True,
                                        save_fitted=writer)

    # --- time split: explicit date ranges from config or the fractional
    #     70/15/15 index split --------------------------------------------
    split = split_datasets(training_settings, data_dynamic, data_bc)
    train_dyn, val_dyn, test_dyn = split["train"], split["val"], split["test"]
    train_bc, val_bc = split["train_bc"], split["val_bc"]
    (te_lo, te_hi) = split["bounds"][2]

    # --- tensor info + model ---------------------------------------------
    tensor_info = get_ar_model_tensor_info(ar_settings, data_dynamic,
                                           data_static=data_static,
                                           data_bc=data_bc)
    model_kwargs = {k: v for k, v in model_settings.items()
                    if k != "architecture_name"}
    model_kwargs["pool_method"] = str(model_kwargs["pool_method"]).lower()
    model_kwargs["numeric_precision"] = training_settings.get(
        "numeric_precision", "float32")
    generator = torch.Generator(device=device).manual_seed(
        int(training_settings["seed_model_weights"]))
    model = get_model(model_settings["architecture_name"], tensor_info,
                      device=device, generator=generator, **model_kwargs)
    # fine-tune from a previous experiment's weights
    # (reference: train_predict_state.py:272-274, load_pretrained_model)
    pretrained = model_settings.get("pretrained_model_name")
    if pretrained:
        src = Path(exp_dir) / str(pretrained)
        if not (src / "model_weights" / "model.npz").exists():
            raise FileNotFoundError(
                f"pretrained_model_name: no weights at "
                f"{src / 'model_weights' / 'model.npz'}")
        Checkpointer(src).load_model(model)
        print(f"loaded pretrained weights from {pretrained}")

    # --- experiment dir ---------------------------------------------------
    model_name = get_model_name(cfg)
    exp_path = Path(exp_dir) / model_name
    if writer:
        exp_path = create_experiment_directories(exp_dir, model_name,
                                                 force=force, resume=resume)
        write_config_file(cfg, exp_path / "config.json")
        (exp_path / "tensor_info.json").write_text(
            json.dumps(tensor_info, indent=1, default=str))
    # the other ranks read nothing of it before rank 0 has made it
    launch.rank_barrier()

    # --- optimizer; a resumed run loads params, optimizer moments and the
    #     grown AR-scheduler and early-stopping state ----------------------
    optimizer = make_optimizer(model.parameters(), training_settings)
    resumed_scheduler = None
    resumed_early_stopping = None
    initial_norm_state = None
    if resume:
        ck = Checkpointer(exp_path)
        if not ck.has_checkpoint():
            raise FileNotFoundError(
                f"--resume: no checkpoint at "
                f"{exp_path / 'model_weights' / 'model.npz'} — nothing to "
                "resume (use --force for a fresh run)")
        ck.load_model(model)
        if model.has_batch_norm:
            # resuming trained BatchNorm weights with fresh running
            # statistics would corrupt eval-mode validation (and the early
            # stopping and AR growth it decides) until they re-converge
            initial_norm_state = ck.load_norm_state(model.norm_state())
            if initial_norm_state is None:
                raise FileNotFoundError(
                    f"--resume: batch_norm model but no running stats at "
                    f"{exp_path / 'model_weights' / 'norm_state.npz'}. "
                    "Re-estimate them via prob.bn.bn_update, or retrain.")
        sched_state = ck.load_scheduler_state()
        if sched_state is not None:
            _state = ck.load_training_state(optimizer, model)
            resumed_scheduler = ARScheduler.from_state_dict(sched_state)
            es_state = _state.get("early_stopping")
            if es_state is not None:
                resumed_early_stopping = EarlyStopping.from_state_dict(
                    es_state)
        if verbose:
            print(f"resuming {model_name} from checkpoint")

    # --- loss / schedulers ------------------------------------------------
    samp = build_sampling(model_settings["sampling"],
                          dict(model_settings["sampling_kwargs"]))
    area_w = AreaWeights(samp, device=device)
    ar_scheduler0, early_stopping0, lever_kwargs = build_schedulers(
        training_settings, ar_settings)
    ar_scheduler = resumed_scheduler or ar_scheduler0
    early_stopping = resumed_early_stopping or early_stopping0

    # --- training ---------------------------------------------------------
    # data x node mesh from the config (None on 1 x 1: one process)
    mesh = training_mesh(training_settings.get("n_data_parallel", 1),
                         training_settings.get("n_node_parallel", 1),
                         device=device)
    if mesh is not None and verbose:
        print(f"training mesh: {mesh.n_data} (data) x {mesh.n_node} (node)")
    # every rank trains from rank 0's weights
    broadcast_params(model, mesh)

    model, optimizer, info = AutoregressiveTraining(
        model,
        training_data_dynamic=train_dyn,
        validation_data_dynamic=val_dyn,
        training_data_bc=train_bc,
        validation_data_bc=val_bc,
        data_static=data_static,
        scaler=scaler, scaler_bc=scaler_bc,
        input_k=ar_settings["input_k"],
        output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        ar_iterations=ar_settings["ar_iterations"],
        stack_most_recent_prediction=ar_settings["stack_most_recent_prediction"],
        ar_training_strategy=training_settings["ar_training_strategy"],
        area_weights=area_w,
        optimizer=optimizer,
        ar_scheduler=ar_scheduler,
        early_stopping=early_stopping,
        **lever_kwargs,
        epochs=training_settings["epochs"],
        training_batch_size=training_settings["training_batch_size"],
        validation_batch_size=training_settings["validation_batch_size"],
        scoring_interval=training_settings["scoring_interval"],
        validation_batches=training_settings.get("validation_batches"),
        save_model_each_epoch=training_settings["save_model_each_epoch"],
        exp_dir=exp_path,
        mesh=mesh,
        remat=bool(training_settings.get("remat", False)),
        num_workers=dl_settings["num_workers"],
        prefetch_factor=dl_settings["prefetch_factor"],
        autotune_num_workers=dl_settings.get("autotune_num_workers", False),
        device_cache=dl_settings.get("device_cache", "auto"),
        shuffle=dl_settings["random_shuffling"],
        shuffle_seed=int(training_settings["seed_random_shuffling"]),
        initial_norm_state=initial_norm_state,
        verbose=verbose,
    )

    # every rank holds the trained parameters and the whole geometry again;
    # rank 0 alone predicts and writes
    launch.rank_barrier()
    if not writer:
        return exp_path, None
    plotting = _plotting()
    if plotting is not None:
        info.plots(exp_path)

    # --- prediction on the test period (reference: AR=20 -> +120 h,
    #     train_predict_state.py:484) --------------------------------------
    # BatchNorm models predict in eval mode with the running statistics
    # accumulated during training (the bn_update pass is for SWAG-sampled
    # weights, whose statistics training never saw)
    forecast = AutoregressivePredictions(
        model,
        norm_state=model.norm_state() if model.has_batch_norm else None,
        data_dynamic=test_dyn,
        data_bc=data_bc.subset(te_lo, te_hi) if data_bc else None,
        data_static=data_static,
        scaler=scaler, scaler_bc=scaler_bc,
        input_k=ar_settings["input_k"],
        output_k=ar_settings["output_k"],
        forecast_cycle=ar_settings["forecast_cycle"],
        ar_iterations=ar_iterations_prediction,
        batch_size=training_settings["training_batch_size"],
        zarr_fpath=exp_path / "model_predictions" / "forecast_chunked"
        / "test_forecasts.zarr",
        keep_in_memory=True,
        verbose=verbose,
    )
    # the space-chunked copy is still written (the experiment directory's
    # contract), straight from the rollout's RAM buffer when it fit;
    # verification reads that buffer too
    t_re = time.time()
    b_re = read_bytes_counter()
    forecast_rechunked = rechunk_forecasts_for_verification(
        forecast,
        exp_path / "model_predictions" / "space_chunked"
        / "test_forecasts.zarr")

    # --- verification -----------------------------------------------------
    t_ve = time.time()
    b_ve = read_bytes_counter()
    skill = deterministic(
        forecast if forecast.in_memory else forecast_rechunked, test_dyn)
    skill.save(exp_path / "model_skills" / "deterministic_spatial_skill.npz")
    gs = global_summary(skill, area_w.cpu().numpy())
    gs.save(exp_path / "model_skills" / "deterministic_global_skill.npz")
    (exp_path / "model_skills" / "verify_stats.json").write_text(json.dumps({
        "forecast_in_memory": bool(forecast.in_memory),
        "rechunk_wall_s": round(t_ve - t_re, 1),
        "rechunk_read_gb": round((b_ve - b_re) / 1e9, 3),
        "verify_wall_s": round(time.time() - t_ve, 1),
        "verify_read_gb": round((read_bytes_counter() - b_ve) / 1e9, 3),
    }, indent=1))

    # --- plots ------------------------------------------------------------
    if plotting is not None:
        plotting.plot_global_skills(gs, exp_path / "figs" / "skills")
        plotting.plot_skill_maps(skill, exp_path / "figs" / "skills",
                                 sampling=samp)

    if verbose:
        rmse_last = gs["RMSE"][-1]
        print(f"[{model_name}] done in {time.time() - t_start:.0f}s; "
              f"final-leadtime RMSE per var: "
              f"{dict(zip(tensor_info['feature_order']['dynamic'], np.round(rmse_last, 3)))}")
    return exp_path, gs


def _plotting():
    """The plotting package, imported at the plot step; None, with one
    printed line, where matplotlib is not installed (plots are neither
    the device nor a kernel; any other import error raises)."""
    try:
        from .. import plotting
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print("plots skipped: matplotlib is not installed")
        return None
    return plotting


def cli():
    p = argparse.ArgumentParser(description="Train + predict + verify")
    p.add_argument("--config_file", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--force", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue a stopped run from its checkpoint "
                        "(params + optimizer moments + AR scheduler)")
    p.add_argument("--ar_iterations_prediction", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args()
    main(args.config_file, args.data_dir, args.exp_dir, force=args.force,
         resume=args.resume,
         ar_iterations_prediction=args.ar_iterations_prediction,
         device=args.device)


if __name__ == "__main__":
    cli()
