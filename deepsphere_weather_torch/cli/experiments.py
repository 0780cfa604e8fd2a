"""Experiment sweep launchers.

Port of `deepsphere_weather_tpu/cli/experiments.py` (reference:
scripts_training/01-06_exp_*.py subprocess sweeps). The reference mutates
JSON configs and spawns `train_predict_state.py` subprocesses per run
(reference: 01_exp_reproducibility.py:52-88, 03_exp_samplings.py:39-57,
06_exp_DeepEnsemble.py:57-102); here each sweep is a function looping
over configs in process, with the JAX package's config rewriting and
output layout:

- reproducibility: seed regimes x repeats, with determinism as the oracle
- samplings/poolings/activations: grid over config values
- deep_ensemble: N members with different weight seeds, member stores,
  median verification (verify_DeepEnsemble.py parity); with
  `member_parallel` the members train together in the member step over a
  `models.MemberStack` (one launch per block-sparse product for all
  members; `training_settings.remat` recomputes each AR iteration in the
  backward there too)

Every training runs on `device` ("cuda" by default, raising without
CUDA; "cpu" for the plain versions).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import read_config_file, write_config_file

__all__ = ["run_reproducibility_experiment", "run_sweep",
           "run_deep_ensemble", "run_activation_experiment",
           "run_x_year_simulations", "REFERENCE_ACTIVATION_FUNS"]


def run_reproducibility_experiment(cfg_path, data_dir, exp_dir,
                                   n_models: int = 2,
                                   seed_regimes: Optional[List[Dict]] = None,
                                   verbose: bool = False,
                                   device="cuda") -> Dict:
    """Train repeats under seed regimes; returns final losses per run
    (reference 01_exp_reproducibility.py:49-304: fixed/random weights x
    fixed/random shuffling, determinism as the test oracle)."""
    from .train_predict import main as train_main

    cfg = read_config_file(cfg_path)
    if seed_regimes is None:
        seed_regimes = [
            {"name": "fixed_weights_fixed_shuffle",
             "seed_model_weights": 10, "seed_random_shuffling": 15},
            {"name": "random_weights_fixed_shuffle",
             "seed_model_weights": None, "seed_random_shuffling": 15},
        ]
    results = {}
    tmp_dir = Path(exp_dir) / "_tmp_configs"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for regime in seed_regimes:
        finals = []
        for i in range(n_models):
            c = copy.deepcopy(cfg)
            sw = regime["seed_model_weights"]
            if sw is None:
                sw = int(rng.integers(0, 2 ** 31))
            c["training_settings"]["seed_model_weights"] = sw
            c["training_settings"]["seed_random_shuffling"] = (
                regime["seed_random_shuffling"])
            c["model_settings"]["model_name_suffix"] = (
                f"{regime['name']}-run{i}")
            p = tmp_dir / f"{regime['name']}_run{i}.json"
            write_config_file(c, p)
            _, gs = train_main(p, data_dir, exp_dir, force=True,
                               ar_iterations_prediction=2, verbose=verbose,
                               device=device)
            finals.append(float(gs["RMSE"][-1].mean()))
        results[regime["name"]] = finals
    return results


def run_sweep(cfg_path, data_dir, exp_dir, sweep: Dict[str, List],
              section: str = "model_settings",
              verbose: bool = False, device="cuda") -> Dict:
    """Generic config sweep: one training per value combination
    (reference 03_exp_samplings.py / 03_exp_poolings.py /
    04_exp_activation_funs.py pattern); final-leadtime RMSE each."""
    from itertools import product

    from .train_predict import main as train_main

    cfg = read_config_file(cfg_path)
    keys = sorted(sweep)
    results = {}
    tmp_dir = Path(exp_dir) / "_tmp_configs"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    for combo in product(*(sweep[k] for k in keys)):
        c = copy.deepcopy(cfg)
        label_parts = []
        for k, v in zip(keys, combo):
            c[section][k] = v
            label_parts.append(f"{k}-{v}")
        label = "_".join(label_parts)
        c["model_settings"]["model_name_suffix"] = label
        p = tmp_dir / f"sweep_{label}.json"
        write_config_file(c, p)
        _, gs = train_main(p, data_dir, exp_dir, force=True,
                           ar_iterations_prediction=2, verbose=verbose,
                           device=device)
        results[label] = float(gs["RMSE"][-1].mean())
    return results


def _member_weights(model_settings, tensor_info, model_kwargs, geometry,
                    seed: int, device):
    """A member's initial state dict: the architecture's own
    initialisation from a generator seeded with `seed`, as
    `cli.train_predict` draws a model's (on the template's geometry)."""
    import torch

    from ..models import get_model

    return get_model(model_settings["architecture_name"], tensor_info,
                     device=device, geometry=geometry,
                     generator=torch.Generator(device=device).manual_seed(
                         int(seed)), **model_kwargs).state_dict()


def _train_members_parallel(cfg, data_dir, exp_dir, n_members: int,
                            ar_iterations_prediction: int,
                            verbose: bool, perturbation=None,
                            device="cuda") -> List:
    """Train every DeepEnsemble member in one loop
    (`AutoregressiveTraining(n_members=...)` over a `models.MemberStack`,
    the member step: the batch stream shared, one step advancing every
    member). Per-member weight seeds are the sequential path's (1000+m);
    as in the JAX package, the members share one shuffle stream instead
    of shuffling each on its own. Writes per-member experiment
    directories (config.json + model_weights/model.npz, usable by
    `cli.predict`) and returns the member ForecastDatasets."""
    import torch

    from .._device import resolve_device
    from ..config import (get_ar_settings, get_dataloader_settings,
                          get_model_name, get_model_settings,
                          get_training_settings)
    from ..data import get_ar_model_tensor_info
    from ..engine import (AreaWeights, AutoregressivePredictions,
                          AutoregressiveTraining, make_optimizer)
    from ..models import MemberStack, get_model
    from ..sphere import build_sampling
    from ..utils import Checkpointer
    from ..weights import member_state
    from .common import (build_schedulers, open_datasets, resolve_scalers,
                         split_datasets)

    device = resolve_device(device)
    model_settings = get_model_settings(cfg)
    training_settings = get_training_settings(cfg)
    ar_settings = get_ar_settings(cfg)
    dl_settings = get_dataloader_settings(cfg)
    data_dir = Path(data_dir)

    data_dynamic, data_bc, data_static = open_datasets(data_dir)
    # the scaler composition and time split of train_predict (cli/common.py)
    scaler, scaler_bc = resolve_scalers(dl_settings, data_dir,
                                        data_dynamic=data_dynamic,
                                        fit_default=True)
    split = split_datasets(training_settings, data_dynamic, data_bc)
    train_dyn, val_dyn, test_dyn = split["train"], split["val"], split["test"]
    train_bc, val_bc = split["train_bc"], split["val_bc"]

    tensor_info = get_ar_model_tensor_info(ar_settings, data_dynamic,
                                           data_static=data_static,
                                           data_bc=data_bc)
    model_kwargs = {k: v for k, v in model_settings.items()
                    if k != "architecture_name"}
    model_kwargs["pool_method"] = str(model_kwargs["pool_method"]).lower()
    model_kwargs["numeric_precision"] = training_settings.get(
        "numeric_precision", "float32")
    model = get_model(model_settings["architecture_name"], tensor_info,
                      device=device, **model_kwargs)
    # member-stacked init, the seeds of the sequential path
    stack = MemberStack.from_states(model, [
        _member_weights(model_settings, tensor_info, model_kwargs,
                        model.geometry, 1000 + m, device)
        for m in range(n_members)])

    samp = build_sampling(model_settings["sampling"],
                          dict(model_settings["sampling_kwargs"]))
    area_w = AreaWeights(samp, device=device)
    # the same AR-growth scheduler and convergence levers as the train CLI
    ar_scheduler, early_stopping, lever_kwargs = build_schedulers(
        training_settings, ar_settings)
    stack, _, info = AutoregressiveTraining(
        stack,
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
        stack_most_recent_prediction=ar_settings[
            "stack_most_recent_prediction"],
        ar_training_strategy=training_settings["ar_training_strategy"],
        area_weights=area_w,
        optimizer=make_optimizer(stack.parameters(), training_settings,
                                 member_axis=True),
        ar_scheduler=ar_scheduler,
        early_stopping=early_stopping,
        **lever_kwargs,
        exp_dir=Path(exp_dir) / "_member_parallel_ckpt",
        epochs=training_settings["epochs"],
        training_batch_size=training_settings["training_batch_size"],
        validation_batch_size=training_settings["validation_batch_size"],
        scoring_interval=training_settings["scoring_interval"],
        validation_batches=training_settings.get("validation_batches"),
        remat=bool(training_settings.get("remat", False)),
        num_workers=dl_settings["num_workers"],
        device_cache=dl_settings.get("device_cache", "auto"),
        shuffle=dl_settings["random_shuffling"],
        shuffle_seed=int(training_settings["seed_random_shuffling"]),
        n_members=n_members,
        verbose=verbose,
    )

    member_forecasts = []
    stacked = {k: v.detach() for k, v in stack.state_dict().items()}
    for m in range(n_members):
        c = copy.deepcopy(cfg)
        c["training_settings"]["seed_model_weights"] = 1000 + m
        c["model_settings"]["model_name_suffix"] = f"member{m}"
        exp_path = Path(exp_dir) / get_model_name(c)
        exp_path.mkdir(parents=True, exist_ok=True)
        write_config_file(c, exp_path / "config.json")
        (exp_path / "tensor_info.json").write_text(
            json.dumps(tensor_info, indent=1, default=str))
        with torch.no_grad():
            model.load_state_dict(member_state(stacked, m))
        Checkpointer(exp_path).save_model(model)
        info.save(exp_path / "training_info" / "ar_training_info.json")
        forecast = AutoregressivePredictions(
            model,
            data_dynamic=test_dyn,
            data_bc=split["test_bc"],
            data_static=data_static,
            scaler=scaler, scaler_bc=scaler_bc,
            input_k=ar_settings["input_k"],
            output_k=ar_settings["output_k"],
            forecast_cycle=ar_settings["forecast_cycle"],
            ar_iterations=ar_iterations_prediction,
            batch_size=training_settings["training_batch_size"],
            zarr_fpath=exp_path / "model_predictions" / "forecast_chunked"
            / "test_forecasts.zarr",
            perturbation=(dict(perturbation, seed=5000 + m)
                          if perturbation is not None else None),
            verbose=verbose,
        )
        member_forecasts.append(forecast)
    return member_forecasts


def run_deep_ensemble(cfg_path, data_dir, exp_dir, n_members: int = 5,
                      ar_iterations_prediction: int = 4,
                      member_parallel: bool = False,
                      perturbation=None,
                      verbose: bool = False, device="cuda") -> Dict:
    """DeepEnsemble: train n members with different weight seeds, run
    member predictions, verify the ensemble median
    (reference 06_exp_DeepEnsemble.py:57-102 + verify_DeepEnsemble.py).

    member_parallel=True trains all members together in the member step
    (`_train_members_parallel`) instead of the reference's sequential
    per-member runs.

    `perturbation` ({basis, ic_sigma, step_sigma}, see
    `engine.AutoregressivePredictions`) turns the member rollouts into a
    perturbed-analysis and stochastic-model-error ensemble; each member
    gets its own noise seed (5000+m).

    Writes <exp_dir>/DeepEnsemble/{ensemble,median}.zarr,
    median_global_skill.npz and, with 2 or more members,
    probabilistic_global_skill.npz."""
    from ..config import get_training_settings
    from ..data import SphericalDataset
    from ..engine import AreaWeights, ForecastDataset
    from ..prob import build_ensemble_store, ensemble_median
    from ..sphere import build_sampling
    from ..verif import deterministic, global_summary
    from .common import split_datasets
    from .train_predict import main as train_main

    cfg = read_config_file(cfg_path)
    if member_parallel:
        member_forecasts = _train_members_parallel(
            cfg, data_dir, exp_dir, n_members, ar_iterations_prediction,
            verbose, perturbation=perturbation, device=device)
    else:
        tmp_dir = Path(exp_dir) / "_tmp_configs"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        member_forecasts = []
        for m in range(n_members):
            c = copy.deepcopy(cfg)
            c["training_settings"]["seed_model_weights"] = 1000 + m
            c["model_settings"]["model_name_suffix"] = f"member{m}"
            p = tmp_dir / f"ensemble_member{m}.json"
            write_config_file(c, p)
            exp_path, _ = train_main(
                p, data_dir, exp_dir, force=True,
                ar_iterations_prediction=ar_iterations_prediction,
                verbose=verbose, device=device)
            member_forecasts.append(ForecastDataset.open(
                exp_path / "model_predictions" / "forecast_chunked"
                / "test_forecasts.zarr"))

    ens_dir = Path(exp_dir) / "DeepEnsemble"
    ens_dir.mkdir(parents=True, exist_ok=True)
    ensemble = build_ensemble_store(member_forecasts,
                                    ens_dir / "ensemble.zarr")
    median = ensemble_median(ensemble, ens_dir / "median.zarr")

    # verify the median against the test split
    data_dynamic = SphericalDataset.open(
        Path(data_dir) / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr")
    test_dyn = split_datasets(get_training_settings(cfg),
                              data_dynamic)["test"]
    ms = cfg["model_settings"]
    samp = build_sampling(ms["sampling"], dict(ms["sampling_kwargs"]))
    skill = deterministic(median, test_dyn)
    area_w = AreaWeights(samp, device="cpu").numpy()
    gs = global_summary(skill, area_w)
    gs.save(ens_dir / "median_global_skill.npz")
    # probabilistic verification of the member ensemble (CRPS,
    # spread/skill); a fair CRPS needs 2 members or more
    pgs = None
    if n_members >= 2:
        from ..verif import probabilistic as prob_verify

        pgs = global_summary(prob_verify(ensemble, test_dyn), area_w)
        pgs.save(ens_dir / "probabilistic_global_skill.npz")
    return {"ensemble": ensemble, "median": median, "global_skill": gs,
            "probabilistic_skill": pgs}


# The reference's activation ablation list (04_exp_activation_funs.py:47-52)
REFERENCE_ACTIVATION_FUNS = [
    "relu", "celu", "selu", "prelu", "hardswish", "mish",
    "silu", "gelu", "softplus", "softmax", "logsigmoid",
    "relu6", "rrelu", "leaky_relu", "elu",
    "linear", "hardshrink",
    "sigmoid", "hardsigmoid",
    "tanh", "hardtanh", "softsign",
]


def run_activation_experiment(cfg_path, data_dir, exp_dir,
                              act_funs: Optional[List[str]] = None,
                              verbose: bool = False, device="cuda") -> Dict:
    """Activation-function ablation (reference 04_exp_activation_funs.py):
    one training per activation, final-leadtime RMSE each."""
    if act_funs is None:
        act_funs = REFERENCE_ACTIVATION_FUNS
    return run_sweep(cfg_path, data_dir, exp_dir,
                     sweep={"activation_fun": act_funs}, verbose=verbose,
                     device=device)


def run_x_year_simulations(model_dir, data_dir, years: float = 5.0,
                           dt_hours: Optional[int] = None,
                           forecast_reference_times=None,
                           ar_blocks: int = 1000,
                           bc_generator="toa", verbose: bool = True,
                           device="cuda"):
    """Multi-year free-running simulation from a trained model
    (reference 05_exp_X_year_sims.py: 7300 AR steps = 5 years at 6 h,
    ar_blocks-chunked zarr flushing). The step length defaults to the
    model's own forecast_cycle (hours) from its config.json; the analytic
    TOA-solar generator supplies the forcing beyond the BC store by
    default."""
    from .predict import main as predict_main

    if dt_hours is None:
        cfg = read_config_file(Path(model_dir) / "config.json")
        dt_hours = int(cfg["ar_settings"]["forecast_cycle"])
    ar_iterations = int(round(years * 365 * 24 / dt_hours))
    return predict_main(model_dir, data_dir,
                        forecast_reference_times=forecast_reference_times,
                        ar_iterations=ar_iterations, ar_blocks=ar_blocks,
                        bc_generator=bc_generator, verbose=verbose,
                        device=device)
