"""Shared CLI data-resolution helpers.

Port of `deepsphere_weather_tpu/cli/common.py`. Every driver must resolve
the SAME scaler composition and train/val/test time split from a config:
a model predicted with a different scaler than it was trained with
silently produces garbage, and a split that disagrees with the configured
test_period leaks test data into training. (Reference anchors:
SequentialScaler composition in the driver, train_predict_state.py:
205-212; pinned year split, :217-236.) Any scaler file of either package
resolves, the time-grouped anomaly and climatology scalers included.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

__all__ = ["resolve_scalers", "split_datasets", "build_schedulers",
           "open_datasets", "load_experiment_model"]


def open_datasets(data_dir) -> Tuple:
    """(dynamic, bc or None, static or None) datasets of a data directory:
    <data_dir>/Data/dynamic/time_chunked/dynamic.zarr,
    <data_dir>/Data/bc/time_chunked/bc.zarr and <data_dir>/Data/static.zarr.
    """
    from ..data import SphericalDataset, StaticDataset

    data_dir = Path(data_dir)
    data_dynamic = SphericalDataset.open(
        data_dir / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr")
    bc_path = data_dir / "Data" / "bc" / "time_chunked" / "bc.zarr"
    data_bc = SphericalDataset.open(bc_path) if bc_path.exists() else None
    static_path = data_dir / "Data" / "static.zarr"
    data_static = (StaticDataset.open(static_path)
                   if static_path.exists() else None)
    return data_dynamic, data_bc, data_static


def load_experiment_model(model_dir, datasets: Tuple, device="cuda"):
    """-> (config, model) of a trained experiment directory: the model its
    config.json describes, at the precision it was trained with, on
    `device`, with the weights of model_weights/model.npz. The tensor
    layout the data gives is checked against the experiment's
    tensor_info.json (reference predict_state.py:162)."""
    import json

    from ..config import (check_same_dict, get_ar_settings,
                          get_model_settings, get_training_settings,
                          read_config_file)
    from ..data import get_ar_model_tensor_info
    from ..models import get_model
    from ..utils import Checkpointer

    model_dir = Path(model_dir)
    cfg = read_config_file(model_dir / "config.json")
    model_settings = get_model_settings(cfg)
    data_dynamic, data_bc, data_static = datasets
    tensor_info = get_ar_model_tensor_info(get_ar_settings(cfg), data_dynamic,
                                           data_static=data_static,
                                           data_bc=data_bc)
    saved_info_path = model_dir / "tensor_info.json"
    if saved_info_path.exists():
        check_same_dict(json.loads(json.dumps(tensor_info, default=str)),
                        json.loads(saved_info_path.read_text()))
    model_kwargs = {k: v for k, v in model_settings.items()
                    if k != "architecture_name"}
    model_kwargs["pool_method"] = str(model_kwargs["pool_method"]).lower()
    # the precision the model was trained with (a bf16-trained model must
    # not predict in fp32)
    model_kwargs["numeric_precision"] = get_training_settings(cfg).get(
        "numeric_precision", "float32")
    model = get_model(model_settings["architecture_name"], tensor_info,
                      device=device, **model_kwargs)
    Checkpointer(model_dir).load_model(model)
    return cfg, model.eval()


def resolve_scalers(dl_settings: Dict, data_dir, data_dynamic=None,
                    fit_default: bool = False,
                    save_fitted: bool = False) -> Tuple:
    """-> (scaler, scaler_bc) from dataloader_settings.

    `scaler_dynamic` / `scaler_bc` select the on-the-fly scaler from JSON:
    a single file (relative paths resolve under <data_dir>/Scalers) or a
    list composed into a SequentialScaler. When unset, falls back to the
    conventional GlobalStandardScaler_{dynamic,bc}.npz files;
    `fit_default=True` fits a fresh GlobalStandardScaler on
    `data_dynamic` when even that file is missing (and writes it back
    with `save_fitted=True`).
    """
    from ..data import GlobalStandardScaler, SequentialScaler, load_scaler

    data_dir = Path(data_dir)
    base = data_dir / "Scalers"

    def resolve(spec):
        if spec is None:
            return None
        if isinstance(spec, (list, tuple)):
            return SequentialScaler(
                *[load_scaler(p if Path(p).is_absolute() else base / p)
                  for p in spec])
        return load_scaler(spec if Path(spec).is_absolute() else base / spec)

    scaler = resolve(dl_settings.get("scaler_dynamic"))
    if scaler is None:
        scaler_path = base / "GlobalStandardScaler_dynamic.npz"
        if scaler_path.exists():
            scaler = load_scaler(scaler_path)
        elif fit_default and data_dynamic is not None:
            scaler = GlobalStandardScaler().fit_dataset(data_dynamic)
            if save_fitted:
                scaler_path.parent.mkdir(parents=True, exist_ok=True)
                scaler.save(scaler_path)
    scaler_bc = resolve(dl_settings.get("scaler_bc"))
    if scaler_bc is None:
        scaler_bc_path = base / "GlobalStandardScaler_bc.npz"
        scaler_bc = (load_scaler(scaler_bc_path)
                     if scaler_bc_path.exists() else None)
    return scaler, scaler_bc


def split_datasets(training_settings: Dict, data_dynamic,
                   data_bc=None) -> Dict:
    """Config-driven train/val/test split.

    Explicit [start, end) date-range pairs in training_settings
    (`training_period` / `validation_period` / `test_period`) pin the
    reference's year split; when unset, the fractional 70/15/15 index
    split applies. Returns a dict with the dynamic subsets
    ('train'/'val'/'test'), their index bounds ('bounds'), and the
    matching BC subsets ('train_bc'/'val_bc'/'test_bc', None without BC).
    """
    n = data_dynamic.n_time
    periods = [training_settings.get(k) for k in
               ("training_period", "validation_period", "test_period")]
    if any(p is not None for p in periods):
        if not all(p is not None and len(p) == 2 for p in periods):
            raise ValueError(
                "training_period / validation_period / test_period must "
                "all be [start, end) pairs when any is set")
        tr, va, te = [data_dynamic.subset_between(p[0], p[1])
                      for p in periods]
        bounds = [(v.lo, v.hi) for v in (tr, va, te)]
    else:
        from ..data import train_val_test_split_indices
        i_train, i_val = train_val_test_split_indices(n)
        bounds = [(0, i_train), (i_train, i_val), (i_val, n)]
        tr = data_dynamic.subset(0, i_train)
        va = data_dynamic.subset(i_train, i_val)
        te = data_dynamic.subset(i_val, n)
    bcs = [data_bc.subset(lo, hi) if data_bc else None
           for lo, hi in bounds]
    return {"train": tr, "val": va, "test": te, "bounds": bounds,
            "train_bc": bcs[0], "val_bc": bcs[1], "test_bc": bcs[2]}


def build_schedulers(training_settings: Dict, ar_settings: Dict):
    """AR scheduler + early stopping + convergence-lever kwargs from the
    config (one place: the train CLI and the member-parallel ensemble
    trainer must grow AR depth and converge identically).

    Returns (ar_scheduler, early_stopping, lever_kwargs) where
    lever_kwargs feed AutoregressiveTraining directly.
    """
    from ..engine import ARScheduler, EarlyStopping

    ar_scheduler = ARScheduler(
        method=str(training_settings.get("ar_scheduler_method",
                                         "LinearStep")),
        factor=float(training_settings.get("ar_scheduler_factor", 0.0005)),
        fixed_ar_weights=[0]
        if training_settings["ar_training_strategy"] == "RNN" else [],
        initial_ar_absolute_weights=[1, 1],
        max_ar_iterations=ar_settings["ar_iterations"])
    # patience floor of 1: an interval > 500 made patience 0, which trips
    # 'counter >= patience' on EVERY check
    patience = training_settings.get("early_stopping_patience")
    if patience is None:
        patience = 500 // max(training_settings["scoring_interval"], 1)
    early_stopping = EarlyStopping(
        patience=max(1, int(patience)),
        minimum_improvement=float(
            training_settings.get("early_stopping_minimum_improvement",
                                  0.0)),
        minimum_iterations=int(
            training_settings.get("early_stopping_minimum_iterations", 4)))
    lever_kwargs = dict(
        early_stopping_reset_on_growth=str(
            training_settings.get("early_stopping_reset_on_growth",
                                  "counter")),
        lr_decay_on_growth=float(
            training_settings.get("lr_decay_on_growth", 1.0)),
        lr_plateau_decay=float(
            training_settings.get("lr_plateau_decay", 0.0) or 0.0),
        lr_plateau_max_decays=int(
            training_settings.get("lr_plateau_max_decays", 2)),
    )
    return ar_scheduler, early_stopping, lever_kwargs
