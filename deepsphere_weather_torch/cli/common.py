"""Shared CLI data-resolution helpers.

Port of `deepsphere_weather_tpu/cli/common.py`. Every driver must resolve
the SAME scaler composition and train/val/test time split from a config:
a model predicted with a different scaler than it was trained with
silently produces garbage, and a split that disagrees with the configured
test_period leaks test data into training. (Reference anchors:
SequentialScaler composition in the driver, train_predict_state.py:
205-212; pinned year split, :217-236.) The time-grouped scalers are not
ported yet: a config that names one raises NotImplementedError
(`data.scalers.load_scaler`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

__all__ = ["resolve_scalers", "split_datasets", "build_schedulers"]


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
