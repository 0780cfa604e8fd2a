"""Config system: defaults, JSON I/O, strict validation, model naming.

The port's copy of `deepsphere_weather_tpu/config/settings.py` (json
only, no JAX): the same default tables per section, the same strict
section checks (unknown keys rejected, the reference's GPU-only keys
accepted with a warning), the same `get_model_name` (the experiment
directory is named by it, so both packages name a run alike) and the
same experiment directory scaffolding. A config file written for one
package runs in the other.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Dict, List

__all__ = [
    "get_default_settings", "get_default_model_settings",
    "get_default_training_settings", "get_default_ar_settings",
    "get_default_dataloader_settings", "get_default_swag_settings",
    "read_config_file", "write_config_file",
    "get_model_settings", "get_training_settings", "get_ar_settings",
    "get_dataloader_settings", "get_swag_settings",
    "check_same_dict", "get_model_name", "create_experiment_directories",
]

# Keys the reference uses that are CUDA/torch-specific; accepted + ignored.
_LEGACY_KEYS = {
    "training_settings": {"benchmark_cudnn", "gpu_training", "gpu_devices_ids",
                          "dataparallel_training"},
    "dataloader_settings": {"prefetch_in_gpu", "pin_memory",
                            "asyncronous_gpu_transfer"},
}


def get_default_model_settings() -> Dict:
    return {
        "pretrained_model_name": None,
        "model_name_prefix": None,
        "model_name": None,
        "model_name_suffix": None,
        "architecture_name": "UNetSpherical",
        # ConvBlock options
        "kernel_size_conv": 3,
        "bias": True,
        "batch_norm": False,
        "batch_norm_before_activation": False,
        "activation": True,
        "activation_fun": "relu",
        # Pooling options
        "pool_method": "Max",
        "kernel_size_pooling": 4,
        # Convolution type
        "conv_type": "graph",
        "graph_type": "knn",
        "knn": 20,
        "periodic_padding": True,
        # sampling
        "sampling_name": None,
        "sampling": None,
        "sampling_kwargs": None,
        # architecture extras
        "skip_connection": "stack",
        "increment_learning": False,
    }


def get_default_training_settings() -> Dict:
    return {
        "epochs": 15,
        "ar_training_strategy": "RNN",
        "learning_rate": 0.001,
        "training_batch_size": 16,
        "validation_batch_size": 16,
        # validation batches scored per interval: null = FULL validation
        # pass (reference parity — early stopping and AR growth see the
        # whole validation period); an int caps the (unshuffled) pass for
        # speed at the cost of a temporally-biased estimate
        "validation_batches": None,
        "scoring_interval": 20,
        "save_model_each_epoch": False,
        "numeric_precision": "float32",
        "deterministic_training": False,
        "seed_model_weights": 100,
        "seed_random_shuffling": 120,
        # explicit [start, end) ISO-8601 date pairs for the time split
        # (reference pins 1980-2014 / 2015-16 / 2017-18,
        # train_predict_state.py:217-236); all three null = fractional
        # 70/15/15 index split (cuts the record wherever it falls)
        "training_period": None,
        "validation_period": None,
        "test_period": None,
        # Early stopping / AR growth (reference exposes these as the
        # EarlyStopping constructor args, train_predict_state.py:375-381).
        # patience counts scoring intervals without improvement before the
        # AR scheduler grows (or training stops at max AR); null = the
        # legacy heuristic max(1, 500 // scoring_interval)
        "early_stopping_patience": None,
        "early_stopping_minimum_improvement": 0.0,
        "early_stopping_minimum_iterations": 4,
        # AR loss-weight growth schedule (reference hard-codes
        # AR_Scheduler(method="LinearStep", factor=0.0005) in the driver,
        # train_predict_state.py:345-359). At factor 0.0005 a newly grown
        # AR iteration needs 2000 scoring intervals to reach weight 1.0 —
        # far beyond any realistic run, so late leadtimes train with
        # near-zero weight. Raise the factor (e.g. 0.05) when long-lead
        # skill matters more than schedule parity.
        "ar_scheduler_method": "LinearStep",
        "ar_scheduler_factor": 0.0005,
        # Per-AR-stage convergence levers (defaults = reference parity).
        # "counter" keeps reference semantics: the best validation loss
        # survives an AR growth, so later stages inherit a plateau judged
        # against an EASIER loss definition and each stage lasts at most
        # `patience` intervals once the loss scale shifts up. "full" also
        # resets the best (and minimum_iterations clock) at each growth,
        # so every AR stage trains until it plateaus on its OWN loss.
        "early_stopping_reset_on_growth": "counter",
        # multiply the learning rate by this at each AR growth (1.0 = off)
        "lr_decay_on_growth": 1.0,
        # ReduceLROnPlateau at the FINAL AR stage: when patience runs out
        # at max AR iterations, decay the lr by this factor and fully
        # reset early stopping instead of stopping, at most
        # lr_plateau_max_decays times (0.0 = off -> stop immediately,
        # reference parity). Trains the AR6 stage to actual convergence.
        "lr_plateau_decay": 0.0,
        "lr_plateau_max_decays": 2,
        # global-norm gradient clipping (0 = off, reference parity).
        # RNN-strategy BPTT through a full AR6 rollout can blow up in one
        # step at the reference's lr=0.007 (measured: loss 0.03 -> 1e27 at
        # the growth to AR6 on 10 toy-years); clip 1.0 keeps it stable.
        "gradient_clipping": 0.0,
        # mesh settings (replace the reference's GPU knobs):
        # n_data_parallel shards the batch axis over the 'data' ranks,
        # n_node_parallel shards the sphere's node axis over the 'node'
        # ranks (parallel/mesh.py); their product must not exceed the
        # process group's size
        "n_data_parallel": 1,
        "n_node_parallel": 1,
        # remat=True recomputes each AR iteration's activations in the
        # backward pass (torch.utils.checkpoint): peak device memory drops
        # by ~the AR depth for one extra forward per iteration
        "remat": False,
    }


def get_default_ar_settings() -> Dict:
    return {
        "input_k": [-3, -2, -1],
        "output_k": [0],
        "forecast_cycle": 1,
        "ar_iterations": 6,
        "stack_most_recent_prediction": True,
    }


def get_default_dataloader_settings() -> Dict:
    return {
        # on-the-fly scaler selection (reference composes loaded scalers
        # with SequentialScaler in the driver, train_predict_state.py:
        # 205-212). null = auto (GlobalStandardScaler fitted/loaded);
        # a string = one saved scaler file; a LIST = SequentialScaler
        # composition in order (e.g. ["MonthlyStdAnomalyScaler_dynamic.npz",
        # "MonthlyMinMaxStdAnomalyScaler_dynamic.npz"]). Paths resolve
        # relative to <data_dir>/Scalers.
        "scaler_dynamic": None,
        "scaler_bc": None,
        "random_shuffling": True,
        "drop_last_batch": True,
        "prefetch_factor": 2,
        "num_workers": 8,
        "autotune_num_workers": False,
        # cache the pre-scaled dataset in device memory and gather AR
        # windows on device ('auto': when it fits DSW_DEVICE_CACHE_BYTES,
        # 8 GB default). Per-step host->device traffic becomes a [B, W]
        # index array.
        "device_cache": "auto",
    }


def get_default_swag_settings() -> Dict:
    return {
        "swag": False,
        "target_learning_rate": 0.007,
        "no_cov_mat": False,
        "max_num_models": 40,
        "swag_freq": 10,
        "swa_start": 0,
        "sampling_scale": 0.1,
        "nb_samples": 10,
    }


def get_default_settings() -> Dict:
    return {
        "model_settings": get_default_model_settings(),
        "dataloader_settings": get_default_dataloader_settings(),
        "training_settings": get_default_training_settings(),
        "ar_settings": get_default_ar_settings(),
    }


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

def read_config_file(fpath) -> Dict:
    fpath = Path(fpath)
    if not fpath.exists():
        raise FileNotFoundError(f"config file not found: {fpath}")
    cfg = json.loads(fpath.read_text())
    if not isinstance(cfg, dict):
        raise ValueError("config file must contain a JSON object")
    return cfg


def write_config_file(cfg: Dict, fpath):
    fpath = Path(fpath)
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fpath.write_text(json.dumps(cfg, indent=4))


# ---------------------------------------------------------------------------
# Section extraction with strict validation
# ---------------------------------------------------------------------------

def _get_section(cfg: Dict, section: str, defaults: Dict,
                 mandatory: List[str]) -> Dict:
    provided = dict(cfg.get(section, {}))
    legacy = _LEGACY_KEYS.get(section, set())
    dropped = {k for k in provided if k in legacy}
    if dropped:
        warnings.warn(
            f"{section}: ignoring legacy GPU-specific keys {sorted(dropped)}")
        for k in dropped:
            provided.pop(k)
    unknown = set(provided) - set(defaults)
    if unknown:
        raise ValueError(f"{section}: invalid keys {sorted(unknown)}")
    out = dict(defaults)
    out.update(provided)
    missing = [k for k in mandatory if out.get(k) is None]
    if missing:
        raise ValueError(f"{section}: mandatory keys missing {missing}")
    return out


def get_model_settings(cfg: Dict) -> Dict:
    return _get_section(cfg, "model_settings", get_default_model_settings(),
                        mandatory=["architecture_name", "sampling",
                                   "sampling_kwargs"])


def get_training_settings(cfg: Dict) -> Dict:
    return _get_section(cfg, "training_settings",
                        get_default_training_settings(), mandatory=[])


def get_ar_settings(cfg: Dict) -> Dict:
    return _get_section(cfg, "ar_settings", get_default_ar_settings(),
                        mandatory=["input_k", "output_k", "forecast_cycle",
                                   "ar_iterations"])


def get_dataloader_settings(cfg: Dict) -> Dict:
    return _get_section(cfg, "dataloader_settings",
                        get_default_dataloader_settings(), mandatory=[])


def get_swag_settings(cfg: Dict) -> Dict:
    # reference section name is SWAG_settings
    section = "swag_settings" if "swag_settings" in cfg else "SWAG_settings"
    tmp = {**cfg}
    tmp["swag_settings"] = tmp.pop(section, {})
    # reference key capitalization: SWAG
    s = dict(tmp["swag_settings"])
    if "SWAG" in s:
        s["swag"] = s.pop("SWAG")
    tmp["swag_settings"] = s
    return _get_section(tmp, "swag_settings", get_default_swag_settings(),
                        mandatory=[])


def check_same_dict(d1: Dict, d2: Dict, name: str = "tensor_info"):
    """Deep-equality guard (reference uses deepdiff, utils_config.py:322-328)."""
    if json.dumps(d1, sort_keys=True, default=str) != json.dumps(
            d2, sort_keys=True, default=str):
        raise ValueError(
            f"{name} mismatch between training and prediction configuration")


# ---------------------------------------------------------------------------
# Model naming + experiment dirs
# ---------------------------------------------------------------------------

def get_model_name(cfg: Dict) -> str:
    """Derive the experiment name from config
    (reference format, utils_config.py:480-536)."""
    ms = get_model_settings(cfg)
    ts = get_training_settings(cfg)
    ars = get_ar_settings(cfg)
    if ms.get("model_name"):
        name = ms["model_name"]
    else:
        sampling_name = ms.get("sampling_name") or ms["sampling"]
        pieces = [
            f"{ts['ar_training_strategy']}-AR{ars['ar_iterations']}",
            ms["architecture_name"],
            str(sampling_name),
        ]
        if ms["conv_type"] == "graph":
            pieces.append(f"Graph_{ms['graph_type']}")
            pieces.append(f"k{ms['knn']}")
        else:
            pieces.append("Image")
        # canonical casing (str.capitalize would fold MaxVal -> 'Maxval',
        # splitting experiment names from the reference scheme)
        _pool_names = {"max": "Max", "avg": "Avg", "interp": "Interp",
                       "maxval": "MaxVal", "maxarea": "MaxArea",
                       "learn": "Learn"}
        pm = str(ms["pool_method"])
        pieces.append(f"{_pool_names.get(pm.lower(), pm.capitalize())}Pooling")
        name = "-".join(pieces)
    prefix = ms.get("model_name_prefix")
    suffix = ms.get("model_name_suffix")
    if prefix:
        name = f"{prefix}-{name}"
    if suffix:
        name = f"{name}-{suffix}"
    return name


def create_experiment_directories(exp_dir, model_name: str,
                                  force: bool = False,
                                  resume: bool = False) -> Path:
    """Scaffold the experiment directory contract
    (reference layout, utils_config.py:539-581).

    force=True DELETES an existing experiment dir first — leaving stale
    artifacts (old checkpoints, prediction chunks, skills) in place made
    a later --resume silently continue the previous run and mixed old
    prediction chunks into the new run's stores. resume=True keeps the
    existing directory (its checkpoint IS the point)."""
    exp_dir = Path(exp_dir) / model_name
    if exp_dir.exists() and not resume:
        if not force:
            raise FileExistsError(
                f"experiment dir {exp_dir} exists; use force=True to "
                f"overwrite")
        import shutil
        shutil.rmtree(exp_dir)
    for sub in ("model_weights", "figs/skills", "figs/training_info",
                "model_predictions/space_chunked",
                "model_predictions/forecast_chunked",
                "model_skills", "training_info"):
        (exp_dir / sub).mkdir(parents=True, exist_ok=True)
    return exp_dir
