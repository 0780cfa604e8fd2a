"""Ensemble prediction: SWAG members, ensemble and median stores.

Port of `deepsphere_weather_tpu/prob/predictions.py` (reference
modules/swag_predictions.py:16-168 and
scripts_training/verify_DeepEnsemble.py:29-172):

- `AutoregressiveSWAGPredictions`: for each member in turn, sample SWAG
  weights, re-estimate a BatchNorm model's running statistics on them
  (`bn_update`), and roll the AR predictions into a member store
  (`member_XX.zarr`, kept in memory too by default); then the ensemble
  and median stores.
- `build_ensemble_store`: the member stores concatenated along a leading
  'member' dim ([member, frt, leadtime, node] per variable; attributes
  `feature_order` and `n_member`), `ensemble_median` their median.

The stores have the JAX package's layout, so either package's verifier
reads either's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.zarrstore import ZarrGroup, create_group
from ..engine.prediction import AutoregressivePredictions, ForecastDataset

__all__ = ["AutoregressiveSWAGPredictions", "build_ensemble_store",
           "ensemble_median", "EnsembleForecastDataset"]


class EnsembleForecastDataset:
    """Per-variable [member, frt, leadtime, node] forecasts."""

    def __init__(self, group: ZarrGroup):
        self.group = group
        self.feature_order = group.attrs["feature_order"]
        self.n_member = group.attrs["n_member"]
        self.variables = {n: group[n] for n in self.feature_order}

    @classmethod
    def open(cls, path):
        return cls(ZarrGroup(path))


def _copy_coords(src_group, dst_group):
    for cname in ("forecast_reference_time", "leadtime", "lat", "lon"):
        src = src_group[cname]
        a = dst_group.create_array(cname, shape=src.shape, chunks=src.shape,
                                   dtype=src.dtype, compressor=None,
                                   attrs=src.attrs)
        a[...] = src[...]


def build_ensemble_store(member_forecasts: List[ForecastDataset],
                         out_path) -> EnsembleForecastDataset:
    """Concatenate member forecast stores along a new leading 'member' dim
    (reference swag_predictions.py:130-150)."""
    f0 = member_forecasts[0]
    M = len(member_forecasts)
    n_frt, L = f0.n_frt, f0.n_leadtime
    V = len(f0.lat)
    g = create_group(out_path, overwrite=True,
                     attrs={"feature_order": list(f0.feature_order),
                            "n_member": M})
    for name in f0.feature_order:
        arr = g.create_array(name, shape=(M, n_frt, L, V),
                             chunks=(1, n_frt, L, V), dtype=np.float32,
                             compressor="zlib")
        for m, fc in enumerate(member_forecasts):
            arr[m] = fc.variables[name][...][None]
    _copy_coords(f0.group, g)
    return EnsembleForecastDataset(g)


def ensemble_median(ensemble: EnsembleForecastDataset,
                    out_path) -> ForecastDataset:
    """Member-median forecast store (reference swag_predictions.py:159-166)."""
    g = create_group(out_path, overwrite=True,
                     attrs={"feature_order": list(ensemble.feature_order)})
    for name in ensemble.feature_order:
        data = ensemble.variables[name][...]          # [M, frt, L, V]
        med = np.median(data, axis=0).astype(np.float32)
        arr = g.create_array(name, shape=med.shape,
                             chunks=(1, 1, med.shape[2]), dtype=np.float32,
                             compressor="zlib")
        arr[...] = med
    _copy_coords(ensemble.group, g)
    return ForecastDataset(g)


def AutoregressiveSWAGPredictions(
    model,
    swag,
    *,
    generator: Optional[torch.Generator] = None,
    nb_samples: int = 10,
    sampling_scale: float = 0.1,
    cov: bool = True,
    out_dir,
    # BatchNorm re-estimation after each draw (reference
    # swag_predictions.py:59-91): the training period and AR settings of
    # the statistics pass (`bn_update`'s keywords). Ignored without BN.
    bn_update_data: Optional[Dict] = None,
    # forwarded to AutoregressivePredictions
    **predict_kwargs,
) -> Dict[str, object]:
    """For each SWAG sample in turn: draw weights (`swag.sample(generator,
    ...)`) -> [bn_update] -> AR predictions -> member store; then the
    ensemble and median stores. `model` runs each member's weights (loaded
    in place) and gets its own back at the end. Returns {"members",
    "ensemble", "median"}."""
    out_dir = Path(out_dir)
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    members = []
    try:
        for m in range(nb_samples):
            params_m = swag.sample(generator, scale=sampling_scale, cov=cov)
            model.load_state_dict(params_m)
            member_kwargs = dict(predict_kwargs)
            if (getattr(model, "has_batch_norm", False)
                    and bn_update_data is not None):
                from .bn import bn_update

                member_kwargs["norm_state"] = bn_update(model,
                                                        **bn_update_data)
            # member datasets in RAM (within the budget): the ensemble
            # store below stacks them from memory
            member_kwargs.setdefault("keep_in_memory", True)
            members.append(AutoregressivePredictions(
                model, zarr_fpath=out_dir / f"member_{m:02d}.zarr",
                **member_kwargs))
    finally:
        model.load_state_dict(own)
    ensemble = build_ensemble_store(members, out_dir / "ensemble.zarr")
    median = ensemble_median(ensemble, out_dir / "median.zarr")
    return {"members": members, "ensemble": ensemble, "median": median}
