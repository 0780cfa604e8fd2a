"""External-baseline skill ingest (reference: Weyn-et-al RMSE netCDF,
scripts_figs/benchmark_samplings.py:96-100); the port's copy of
`deepsphere_weather_tpu/verif/external.py` (h5py imported inside the
function, for a netCDF4 file only).

The reference compares its models against third-party baseline skill files
(per-variable RMSE vs lead time) read from netCDF. `load_external_skill`
reads such a file — netCDF4/HDF5 via h5py, or the packages' .npz — into
a global `SkillDataset` that drops straight into
`plotting.benchmark_global_skills(benchmarks={...})`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .deterministic import SkillDataset

__all__ = ["load_external_skill"]

_LEAD_NAMES = ("leadtime", "lead_time", "leadtime_hours", "forecast_hour")


def load_external_skill(path, skill_name: str = "RMSE",
                        variables: Optional[Sequence[str]] = None,
                        leadtime_units: str = "h") -> SkillDataset:
    """Read an external per-variable skill-vs-leadtime file.

    Expected layout (Weyn-et-al convention): one 1-D array per variable
    (z500, t850, ...) over a lead-time coordinate named one of
    {leadtime, lead_time, leadtime_hours, forecast_hour}. All arrays are
    stacked into a [leadtime, variable] SkillDataset holding `skill_name`.

    leadtime_units: 'h' (hours, default) or 'ns' (numpy timedelta64
    nanoseconds, converted to hours).
    """
    path = Path(path)
    if path.suffix == ".npz":
        return SkillDataset.load(path)

    import h5py

    with h5py.File(path, "r") as f:
        names = list(f.keys())
        lead_name = next((n for n in _LEAD_NAMES if n in f), None)
        if lead_name is None:
            raise ValueError(
                f"{path}: no lead-time coordinate found (looked for "
                f"{_LEAD_NAMES}; file has {names})")
        lead = np.asarray(f[lead_name][...], dtype=np.float64)
        if leadtime_units == "ns":
            lead = lead / 3.6e12
        if variables is None:
            variables = [n for n in names
                         if n != lead_name
                         and f[n].shape == f[lead_name].shape]
        if not variables:
            raise ValueError(f"{path}: no per-variable skill arrays "
                             f"matching the lead-time shape {lead.shape}")
        data = np.stack([np.asarray(f[v][...], dtype=np.float64)
                         for v in variables], axis=1)      # [L, F]
    return SkillDataset({skill_name: data}, lead, list(variables))
