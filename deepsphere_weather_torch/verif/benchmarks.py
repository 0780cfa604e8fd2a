"""Benchmark forecasts: persistence and climatology skill floors.

Port of `deepsphere_weather_tpu/verif/benchmarks.py`: persistence
forecasts are time-lagged copies of the observations at leadtimes 1..n x
dt; climatology forecasts come from `Climatology.forecast(times)`. Both
are verified with the same deterministic metrics as model forecasts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.scalers import Climatology
from .deterministic import SkillDataset, deterministic_metrics

__all__ = ["persistence_skills", "climatology_skills"]


def persistence_skills(obs_dataset, leadtimes: np.ndarray) -> SkillDataset:
    """Persistence forecast skills per leadtime (steps of the dataset dt).

    leadtimes: array of positive integer step offsets."""
    obs = obs_dataset.read_all()          # [T, V, F]
    dt_hours = obs_dataset.timestep / np.timedelta64(1, "h")
    out = None
    for lt in leadtimes:
        lt = int(lt)
        m = deterministic_metrics(obs[:-lt], obs[lt:], axis=0)
        if out is None:
            out = {k: [] for k in m}
        for k, v in m.items():
            out[k].append(v)
    stacked = {k: np.stack(v, axis=0) for k, v in out.items()}
    return SkillDataset(stacked, np.asarray(leadtimes) * dt_hours,
                        obs_dataset.feature_order,
                        lat=obs_dataset.lat, lon=obs_dataset.lon)


def climatology_skills(obs_dataset, climatology: Climatology,
                       leadtimes: Optional[np.ndarray] = None) -> SkillDataset:
    """Climatology forecast skills (leadtime-independent, replicated to the
    requested leadtimes)."""
    obs = obs_dataset.read_all()
    pred = climatology.forecast(obs_dataset.time)
    m = deterministic_metrics(pred, obs, axis=0)
    if leadtimes is None:
        leadtimes = np.array([0])
    dt_hours = obs_dataset.timestep / np.timedelta64(1, "h")
    stacked = {k: np.repeat(v[None], len(leadtimes), axis=0)
               for k, v in m.items()}
    return SkillDataset(stacked, np.asarray(leadtimes) * dt_hours,
                        obs_dataset.feature_order,
                        lat=obs_dataset.lat, lon=obs_dataset.lon)
