"""Deterministic forecast verification (xverif parity).

The port's copy of `deepsphere_weather_tpu/verif/deterministic.py`
(numpy only): per-(node, leadtime) skills of a forecast against
observations (error_CoV, obs_CoV, pred_CoV, BIAS, MAE, MSE, RMSE,
percBIAS, percMAE, rSD, pearson_R2, KGE, NSE, diffSD), the binary-event
skills, the streaming verifier for space-chunked stores too large for
RAM, `SkillDataset` with its .npz format, and the area-weighted global,
latitudinal and longitudinal summaries. Either package's verifier reads
either package's forecast store and gives the same skills.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["deterministic_metrics", "categorical_metrics",
           "deterministic", "global_summary",
           "latitudinal_summary", "longitudinal_summary",
           "SkillDataset"]

EPS = 1e-12

SKILL_NAMES = [
    "BIAS", "MAE", "MSE", "RMSE", "percBIAS", "percMAE",
    "rSD", "pearson_R", "pearson_R2", "error_CoV", "obs_CoV", "pred_CoV",
    "diffSD", "NSE", "KGE",
]


def deterministic_metrics(pred: np.ndarray, obs: np.ndarray,
                          axis: int = 0) -> Dict[str, np.ndarray]:
    """Skill metrics aggregating over `axis` (the time/sample axis).

    pred/obs: arrays with matching shape; returns dict of arrays with the
    aggregation axis removed.
    """
    pred = np.asarray(pred, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    err = pred - obs
    mean_obs = obs.mean(axis=axis)
    mean_pred = pred.mean(axis=axis)
    std_obs = obs.std(axis=axis)
    std_pred = pred.std(axis=axis)
    cov = ((pred - np.expand_dims(mean_pred, axis))
           * (obs - np.expand_dims(mean_obs, axis))).mean(axis=axis)

    bias = err.mean(axis=axis)
    mae = np.abs(err).mean(axis=axis)
    mse = (err ** 2).mean(axis=axis)
    rmse = np.sqrt(mse)
    perc_bias = 100 * bias / np.where(np.abs(mean_obs) > EPS, mean_obs, np.nan)
    perc_mae = 100 * mae / np.where(np.abs(mean_obs) > EPS, mean_obs, np.nan)
    r_sd = std_pred / np.where(std_obs > EPS, std_obs, np.nan)
    pearson_r = cov / np.where(std_pred * std_obs > EPS, std_pred * std_obs,
                               np.nan)
    error_cov = err.std(axis=axis) / np.where(np.abs(mean_obs) > EPS,
                                              mean_obs, np.nan)
    obs_cov = std_obs / np.where(np.abs(mean_obs) > EPS, mean_obs, np.nan)
    pred_cov = std_pred / np.where(np.abs(mean_pred) > EPS, mean_pred, np.nan)
    diff_sd = (pred - obs).std(axis=axis)
    denom = ((obs - np.expand_dims(mean_obs, axis)) ** 2).sum(axis=axis)
    nse = 1 - (err ** 2).sum(axis=axis) / np.where(denom > EPS, denom, np.nan)
    beta = mean_pred / np.where(np.abs(mean_obs) > EPS, mean_obs, np.nan)
    kge = 1 - np.sqrt((pearson_r - 1) ** 2 + (r_sd - 1) ** 2 + (beta - 1) ** 2)

    return {
        "BIAS": bias, "MAE": mae, "MSE": mse, "RMSE": rmse,
        "percBIAS": perc_bias, "percMAE": perc_mae,
        "rSD": r_sd, "pearson_R": pearson_r, "pearson_R2": pearson_r ** 2,
        "error_CoV": error_cov, "obs_CoV": obs_cov, "pred_CoV": pred_cov,
        "diffSD": diff_sd, "NSE": nse, "KGE": kge,
    }


class SkillDataset:
    """Skills indexed [leadtime, node, feature] (or aggregated), with coords."""

    def __init__(self, skills: Dict[str, np.ndarray], leadtime_hours: np.ndarray,
                 feature_order: List[str], lat=None, lon=None):
        self.skills = skills
        self.leadtime_hours = np.asarray(leadtime_hours)
        self.feature_order = list(feature_order)
        self.lat = lat
        self.lon = lon

    def __getitem__(self, name: str) -> np.ndarray:
        return self.skills[name]

    def save(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        header = {"feature_order": self.feature_order,
                  "skill_names": sorted(self.skills)}
        arrays = {f"skill_{k}": v for k, v in self.skills.items()}
        arrays["leadtime_hours"] = self.leadtime_hours
        if self.lat is not None:
            arrays["lat"] = self.lat
            arrays["lon"] = self.lon
        np.savez_compressed(path, __header__=json.dumps(header), **arrays)

    @classmethod
    def load(cls, path) -> "SkillDataset":
        with np.load(path) as z:
            header = json.loads(str(z["__header__"]))
            skills = {k[len("skill_"):]: z[k] for k in z.files
                      if k.startswith("skill_")}
            return cls(skills, z["leadtime_hours"], header["feature_order"],
                       lat=z["lat"] if "lat" in z.files else None,
                       lon=z["lon"] if "lon" in z.files else None)


def categorical_metrics(pred: np.ndarray, obs: np.ndarray, threshold,
                        axis: int = 0) -> Dict[str, np.ndarray]:
    """Binary-event skills from a threshold exceedance (xverif's
    categorical forecast_type; the reference only exercises 'continuous',
    train_predict_state.py:525-560).

    Contingency counts over `axis`: hits (a), false alarms (b),
    misses (c), correct negatives (d) -> POD, FAR, CSI (threat score),
    accuracy (PC), frequency BIAS, HSS, ETS (Gilbert skill score).
    """
    pred = np.asarray(pred)
    obs = np.asarray(obs)
    # non-finite samples are EXCLUDED from the contingency table (NaN >=
    # thr is False and would otherwise count as a correct negative)
    valid = np.isfinite(pred) & np.isfinite(obs)
    p = (pred >= threshold) & valid
    o = (obs >= threshold) & valid
    a = np.sum(p & o, axis=axis).astype(np.float64)
    b = np.sum(p & ~o & valid, axis=axis).astype(np.float64)
    c = np.sum(~p & o & valid, axis=axis).astype(np.float64)
    d = np.sum(~p & ~o & valid, axis=axis).astype(np.float64)
    n = a + b + c + d

    def safe(num, den):
        return num / np.where(den > 0, den, np.nan)

    a_random = safe((a + b) * (a + c), n)
    return {
        "POD": safe(a, a + c),
        "FAR": safe(b, a + b),
        "CSI": safe(a, a + b + c),
        "ACC": safe(a + d, n),
        "FB": safe(a + b, a + c),
        "HSS": safe(2 * (a * d - b * c),
                    (a + c) * (c + d) + (a + b) * (b + d)),
        "ETS": safe(a - a_random, a + b + c - a_random),
    }


def _metrics_from_moments(n, sp, so, spp, soo, spo, sae, shift):
    """deterministic_metrics from streaming sums over the sample axis.

    Inputs are sums of SHIFTED values (x - shift, per node/feature —
    centering keeps the squared sums at anomaly scale, avoiding the
    catastrophic cancellation raw z500^2 sums would hit in float64);
    variances/covariances/error moments are shift-invariant, only the
    means add `shift` back. Replicates deterministic_metrics' EPS-guard
    NaN semantics exactly.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.where(n > 0, n.astype(np.float64), np.nan)
        mean_pred_c = sp / n
        mean_obs_c = so / n
        mean_pred = mean_pred_c + shift
        mean_obs = mean_obs_c + shift
        var_pred = np.maximum(spp / n - mean_pred_c ** 2, 0.0)
        var_obs = np.maximum(soo / n - mean_obs_c ** 2, 0.0)
        std_pred = np.sqrt(var_pred)
        std_obs = np.sqrt(var_obs)
        cov = spo / n - mean_pred_c * mean_obs_c
        bias = mean_pred - mean_obs
        mae = sae / n
        mse = np.maximum((spp - 2 * spo + soo) / n, 0.0)
        rmse = np.sqrt(mse)
        diff_sd = np.sqrt(np.maximum(mse - bias ** 2, 0.0))

        obs_ok = np.where(np.abs(mean_obs) > EPS, mean_obs, np.nan)
        perc_bias = 100 * bias / obs_ok
        perc_mae = 100 * mae / obs_ok
        r_sd = std_pred / np.where(std_obs > EPS, std_obs, np.nan)
        pearson_r = cov / np.where(std_pred * std_obs > EPS,
                                   std_pred * std_obs, np.nan)
        error_cov = diff_sd / obs_ok
        obs_cov = std_obs / obs_ok
        pred_cov = std_pred / np.where(np.abs(mean_pred) > EPS, mean_pred,
                                       np.nan)
        denom = n * var_obs
        nse = 1 - n * mse / np.where(denom > EPS, denom, np.nan)
        beta = mean_pred / obs_ok
        kge = 1 - np.sqrt((pearson_r - 1) ** 2 + (r_sd - 1) ** 2
                          + (beta - 1) ** 2)
    return {
        "BIAS": bias, "MAE": mae, "MSE": mse, "RMSE": rmse,
        "percBIAS": perc_bias, "percMAE": perc_mae,
        "rSD": r_sd, "pearson_R": pearson_r, "pearson_R2": pearson_r ** 2,
        "error_CoV": error_cov, "obs_CoV": obs_cov, "pred_CoV": pred_cov,
        "diffSD": diff_sd, "NSE": nse, "KGE": kge,
    }


def _deterministic_streaming(forecast, obs_dataset,
                             tile_bytes: int = 512 << 20) -> SkillDataset:
    """Single-pass verification of a SPACE-chunked forecast store.

    Reads the forecast exactly once in node tiles aligned to the store's
    node chunking and accumulates the 7 sufficient moments per
    (leadtime, node, feature); observations for the aligned valid times
    load once (they are ~n_leadtime x smaller than the forecast store).
    Replaces the per-leadtime read path that inflated every node chunk
    once per leadtime (~L full-store passes: the round-3 HEALPix-64
    protocol verify read ~190 GB for a ~10 GB store). Reference
    equivalent: rechunk-then-verify, train_predict_state.py:505-560.
    """
    L = forecast.n_leadtime
    V = len(obs_dataset.lat)
    n_var = len(forecast.feature_order)
    obs_time = obs_dataset.time

    # per-leadtime alignment of forecast valid times to observation rows
    oks, sidxs = [], []
    for lt in range(L):
        valid = forecast.valid_time(lt)
        sidx = np.searchsorted(obs_time, valid)
        ok = sidx < len(obs_time)
        ok &= obs_time[np.minimum(sidx, len(obs_time) - 1)] == valid
        oks.append(ok)
        sidxs.append(sidx[ok])
    uniq = np.unique(np.concatenate([s for s in sidxs if s.size]
                                    or [np.empty(0, np.int64)]))
    pos = [np.searchsorted(uniq, s) for s in sidxs]
    obs_all = (obs_dataset.read_stacked(uniq).astype(np.float64)
               if uniq.size else np.zeros((0, V, n_var)))

    # center on a per-(node, feature) reference so the squared sums stay
    # at anomaly scale (see _metrics_from_moments)
    shift = obs_all[0] if uniq.size else np.zeros((V, n_var))

    acc_shape = (L, V, n_var)
    n_acc = np.zeros((L, 1, 1))
    sp = np.zeros(acc_shape)
    so = np.zeros(acc_shape)
    spp = np.zeros(acc_shape)
    soo = np.zeros(acc_shape)
    spo = np.zeros(acc_shape)
    sae = np.zeros(acc_shape)
    for lt in range(L):
        n_acc[lt] = len(sidxs[lt])

    node_chunk = forecast.variables[forecast.feature_order[0]].chunks[2]
    per_node_bytes = forecast.n_frt * L * n_var * 4
    tile = max(node_chunk,
               (max(tile_bytes // per_node_bytes, 1) // node_chunk)
               * node_chunk)
    for v0 in range(0, V, tile):
        v1 = min(v0 + tile, V)
        tw = v1 - v0
        pred_tile = np.empty((forecast.n_frt, L, tw, n_var), np.float32)
        for f, name in enumerate(forecast.feature_order):
            pred_tile[..., f] = forecast.variables[name][:, :, v0:v1]
        c = shift[v0:v1]
        for lt in range(L):
            if not len(sidxs[lt]):
                continue
            p = pred_tile[oks[lt], lt].astype(np.float64) - c
            o = obs_all[pos[lt]][:, v0:v1] - c
            sp[lt, v0:v1] += p.sum(axis=0)
            so[lt, v0:v1] += o.sum(axis=0)
            spp[lt, v0:v1] += (p * p).sum(axis=0)
            soo[lt, v0:v1] += (o * o).sum(axis=0)
            spo[lt, v0:v1] += (p * o).sum(axis=0)
            sae[lt, v0:v1] += np.abs(p - o).sum(axis=0)
    stacked = _metrics_from_moments(n_acc, sp, so, spp, soo, spo, sae,
                                    shift[None])
    return SkillDataset(stacked, forecast.leadtime_hours,
                        obs_dataset.feature_order,
                        lat=obs_dataset.lat, lon=obs_dataset.lon)


def deterministic(forecast, obs_dataset, forecast_type: str = "continuous",
                  aggregating_dim: str = "time",
                  thr: float = 0.0) -> SkillDataset:
    """Verify a ForecastDataset against a SphericalDataset.

    Per leadtime: align forecast valid times with observation times,
    compute metrics over the aligned sample axis -> [leadtime, node,
    feature] skill arrays (xverif.deterministic parity).
    forecast_type='categorical_binary' verifies the exceedance of `thr`
    (POD/FAR/CSI/ACC/FB/HSS/ETS).

    aggregating_dim='node' aggregates over SPACE instead: skills per
    (leadtime, valid sample, feature) — the xverif mode the reference
    drivers never call but its API exposes; lat/lon are dropped (the
    node axis is consumed).
    """
    if aggregating_dim not in ("time", "node"):
        raise NotImplementedError(
            "aggregating_dim must be 'time' or 'node'")
    if list(forecast.feature_order) != list(obs_dataset.feature_order):
        raise ValueError(
            f"feature order mismatch: forecast {forecast.feature_order} vs "
            f"observations {obs_dataset.feature_order} — comparison is "
            f"positional, so skills would score the wrong variables")
    L = forecast.n_leadtime
    if forecast_type == "continuous":
        metric_fn = deterministic_metrics
    elif forecast_type == "categorical_binary":
        import functools
        metric_fn = functools.partial(categorical_metrics, threshold=thr)
    else:
        raise NotImplementedError(
            f"forecast_type {forecast_type!r}: use 'continuous' or "
            "'categorical_binary'")
    skills: Dict[str, List[np.ndarray]] = {k: [] for k in
                                           metric_fn(
                                               np.zeros((2, 1)),
                                               np.ones((2, 1))).keys()}
    obs_time = obs_dataset.time

    # Chunking-independent reads: each store variable decompresses ONCE
    # into RAM when the whole store fits (per-leadtime slicing of a
    # space-chunked store would otherwise inflate EVERY node chunk per
    # leadtime — 42 full-store passes at HEALPix-64). Override the budget
    # with DSW_VERIF_RAM_BYTES; oversized stores fall back to per-
    # leadtime reads.
    import os

    ram_budget = int(float(os.environ.get("DSW_VERIF_RAM_BYTES", 8e9)))
    n_var = len(forecast.feature_order)
    store_bytes = forecast.n_frt * L * len(obs_dataset.lat) * n_var * 4
    cached = None
    if store_bytes > ram_budget and forecast_type == "continuous" \
            and aggregating_dim == "time":
        arr0 = forecast.variables[forecast.feature_order[0]]
        chunks = getattr(arr0, "chunks", None)
        if chunks is not None and len(chunks) == 3 \
                and chunks[2] < len(obs_dataset.lat):
            # space-chunked store too large for RAM: per-leadtime reads
            # would inflate every node chunk once per leadtime (~L full
            # passes) — stream node tiles once instead
            return _deterministic_streaming(forecast, obs_dataset)
    if store_bytes <= ram_budget:
        # preallocate and fill per variable: np.stack over a list of all
        # variables would transiently hold 2x store_bytes, defeating the
        # budget check on the hosts it is meant to protect
        cached = np.empty(
            (forecast.n_frt, L, len(obs_dataset.lat), n_var),
            dtype=np.float32)                              # [frt, L, V, F]
        for f, n in enumerate(forecast.feature_order):
            cached[..., f] = forecast.variables[n][...]

    def read_lt(lt):
        if cached is not None:
            return cached[:, lt]
        return forecast.read_leadtime(lt)

    axis = 0 if aggregating_dim == "time" else 1
    n_kept = None
    for lt in range(L):
        valid = forecast.valid_time(lt)
        sidx = np.searchsorted(obs_time, valid)
        ok = (sidx < len(obs_time))
        ok &= obs_time[np.minimum(sidx, len(obs_time) - 1)] == valid
        pred = read_lt(lt)[ok]                             # [T, V, F]
        obs = obs_dataset.read_stacked(sidx[ok])            # [T, V, F]
        m = metric_fn(pred, obs, axis=axis)   # [V, F] ('time') | [T, F]
        if axis == 1:
            # sample counts differ per leadtime (trailing forecasts run
            # past the observation record): pad to the lead-0 count so
            # the per-leadtime arrays stack
            if n_kept is None:
                n_kept = pred.shape[0]
            m = {k: np.pad(v, ((0, n_kept - v.shape[0]), (0, 0)),
                           constant_values=np.nan)
                 if v.shape[0] < n_kept else v[:n_kept]
                 for k, v in m.items()}
        for k, v in m.items():
            skills[k].append(v)
    # [L, V, F] for 'time'; [L, T, F] for 'node' (no spatial coords left)
    stacked = {k: np.stack(v, axis=0) for k, v in skills.items()}
    if aggregating_dim == "node":
        return SkillDataset(stacked, forecast.leadtime_hours,
                            obs_dataset.feature_order)
    return SkillDataset(stacked, forecast.leadtime_hours,
                        obs_dataset.feature_order,
                        lat=obs_dataset.lat, lon=obs_dataset.lon)


def global_summary(skill: SkillDataset, area_weights: np.ndarray) -> SkillDataset:
    """Area-weighted aggregation over nodes (xverif.global_summary parity)."""
    w = np.asarray(area_weights, dtype=np.float64)
    w = w / w.sum()
    def nanwmean(v):
        # NaN-aware weighted mean: renormalize weights over valid nodes;
        # an all-NaN (leadtime, feature) stays NaN — nan_to_num here
        # reported MSE/RMSE = 0 ("perfect") for unmatched leadtimes
        valid = ~np.isnan(v)
        num = np.einsum("lvf,v->lf", np.where(valid, v, 0.0), w)
        den = np.einsum("lvf,v->lf", valid.astype(np.float64), w)
        return num / np.where(den > 0, den, np.nan)

    out = {}
    for k, v in skill.skills.items():
        if k in ("MSE",):
            out[k] = nanwmean(v)
            continue
        if k == "RMSE" and "MSE" in skill.skills:
            out[k] = np.sqrt(nanwmean(skill.skills["MSE"]))
            continue
        if "RMSE" in k:
            # RMSE-like without a stored MSE (e.g. ensemble RMSE_mean):
            # aggregate as sqrt of the weighted mean of squares so global
            # values are comparable with the deterministic RMSE
            out[k] = np.sqrt(nanwmean(v ** 2))
            continue
        out[k] = nanwmean(v)
    return SkillDataset(out, skill.leadtime_hours, skill.feature_order)


def _banded_summary(skill: SkillDataset, coord: np.ndarray, res: float,
                    area_weights: Optional[np.ndarray]) -> Dict:
    lo = np.floor(coord.min() / res) * res
    edges = np.arange(lo, coord.max() + res, res)
    centers = edges[:-1] + res / 2
    w = (np.ones_like(coord) if area_weights is None
         else np.asarray(area_weights, dtype=np.float64))
    out = {k: [] for k in skill.skills}
    for bi, (e0, e1) in enumerate(zip(edges[:-1], edges[1:])):
        sel = (coord >= e0) & (coord < e1)
        if bi == len(edges) - 2:
            # last band is CLOSED so a node exactly at the max coordinate
            # (e.g. the lat=90 pole on a band edge) is not dropped
            sel = (coord >= e0) & (coord <= e1)
        ws = w[sel]
        ws = ws / ws.sum() if ws.sum() > 0 else ws
        for k, v in skill.skills.items():
            if sel.any():
                # NaN-aware weighted band mean (same policy as
                # global_summary): renormalize weights over valid nodes;
                # an all-NaN band stays NaN instead of biasing toward 0
                vb = v[:, sel]
                valid = ~np.isnan(vb)
                num = np.einsum("lvf,v->lf", np.where(valid, vb, 0.0), ws)
                den = np.einsum("lvf,v->lf", valid.astype(np.float64), ws)
                out[k].append(num / np.where(den > 0, den, np.nan))
            else:
                out[k].append(np.full(v.shape[0:1] + v.shape[2:], np.nan))
    return {"centers": centers,
            "skills": {k: np.stack(v, axis=1) for k, v in out.items()}}


def latitudinal_summary(skill: SkillDataset, lat_res: float = 5.0,
                        area_weights=None) -> Dict:
    """Skills binned in latitude bands (xverif.latitudinal_summary parity)."""
    return _banded_summary(skill, np.asarray(skill.lat), lat_res, area_weights)


def longitudinal_summary(skill: SkillDataset, lon_res: float = 5.0,
                         area_weights=None) -> Dict:
    return _banded_summary(skill, np.asarray(skill.lon), lon_res, area_weights)
