"""Forecast evolution / error animations (reference
create_gif_forecast_error & co, my_plotting.py:887-1380).

The reference renders matplotlib frames and shells out to ffmpeg for
mp4/GIF. Here the frames are encoded with ffmpeg when the binary is on
PATH (the reference's subprocess contract, my_plotting.py:1058-1067), and
as a GIF with PIL otherwise.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from .skills import _lon180, _style_for  # noqa: E402

__all__ = ["create_gif_forecast_error", "create_gif_forecast_anom_error",
           "create_gif_forecast_evolution"]


def _field_panel(ax, vals, lat, lon, cmap, vmin, vmax, mesh_ctx):
    """One map panel: Voronoi polygons when a (sampling, mesh) context is
    given (reference cartopy polygon look), per-node scatter otherwise.
    Returns the mappable for the colorbar."""
    if mesh_ctx is not None:
        sampling, mesh = mesh_ctx
        from .mesh import plot_polygons

        mappable = plot_polygons(vals, sampling, ax=ax, cmap=cmap, vmin=vmin,
                                 vmax=vmax, add_colorbar=False, mesh=mesh)
    else:
        mappable = ax.scatter(lon, lat, c=vals, s=4, marker="s", cmap=cmap,
                              vmin=vmin, vmax=vmax, linewidths=0)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_xticks([])
    ax.set_yticks([])
    return mappable


def _mesh_ctx(sampling):
    if sampling is None:
        return None
    from .mesh import voronoi_patches

    return (sampling, voronoi_patches(sampling))  # tessellate once per GIF


def _render_frames(frame_fn, n_frames, out_path, fps: int = 4):
    """Render frames with frame_fn(i, fig) and encode GIF (or mp4 if ffmpeg)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp_dir = out_path.parent / (out_path.stem + "_frames")
    tmp_dir.mkdir(exist_ok=True)
    # clear stale frames: ffmpeg consumes the whole contiguous
    # frame_%04d sequence, so leftovers from a previous longer/crashed
    # run would be appended to this animation
    for stale in tmp_dir.glob("frame_*.png"):
        stale.unlink()
    paths = []
    for i in range(n_frames):
        fig = frame_fn(i)
        p = tmp_dir / f"frame_{i:04d}.png"
        fig.savefig(p, dpi=90)
        plt.close(fig)
        paths.append(p)

    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             str(tmp_dir / "frame_%04d.png"), "-loop", "0", str(out_path)],
            check=True, capture_output=True)
    else:
        from PIL import Image

        frames = [Image.open(p) for p in paths]
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    for p in paths:
        p.unlink()
    tmp_dir.rmdir()
    return out_path


def create_gif_forecast_error(forecast, obs_dataset, out_path,
                              frt_index: int = 0, variable: Optional[str] = None,
                              fps: int = 4, sampling=None):
    """Animated (prediction, observation, error) triptych over leadtime
    for one forecast reference time (reference my_plotting.py:887-1074)."""
    mesh_ctx = _mesh_ctx(sampling)
    var = variable or forecast.feature_order[0]
    f = forecast.feature_order.index(var)
    lat, lon = forecast.lat, _lon180(forecast.lon)
    L = forecast.n_leadtime

    preds, obs, kept = [], [], []
    for lt in range(L):
        valid = forecast.valid_time(lt)[frt_index]
        ti = np.searchsorted(obs_dataset.time, valid)
        # EXACT valid-time match only: clamping to the last observation
        # silently rendered 'error' panels against stale truth for
        # leadtimes beyond the obs store
        if ti >= obs_dataset.n_time or obs_dataset.time[ti] != valid:
            continue
        kept.append(lt)
        preds.append(forecast.read_leadtime(lt)[frt_index, :, f])
        obs.append(obs_dataset.read_stacked([ti])[0, :, f])
    if len(kept) < L:
        import warnings
        warnings.warn(
            f"forecast-error animation: dropped {L - len(kept)}/{L} "
            f"leadtimes whose valid times have no matching observation",
            stacklevel=2)
    if not preds:
        raise ValueError("no forecast leadtime matches an observation "
                         "timestep; nothing to animate")
    preds, obs = np.stack(preds), np.stack(obs)
    err = preds - obs
    vmin, vmax = np.percentile(obs, 1), np.percentile(obs, 99)
    emax = np.percentile(np.abs(err), 98) or 1.0

    def frame(i):
        fig, axes = plt.subplots(1, 3, figsize=(14, 3.2))
        for ax, vals, title, cm, v0, v1 in (
            (axes[0], preds[i], f"{var} forecast", "viridis", vmin, vmax),
            (axes[1], obs[i], f"{var} observed", "viridis", vmin, vmax),
            (axes[2], err[i], "error", "RdBu_r", -emax, emax),
        ):
            sc = _field_panel(ax, vals, lat, lon, cm, v0, v1, mesh_ctx)
            ax.set_title(
                f"{title} +{forecast.leadtime_hours[kept[i]]:.0f}h",
                fontsize=9)
            plt.colorbar(sc, ax=ax, shrink=0.75)
        fig.tight_layout()
        return fig

    return _render_frames(frame, len(kept), out_path, fps=fps)


def create_gif_forecast_anom_error(forecast, obs_dataset, scaler, out_path,
                                   frt_index: int = 0,
                                   variable: Optional[str] = None,
                                   anom_title: str = "Anomaly",
                                   fps: int = 4, sampling=None):
    """Animated (observed, predicted, error) triptych in ANOMALY space:
    both forecast and observations are transformed by `scaler` (typically a
    standardized AnomalyScaler) at each frame's valid time before
    differencing (reference create_gif_forecast_anom_error,
    my_plotting.py:1077-1270). Standardized-anomaly color limits follow the
    reference: field ±4, error ±6."""
    mesh_ctx = _mesh_ctx(sampling)
    var = variable or forecast.feature_order[0]
    f = forecast.feature_order.index(var)
    lat, lon = forecast.lat, _lon180(forecast.lon)
    L = forecast.n_leadtime

    preds, obs, kept = [], [], []
    for lt in range(L):
        valid = forecast.valid_time(lt)[frt_index]
        ti = np.searchsorted(obs_dataset.time, valid)
        if ti >= obs_dataset.n_time or obs_dataset.time[ti] != valid:
            continue      # no matching observation for this leadtime
        kept.append(lt)
        t = np.asarray([valid])
        pred_lt = forecast.read_leadtime(lt)[frt_index][None]   # [1, V, F]
        obs_lt = obs_dataset.read_stacked([ti])                 # [1, V, F]
        preds.append(scaler.transform(pred_lt, time=t)[0, :, f])
        obs.append(scaler.transform(obs_lt, time=t)[0, :, f])
    if not preds:
        raise ValueError("no forecast leadtime matches an observation "
                         "timestep; nothing to animate")
    preds, obs = np.stack(preds), np.stack(obs)
    err = preds - obs

    def frame(i):
        fig, axes = plt.subplots(1, 3, figsize=(14, 3.2))
        for ax, vals, title, cm, v0, v1 in (
            (axes[0], obs[i], f"{var} {anom_title} observed",
             "Spectral_r", -4, 4),
            (axes[1], preds[i], f"{var} {anom_title} predicted",
             "Spectral_r", -4, 4),
            (axes[2], err[i], f"{anom_title} error", "RdBu_r", -6, 6),
        ):
            sc = _field_panel(ax, vals, lat, lon, cm, v0, v1, mesh_ctx)
            ax.set_title(
                f"{title} +{forecast.leadtime_hours[kept[i]]:.0f}h",
                fontsize=9)
            plt.colorbar(sc, ax=ax, shrink=0.75, extend="both")
        fig.tight_layout()
        return fig

    return _render_frames(frame, len(kept), out_path, fps=fps)


def create_gif_forecast_evolution(forecast, out_path, frt_index: int = 0,
                                  variable: Optional[str] = None,
                                  fps: int = 4, sampling=None):
    """Animated forecast field evolution (reference my_plotting.py:1271)."""
    mesh_ctx = _mesh_ctx(sampling)
    var = variable or forecast.feature_order[0]
    f = forecast.feature_order.index(var)
    lat, lon = forecast.lat, _lon180(forecast.lon)
    L = forecast.n_leadtime
    fields = np.stack([forecast.read_leadtime(lt)[frt_index, :, f]
                       for lt in range(L)])
    vmin, vmax = np.percentile(fields, 1), np.percentile(fields, 99)

    def frame(i):
        fig, ax = plt.subplots(figsize=(7, 3.6))
        sc = _field_panel(ax, fields[i], lat, lon, "viridis", vmin, vmax,
                          mesh_ctx)
        ax.set_title(f"{var} +{forecast.leadtime_hours[i]:.0f}h", fontsize=10)
        plt.colorbar(sc, ax=ax, shrink=0.8)
        fig.tight_layout()
        return fig

    return _render_frames(frame, L, out_path, fps=fps)
