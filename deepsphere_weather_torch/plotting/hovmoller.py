"""Hovmoller diagrams (xscaler.HovmollerDiagram / reference
create_hovmoller_plots parity, my_plotting.py:757-886).

A Hovmoller diagram shows the zonal (or meridional) mean of a field as a
function of time: time on one axis, latitude (or longitude) bins on the
other. Used by the reference to inspect multi-year free-running
simulations (scripts_figs/hovmoller_1year_sims.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

__all__ = ["hovmoller_data", "plot_hovmoller", "create_hovmoller_plots",
           "HovmollerDiagram"]


def hovmoller_data(values: np.ndarray, coord: np.ndarray,
                   bin_res: float = 5.0,
                   area_weights: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Bin [time, node] values along a coordinate -> ([time, bins], centers)."""
    lo = np.floor(coord.min() / bin_res) * bin_res
    edges = np.arange(lo, coord.max() + bin_res, bin_res)
    centers = edges[:-1] + bin_res / 2
    w = np.ones_like(coord) if area_weights is None else np.asarray(area_weights)
    out = np.full((values.shape[0], len(centers)), np.nan)
    for i, (e0, e1) in enumerate(zip(edges[:-1], edges[1:])):
        sel = (coord >= e0) & (coord < e1)
        if i == len(edges) - 2:
            # last bin is CLOSED so nodes exactly at the max coordinate
            # (e.g. the 355-degree meridian with 5-degree bins) are kept
            sel = (coord >= e0) & (coord <= e1)
        if sel.any():
            ws = w[sel] / w[sel].sum()
            out[:, i] = values[:, sel] @ ws
    return out, centers


def plot_hovmoller(values: np.ndarray, time: np.ndarray, coord: np.ndarray,
                   ax=None, bin_dim: str = "lat", bin_res: float = 5.0,
                   cmap: str = "RdBu_r", title: str = "",
                   area_weights=None):
    """Hovmoller panel: x = time, y = coordinate bins."""
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    hov, centers = hovmoller_data(values, coord, bin_res, area_weights)
    # FULL-resolution mesh coordinates: truncating to days collapsed all
    # sub-daily samples of one day onto a single x position (zero-width
    # quads for 3 of every 4 columns of 6-hourly data); days appear only
    # in the tick labels
    t = np.asarray(time, dtype="datetime64[ns]")
    mesh = ax.pcolormesh(t.astype("datetime64[s]").astype(float),
                         centers, hov.T, cmap=cmap, shading="auto")
    n_ticks = 6
    ticks = np.linspace(0, len(t) - 1, n_ticks).astype(int)
    ax.set_xticks(t[ticks].astype("datetime64[s]").astype(float))
    ax.set_xticklabels([str(x) for x in t[ticks].astype("datetime64[D]")],
                       rotation=30, fontsize=7)
    ax.set_ylabel(bin_dim)
    ax.set_title(title, fontsize=9)
    plt.colorbar(mesh, ax=ax, shrink=0.9)
    return ax


def create_hovmoller_plots(dataset, fig_dir, bin_dim: str = "lat",
                           bin_res: float = 5.0, area_weights=None,
                           time_subset: Optional[slice] = None):
    """One Hovmoller panel per variable of a SphericalDataset
    (reference create_hovmoller_plots, my_plotting.py:757-886)."""
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    coord = dataset.lat if bin_dim == "lat" else dataset.lon
    sl = time_subset or slice(None)
    t_idx = np.arange(dataset.n_time)[sl]
    data = dataset.read_stacked(t_idx)          # [T, V, F]
    time = dataset.time[sl]
    for f, var in enumerate(dataset.feature_order):
        fig, ax = plt.subplots(figsize=(10, 4))
        plot_hovmoller(data[:, :, f], time, coord, ax=ax, bin_dim=bin_dim,
                       bin_res=bin_res, title=f"{var} Hovmoller ({bin_dim})",
                       area_weights=area_weights)
        fig.tight_layout()
        fig.savefig(fig_dir / f"hovmoller_{var}_{bin_dim}.png", dpi=120)
        plt.close(fig)
    return fig_dir


class HovmollerDiagram:
    """Object-style API matching xscaler.HovmollerDiagram (reference usage:
    scripts_figs/hovmoller_1year_sims.py:16): bin once at construction,
    plot on demand; binned data exposed as `.data` / `.bins`."""

    def __init__(self, values: np.ndarray, time: np.ndarray,
                 coord: np.ndarray, bin_dim: str = "lat",
                 bin_res: float = 5.0, area_weights=None):
        self.time = np.asarray(time)
        self.bin_dim = bin_dim
        self.bin_res = bin_res
        self.coord = np.asarray(coord)
        self.area_weights = area_weights
        self.data, self.bins = hovmoller_data(
            np.asarray(values), self.coord, bin_res, area_weights)

    def plot(self, ax=None, cmap: str = "RdBu_r", title: str = ""):
        if ax is None:
            _, ax = plt.subplots(figsize=(10, 4))
        # full-resolution x coordinates; days only in the tick labels
        # (day-truncated coordinates collapsed sub-daily columns)
        t = np.asarray(self.time, dtype="datetime64[ns]")
        mesh = ax.pcolormesh(
            t.astype("datetime64[s]").astype(float), self.bins, self.data.T,
            cmap=cmap, shading="auto")
        # date tick labels (same formatting as plot_hovmoller)
        ticks = np.linspace(0, len(t) - 1, 6).astype(int)
        ax.set_xticks(t[ticks].astype("datetime64[s]").astype(float))
        ax.set_xticklabels([str(x) for x in t[ticks].astype("datetime64[D]")],
                           rotation=30, fontsize=7)
        ax.set_ylabel(self.bin_dim)
        ax.set_title(title, fontsize=9)
        plt.colorbar(mesh, ax=ax, shrink=0.9)
        return ax
