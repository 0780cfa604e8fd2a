"""Skill plots: maps, leadtime curves, distributions, benchmarks.

Parity with the reference's plotting layer
(reference: modules/my_plotting.py:215-756): per-leadtime skill maps,
skill-vs-leadtime curves, distribution plots and multi-model benchmark
comparisons. cartopy is not a dependency; when a sampling
is supplied, maps render as filled spherical-Voronoi polygons in a
PlateCarree-like frame (plotting.mesh — the reference's polygon-mesh
look), otherwise as per-node scatter fields.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

__all__ = ["plot_map", "plot_skill_maps", "plot_global_skill",
           "plot_global_skills", "plot_skills_distribution",
           "benchmark_global_skill", "benchmark_global_skills"]

# Variable/skill colormap + limit conventions
# (reference: my_plotting.py:31-213 get_var_clim/get_var_cmap)
_SKILL_STYLE = {
    "BIAS": dict(cmap="RdBu_r", sym=True),
    "RMSE": dict(cmap="viridis", sym=False),
    "MAE": dict(cmap="viridis", sym=False),
    "pearson_R2": dict(cmap="magma", vmin=0, vmax=1),
    "rSD": dict(cmap="RdBu_r", center=1.0),
    "error_CoV": dict(cmap="viridis", sym=False),
    "KGE": dict(cmap="magma", vmin=-1, vmax=1),
    "NSE": dict(cmap="magma", vmin=-1, vmax=1),
}


def _lon180(lon):
    lon = np.asarray(lon).copy()
    lon[lon > 180] -= 360
    return lon


def plot_map(values: np.ndarray, lat, lon, ax=None, title: str = "",
             cmap: str = "viridis", vmin=None, vmax=None, s: float = 4.0):
    """Render a per-node field as a world scatter map."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    sc = ax.scatter(_lon180(lon), lat, c=values, s=s, cmap=cmap,
                    vmin=vmin, vmax=vmax, marker="s", linewidths=0)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_title(title, fontsize=9)
    ax.set_xticks([])
    ax.set_yticks([])
    plt.colorbar(sc, ax=ax, shrink=0.8)
    return ax


def _style_for(skill_name: str, vals: np.ndarray) -> Dict:
    st = dict(_SKILL_STYLE.get(skill_name, dict(cmap="viridis", sym=False)))
    finite = vals[np.isfinite(vals)]
    if len(finite) == 0:
        return dict(cmap=st.get("cmap", "viridis"))
    if "vmin" in st:
        return dict(cmap=st["cmap"], vmin=st["vmin"], vmax=st["vmax"])
    if st.get("sym"):
        m = np.percentile(np.abs(finite), 98)
        return dict(cmap=st["cmap"], vmin=-m, vmax=m)
    if "center" in st:
        m = np.percentile(np.abs(finite - st["center"]), 98)
        return dict(cmap=st["cmap"], vmin=st["center"] - m,
                    vmax=st["center"] + m)
    return dict(cmap=st["cmap"], vmin=np.percentile(finite, 1),
                vmax=np.percentile(finite, 99))


def plot_skill_maps(skill_ds, fig_dir, skills: Optional[List[str]] = None,
                    leadtime_indices: Optional[List[int]] = None,
                    sampling=None):
    """Per-leadtime per-variable skill maps
    (reference plot_skill_maps, my_plotting.py:271-360).

    With `sampling` given, fields render as filled Voronoi polygons
    (the reference's cartopy polygon-mesh look, via plotting.mesh);
    otherwise as per-node scatter."""
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    skills = skills or ["BIAS", "RMSE", "rSD", "pearson_R2", "error_CoV"]
    L = len(skill_ds.leadtime_hours)
    if leadtime_indices is None:
        leadtime_indices = sorted(set([0, L // 2, L - 1]))
    mesh = None
    if sampling is not None:
        from .mesh import voronoi_patches
        mesh = voronoi_patches(sampling)  # tessellate once for all panels
    for f, var in enumerate(skill_ds.feature_order):
        # squeeze=False keeps axes 2-D (atleast_2d gave (1, n) for a
        # single-leadtime column, crashing axes[i, 0] for i > 0)
        fig, axes = plt.subplots(len(skills), len(leadtime_indices),
                                 figsize=(4.2 * len(leadtime_indices),
                                          2.6 * len(skills)),
                                 squeeze=False)
        for i, sk in enumerate(skills):
            vals_all = skill_ds[sk][:, :, f]
            style = _style_for(sk, vals_all)
            for j, lt in enumerate(leadtime_indices):
                title = f"{var} {sk} +{skill_ds.leadtime_hours[lt]:.0f}h"
                if mesh is not None:
                    from .mesh import plot_polygons
                    plot_polygons(vals_all[lt], sampling, ax=axes[i, j],
                                  title=title, mesh=mesh, **style)
                    axes[i, j].set_xticks([])
                    axes[i, j].set_yticks([])
                else:
                    plot_map(vals_all[lt], skill_ds.lat, skill_ds.lon,
                             ax=axes[i, j], title=title, **style)
        fig.tight_layout()
        fig.savefig(fig_dir / f"skill_maps_{var}.png", dpi=110)
        plt.close(fig)
    return fig_dir


def plot_global_skill(global_skill, skill_name: str = "RMSE", ax=None,
                      label: Optional[str] = None):
    """Skill vs leadtime curve (reference plot_global_skill,
    my_plotting.py:364-464)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    lt = global_skill.leadtime_hours
    for f, var in enumerate(global_skill.feature_order):
        ax.plot(lt, global_skill[skill_name][:, f],
                label=f"{label + ' ' if label else ''}{var}", marker="o",
                ms=2.5, lw=1.2)
    ax.set_xlabel("leadtime [h]")
    ax.set_ylabel(skill_name)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    return ax


def plot_global_skills(global_skill, fig_dir,
                       skills: Optional[List[str]] = None):
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    skills = skills or ["BIAS", "RMSE", "rSD", "pearson_R2", "error_CoV",
                        "KGE"]
    fig, axes = plt.subplots(2, 3, figsize=(14, 7))
    for ax, sk in zip(axes.ravel(), skills):
        plot_global_skill(global_skill, sk, ax=ax)
        ax.set_title(sk)
    fig.tight_layout()
    fig.savefig(fig_dir / "global_skills.png", dpi=120)
    plt.close(fig)
    return fig_dir


def plot_skills_distribution(skill_ds, fig_dir,
                             skills: Optional[List[str]] = None):
    """Boxplot of per-node skills per leadtime (reference
    plot_skills_distribution, my_plotting.py:465)."""
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    skills = skills or ["RMSE", "BIAS"]
    for f, var in enumerate(skill_ds.feature_order):
        fig, axes = plt.subplots(1, len(skills),
                                 figsize=(6 * len(skills), 4))
        axes = np.atleast_1d(axes)
        for ax, sk in zip(axes, skills):
            data = [skill_ds[sk][lt, :, f][np.isfinite(skill_ds[sk][lt, :, f])]
                    for lt in range(len(skill_ds.leadtime_hours))]
            ax.boxplot(data, showfliers=False)
            ax.set_xlabel("leadtime index")
            ax.set_title(f"{var} {sk}")
        fig.tight_layout()
        fig.savefig(fig_dir / f"skills_distribution_{var}.png", dpi=110)
        plt.close(fig)
    return fig_dir


def benchmark_global_skill(skill_dict: Dict[str, "object"], skill_name: str,
                           fig_path, benchmarks: Optional[Dict] = None):
    """Multi-model skill comparison (reference benchmark_global_skill,
    my_plotting.py:529-756). skill_dict maps model name -> global skill."""
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, gs in skill_dict.items():
        plot_global_skill(gs, skill_name, ax=ax, label=name)
    if benchmarks:
        for name, gs in benchmarks.items():
            lt = gs.leadtime_hours
            for f, var in enumerate(gs.feature_order):
                ax.plot(lt, gs[skill_name][:, f], "--", lw=1.0,
                        label=f"{name} {var}")
    ax.legend(fontsize=7)
    ax.set_title(skill_name)
    Path(fig_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(fig_path, dpi=120)
    plt.close(fig)
    return fig_path


def benchmark_global_skills(skill_dict: Dict, fig_dir,
                            skills: Optional[List[str]] = None,
                            benchmarks: Optional[Dict] = None):
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    for sk in (skills or ["RMSE", "BIAS", "pearson_R2"]):
        benchmark_global_skill(skill_dict, sk, fig_dir / f"benchmark_{sk}.png",
                               benchmarks=benchmarks)
    return fig_dir
