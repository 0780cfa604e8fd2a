"""Voronoi polygon-mesh plotting (xsphere plotting parity, SURVEY.md §2.11).

The reference plots fields as filled spherical Voronoi polygons through
the xarray `.sphere` accessor + cartopy (xsphere.plot / plot_mesh).
cartopy is not a dependency; polygons are drawn as a matplotlib
PolyCollection in a PlateCarree frame, with dateline-crossing cells split
correctly — visually equivalent for global fields.
"""

from __future__ import annotations

from typing import Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.collections import PolyCollection  # noqa: E402

__all__ = ["voronoi_patches", "plot_mesh", "plot_polygons", "SphereField"]


def voronoi_patches(sampling):
    """Per-node polygon vertex lists in (lon, lat) degrees, dateline-safe.

    Returns (patches, node_index): cells crossing the dateline are emitted
    twice (shifted copies), with node_index mapping patches -> node.
    """
    from ..sphere.remap import clean_polygon, voronoi_cells

    sv = voronoi_cells(sampling)
    centers = sampling.coords_3d
    patches, node_index = [], []
    for i, region in enumerate(sv.regions):
        poly = clean_polygon(np.asarray(sv.vertices[region]), centers[i])
        if len(poly) < 3:
            continue
        lat = np.rad2deg(np.arcsin(np.clip(poly[:, 2], -1, 1)))
        lon = np.rad2deg(np.arctan2(poly[:, 1], poly[:, 0]))
        # unwrap around the cell center to keep the polygon contiguous
        c_lon = np.rad2deg(np.arctan2(centers[i, 1], centers[i, 0]))
        lon = c_lon + (lon - c_lon + 180) % 360 - 180
        verts = np.stack([lon, lat], axis=1)
        if lon.max() > 180:
            patches.append(verts - [360, 0])
            node_index.append(i)
        if lon.min() < -180:
            patches.append(verts + [360, 0])
            node_index.append(i)
        patches.append(verts)
        node_index.append(i)
    return patches, np.asarray(node_index)


def plot_polygons(values: np.ndarray, sampling, ax=None, cmap="viridis",
                  vmin=None, vmax=None, edgecolors="none",
                  linewidths: float = 0.05, title: str = "",
                  add_colorbar: bool = True, mesh=None):
    """Field as filled Voronoi polygons (xsphere._plot parity).

    `mesh` optionally supplies precomputed `voronoi_patches(sampling)`
    output (SphereField caches it — recomputing the tessellation costs
    seconds at HEALPix-64). Returns the PolyCollection (its `.axes` /
    `.figure` reach the containing axes; pass it to `plt.colorbar`)."""
    values = np.asarray(values)
    if values.shape[-1] != sampling.n_nodes:
        raise ValueError(
            f"values last dim {values.shape[-1]} != sampling.n_nodes "
            f"{sampling.n_nodes} ({sampling.name}) — wrong sampling passed?")
    if ax is None:
        _, ax = plt.subplots(figsize=(9, 4.5))
    patches, node_index = mesh if mesh is not None else voronoi_patches(
        sampling)
    pc = PolyCollection(patches, array=values[node_index],
                        cmap=cmap, edgecolors=edgecolors,
                        linewidths=linewidths)
    if vmin is not None or vmax is not None:
        pc.set_clim(vmin, vmax)
    ax.add_collection(pc)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_title(title, fontsize=10)
    if add_colorbar:
        plt.colorbar(pc, ax=ax, shrink=0.8)
    return pc


def plot_mesh(sampling, ax=None, edgecolors="k", linewidths: float = 0.2,
              title: Optional[str] = None, mesh=None):
    """Wireframe of the Voronoi tessellation (xsphere plot_mesh parity)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(9, 4.5))
    patches, _ = mesh if mesh is not None else voronoi_patches(sampling)
    pc = PolyCollection(patches, facecolors="none", edgecolors=edgecolors,
                        linewidths=linewidths)
    ax.add_collection(pc)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_title(title or f"{sampling.name} mesh ({sampling.n_nodes} cells)",
                 fontsize=10)
    return ax


class SphereField:
    """xsphere-accessor-style wrapper over (values, sampling).

    The reference reaches these through the xarray accessor
    (`ds.sphere.add_SphericalVoronoiMesh / .has_mesh / .plot / .plot_mesh`,
    SURVEY.md §2.11); here the same surface lives on a small value+sampling
    wrapper, with the mesh (polygon patches) computed lazily and cached.
    """

    def __init__(self, values, sampling):
        self.values = np.asarray(values)
        self.sampling = sampling
        self._mesh = None

    def add_SphericalVoronoiMesh(self) -> "SphereField":
        """Compute and cache the Voronoi polygon mesh (chainable)."""
        if self._mesh is None:
            self._mesh = voronoi_patches(self.sampling)
        return self

    @property
    def has_mesh(self) -> bool:
        return self._mesh is not None

    def plot(self, **kwargs):
        """Filled-polygon field plot (xsphere .sphere.plot parity).
        Returns the PolyCollection; `.figure` reaches the figure."""
        self.add_SphericalVoronoiMesh()
        return plot_polygons(self.values, self.sampling, mesh=self._mesh,
                             **kwargs)

    def plot_mesh(self, **kwargs):
        """Tessellation wireframe (xsphere .sphere.plot_mesh parity)."""
        self.add_SphericalVoronoiMesh()
        return plot_mesh(self.sampling, mesh=self._mesh, **kwargs)
