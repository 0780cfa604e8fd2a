"""Spherical Voronoi cell areas for the area-weighted loss (numpy, scipy).

The port's own copy of the area part of `deepsphere_weather_tpu/sphere/remap.py`:
the Voronoi tessellation of a sampling (scipy `SphericalVoronoi`), its cell
areas and the normalized per-node loss weights, plus the polygon helpers
(`clean_polygon`, `spherical_polygon_area`). The conservative remap
weights and their polygon clipping are not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import SphericalVoronoi

from .samplings import Sampling

__all__ = ["voronoi_cells", "cell_areas", "area_weights", "clean_polygon",
           "spherical_polygon_area"]


def voronoi_cells(sampling: Sampling):
    """Voronoi vertices + per-node CCW-ordered regions for a sampling."""
    sv = SphericalVoronoi(sampling.coords_3d)
    sv.sort_vertices_of_regions()
    return sv


def cell_areas(sampling: Sampling) -> np.ndarray:
    """Spherical Voronoi cell areas (unit sphere; sums to 4*pi)."""
    areas = voronoi_cells(sampling).calculate_areas()
    np.testing.assert_allclose(areas.sum(), 4 * np.pi, rtol=1e-6)
    return areas


def area_weights(sampling: Sampling) -> np.ndarray:
    """Normalized per-node area weights for the loss (sum to 1)."""
    a = cell_areas(sampling)
    return (a / a.sum()).astype(np.float32)


def clean_polygon(verts: np.ndarray, center: np.ndarray,
                  tol: float = 1e-12) -> np.ndarray:
    """Remove (near-)duplicate vertices and enforce CCW orientation around
    center: scipy's SphericalVoronoi emits duplicate region vertices for
    cocircular generators, which HEALPix grids have, and does not
    guarantee each cell's orientation."""
    m = verts.shape[0]
    if m == 0:
        return verts
    keep = np.ones(m, dtype=bool)
    for i in range(m):
        j = (i + 1) % m
        if np.sum((verts[i] - verts[j]) ** 2) < tol:
            keep[j if j > i else i] = False
    verts = verts[keep]
    if verts.shape[0] >= 3:
        sgn = 0.0
        for i in range(verts.shape[0]):
            sgn += np.dot(np.cross(verts[i], verts[(i + 1) % verts.shape[0]]),
                          center)
        if sgn < 0:
            verts = verts[::-1]
    return verts


def spherical_polygon_area(verts: np.ndarray) -> float:
    """Area of a CCW spherical polygon (unit sphere).

    Fan-triangulates from the normalized centroid and sums the signed
    spherical triangle excesses by the van Oosterom-Strackee formula
    tan(E/2) = a.(b x c) / (1 + a.b + b.c + c.a), which stays robust for
    degenerate, near-duplicate vertices (each such triangle adds ~0)."""
    m = verts.shape[0]
    if m < 3:
        return 0.0
    c = verts.mean(axis=0)
    nc = np.linalg.norm(c)
    if nc < 1e-14:
        return 0.0
    c = c / nc
    a = verts
    b = np.roll(verts, -1, axis=0)
    num = np.einsum("ij,ij->i", np.cross(a, b), c[None, :].repeat(m, 0))
    den = 1.0 + a @ c + np.einsum("ij,ij->i", a, b) + b @ c
    area = float(np.sum(2.0 * np.arctan2(num, den)))
    return max(area, 0.0)
