"""Conservative spherical remapping and cell areas (host).

The port's own copy of `deepsphere_weather_tpu/sphere/remap.py`:

1. Voronoi tessellation of each sampling (scipy `SphericalVoronoi`): cell
   areas, and the normalized per-node weights of the area-weighted loss.
2. For every destination cell, its (geodesically convex) Voronoi polygon
   clipped against nearby source polygons with a spherical
   Sutherland-Hodgman pass (half-spaces are planes through the origin).
3. Overlap weight = spherical polygon area of the intersection.

Step 2's clipping runs in the C++ library `native/geometry.cpp` (built at
first use; a failed build raises), as the JAX package's does when its
library is built. `_conservative_weights_numpy` is its plain version,
which the tests hold it against. The weights satisfy the conservativity
invariants, asserted on every build: row sums equal destination cell
areas, column sums source cell areas, and the 'fracarea'-normalized
matrix has unit row sums. This runs
once per sampling pair at geometry build time (cached on disk by the
pools, `ops/pool.py`); the hot path consumes only the resulting matrices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import sparse
from scipy.spatial import SphericalVoronoi, cKDTree

from .samplings import Sampling

__all__ = ["voronoi_cells", "cell_areas", "area_weights", "clean_polygon",
           "spherical_polygon_area", "clip_spherical_polygons",
           "poly_radii", "candidate_pairs", "compute_interpolation_weights",
           "build_pooling_matrices"]


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


def _clip_halfspace(poly: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Clip spherical polygon by half-space {x : normal . x >= 0} (one S-H pass)."""
    m = poly.shape[0]
    if m == 0:
        return poly
    d = poly @ normal
    out = []
    for i in range(m):
        j = (i + 1) % m
        di, dj = d[i], d[j]
        if di >= 0:
            out.append(poly[i])
        if (di >= 0) != (dj >= 0):
            # intersection of edge great circle with clipping plane
            t = di / (di - dj)
            p = poly[i] + t * (poly[j] - poly[i])
            nrm = np.linalg.norm(p)
            if nrm > 1e-14:
                out.append(p / nrm)
    if len(out) < 3:
        return np.zeros((0, 3))
    return np.asarray(out)


def clip_spherical_polygons(poly_a: np.ndarray, poly_b: np.ndarray,
                            center_b: np.ndarray) -> float:
    """Overlap area of convex spherical polygons a and b (b given CCW around center_b)."""
    poly = poly_a
    mb = poly_b.shape[0]
    for i in range(mb):
        e0 = poly_b[i]
        e1 = poly_b[(i + 1) % mb]
        normal = np.cross(e0, e1)
        nn = np.linalg.norm(normal)
        if nn < 1e-12:
            continue
        if np.dot(normal, center_b) < 0:
            normal = -normal
        poly = _clip_halfspace(poly, normal / nn)
        if poly.shape[0] == 0:
            return 0.0
    poly = clean_polygon(poly, center_b, tol=1e-20)
    return spherical_polygon_area(poly)


def _regions_as_arrays(sv: SphericalVoronoi, centers: np.ndarray):
    return [
        clean_polygon(np.asarray(sv.vertices[r]), c)
        for r, c in zip(sv.regions, centers)
    ]


def poly_radii(polys, centers) -> np.ndarray:
    """Chordal radius of each cell polygon around its center."""
    return np.array([
        np.sqrt(np.maximum(2 - 2 * np.min(p @ c), 0)) if len(p) else 0.0
        for p, c in zip(polys, centers)
    ])


def candidate_pairs(src_centers, dst_centers, r_src, r_dst):
    """(dst_idx, src_idx) of cell pairs that can overlap: src centers
    within r_dst[d] + max(r_src) of each dst center. One vectorized
    multi-point KDTree query (workers=-1) — a per-destination Python loop
    cost ~50k round-trips at HEALPix-64."""
    tree = cKDTree(src_centers)
    r_max = float(np.max(r_src)) if len(r_src) else 0.0
    lists = tree.query_ball_point(dst_centers, np.asarray(r_dst) + r_max + 1e-9,
                                  workers=-1)
    counts = [len(l) for l in lists]
    dst_idx = np.repeat(np.arange(len(dst_centers)), counts)
    src_idx = (np.concatenate([np.asarray(l, dtype=np.int64)
                               for l in lists])
               if dst_idx.size else np.zeros(0, dtype=np.int64))
    return dst_idx, src_idx


def compute_interpolation_weights(src: Sampling, dst: Sampling,
                                  normalization: str = "fracarea"
                                  ) -> Tuple[sparse.csr_matrix, np.ndarray, np.ndarray]:
    """Conservative interpolation weights between two samplings.

    Returns (weights, src_area, dst_area) where `weights[d, s]` is — for
    normalization='fracarea' — the fraction of destination cell d's area
    covered by source cell s (row sums = 1), the CDO convention.
    normalization=None returns raw overlap areas.
    """
    from ..native import geometry

    W, src_area, dst_area = geometry.conservative_weights(src, dst)

    # conservativity invariants
    np.testing.assert_allclose(np.asarray(W.sum(axis=1)).ravel(), dst_area, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(W.sum(axis=0)).ravel(), src_area, rtol=1e-4)

    if normalization == "fracarea":
        Wn = sparse.diags(1.0 / dst_area) @ W
        np.testing.assert_allclose(np.asarray(Wn.sum(axis=1)).ravel(), 1.0, rtol=1e-5)
        return Wn.tocsr(), src_area, dst_area
    if normalization is None:
        return W.tocsr(), src_area, dst_area
    raise ValueError(f"unknown normalization {normalization!r}")


def _conservative_weights_numpy(src: Sampling, dst: Sampling):
    """Plain numpy version of `native.geometry.conservative_weights`."""
    sv_src = voronoi_cells(src)
    sv_dst = voronoi_cells(dst)
    src_area = sv_src.calculate_areas()
    dst_area = sv_dst.calculate_areas()
    src_centers = src.coords_3d
    dst_centers = dst.coords_3d
    src_polys = _regions_as_arrays(sv_src, src_centers)
    dst_polys = _regions_as_arrays(sv_dst, dst_centers)

    r_src = poly_radii(src_polys, src_centers)
    r_dst = poly_radii(dst_polys, dst_centers)
    dst_idx, src_idx = candidate_pairs(src_centers, dst_centers, r_src, r_dst)
    rows, cols, vals = [], [], []
    for d, s in zip(dst_idx, src_idx):
        a = clip_spherical_polygons(dst_polys[d], src_polys[s], src_centers[s])
        if a > 1e-16:
            rows.append(d)
            cols.append(s)
            vals.append(a)
    W = sparse.csr_matrix((vals, (rows, cols)),
                          shape=(dst_centers.shape[0], src_centers.shape[0]))
    return W, src_area, dst_area


def build_pooling_matrices(src: Sampling, dst: Sampling):
    """Pool (dst x src) and unpool (src x dst) matrices from conservative weights.

    Pool rows are area-fraction normalized (a weighted average); unpool
    columns are normalized so that unpooling conserves the field.
    """
    W, src_area, dst_area = compute_interpolation_weights(src, dst, normalization=None)
    row_sum = np.asarray(W.sum(axis=1)).ravel()
    col_sum = np.asarray(W.sum(axis=0)).ravel()
    pool = sparse.diags(1.0 / np.maximum(row_sum, 1e-30)) @ W
    unpool = (W @ sparse.diags(1.0 / np.maximum(col_sum, 1e-30))).T
    return pool.tocsr().astype(np.float32), unpool.tocsr().astype(np.float32)
