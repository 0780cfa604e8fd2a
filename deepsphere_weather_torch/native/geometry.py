"""ctypes binding of the C++ geometry library (`native/geometry.cpp`).

The port's copy of `deepsphere_weather_tpu/native/geometry.py`: the
conservative spherical-polygon-overlap weights between two Voronoi
tessellations (the CDO replacement of `sphere/remap.py`). Polygon
preparation and candidate pruning are `sphere/remap.py`'s, shared with the
plain numpy version (`_conservative_weights_numpy`, which the tests hold
this against); only the clipping runs in C++. The library is built at
first use (`native/build.py`); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["conservative_weights"]

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_longlong)


def _lib():
    from .build import load_library

    lib = load_library("geometry")
    fn = lib.dsw_conservative_weights
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        _D, ctypes.c_longlong, _L, _D, ctypes.c_longlong,  # dst polygons
        _D, ctypes.c_longlong, _L, _D, ctypes.c_longlong,  # src polygons
        _L, ctypes.c_longlong,                              # candidate pairs
        _D,                                                 # out areas
    ]
    return lib


def _flatten(polys):
    """[sum_m, 3] vertices (C-contiguous float64) and [n + 1] offsets."""
    offsets = np.zeros(len(polys) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(p) for p in polys])
    flat = (np.concatenate(polys, axis=0) if polys else np.zeros((0, 3)))
    return np.ascontiguousarray(flat, dtype=np.float64), offsets


def conservative_weights(src, dst):
    """Raw overlap areas W [n_dst, n_src] (scipy CSR) and the source and
    destination cell areas: the C++ counterpart of
    `sphere.remap._conservative_weights_numpy`."""
    from scipy import sparse

    from ..sphere.remap import (_regions_as_arrays, candidate_pairs,
                                poly_radii, voronoi_cells)

    lib = _lib()
    sv_src = voronoi_cells(src)
    sv_dst = voronoi_cells(dst)
    src_area = sv_src.calculate_areas()
    dst_area = sv_dst.calculate_areas()
    src_centers = np.ascontiguousarray(src.coords_3d, dtype=np.float64)
    dst_centers = np.ascontiguousarray(dst.coords_3d, dtype=np.float64)
    src_polys = _regions_as_arrays(sv_src, src_centers)
    dst_polys = _regions_as_arrays(sv_dst, dst_centers)
    src_flat, src_off = _flatten(src_polys)
    dst_flat, dst_off = _flatten(dst_polys)
    dst_idx, src_idx = candidate_pairs(
        src_centers, dst_centers, poly_radii(src_polys, src_centers),
        poly_radii(dst_polys, dst_centers))
    pairs = np.ascontiguousarray(
        np.stack([dst_idx, src_idx], axis=1).astype(np.int64))
    out = np.zeros(len(pairs), dtype=np.float64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_written = lib.dsw_conservative_weights(
        ptr(dst_flat, ctypes.c_double), dst_flat.shape[0],
        ptr(dst_off, ctypes.c_longlong), ptr(dst_centers, ctypes.c_double),
        dst_centers.shape[0],
        ptr(src_flat, ctypes.c_double), src_flat.shape[0],
        ptr(src_off, ctypes.c_longlong), ptr(src_centers, ctypes.c_double),
        src_centers.shape[0],
        ptr(pairs, ctypes.c_longlong), pairs.shape[0],
        ptr(out, ctypes.c_double))
    if n_written != len(pairs):
        raise RuntimeError(f"dsw_conservative_weights wrote {n_written} of "
                           f"{len(pairs)} pairs")
    keep = out > 1e-16
    W = sparse.csr_matrix(
        (out[keep], (pairs[keep, 0], pairs[keep, 1])),
        shape=(dst_centers.shape[0], src_centers.shape[0]))
    return W, src_area, dst_area
