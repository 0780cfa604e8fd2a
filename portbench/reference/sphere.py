"""The prepared Laplacians of a nested HEALPix sampling, worked out again.

A frozen, self-contained copy of the published construction (DeepSphere's
knn graph, as the deepsphere-weather reference builds it with pygsp and
healpy): pixel centres of the nested HEALPix tessellation (Gorski et al.
2005), the k nearest neighbours by 3D euclidean distance, gaussian weights
exp(-d^2 / sigma^2) with sigma the mean neighbour distance, symmetrised by
averaging, the normalised Laplacian I - D^-1/2 W D^-1/2, and its spectrum
rescaled to [-1, 1] by the largest eigenvalue (ARPACK from a fixed start
vector, times 1 + 2 tol). numpy and scipy only; it imports nothing of the
program. The graphs found by name (`graphs/<sampling>_<graph_type>.py`)
build their levels from these.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as sparse_linalg
from scipy.spatial import cKDTree

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)
LMAX_TOL = 5e-3


def _compress_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v &= np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v.astype(np.int64)


def healpix_nest_xyz(nside: int) -> np.ndarray:
    """Unit-sphere pixel centres [12 nside^2, 3] in nested order, through
    (lon, lat) in degrees as the published samplings are stored."""
    ipix = np.arange(12 * nside * nside, dtype=np.int64)
    face = ipix // (nside * nside)
    pf = ipix % (nside * nside)
    x, y = _compress_bits(pf), _compress_bits(pf >> 1)
    jr = _JRLL[face] * nside - x - y - 1
    north, south = jr < nside, jr > 3 * nside
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    nrf = nr.astype(np.float64)
    z = np.where(north, 1.0 - nrf * nrf / (3.0 * nside * nside),
                 np.where(south, -1.0 + nrf * nrf / (3.0 * nside * nside),
                          (2.0 * nside - jr) * 2.0 / (3.0 * nside)))
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    jp = (_JPLL[face] * nr + x - y + 1 + kshift) / 2.0
    jp = np.where(jp > 4 * nside, jp - 4 * nside, jp)
    jp = np.where(jp < 1, jp + 4 * nside, jp)
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / (2.0 * nrf))
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    lat = np.deg2rad(90.0 - np.rad2deg(theta))
    lon = np.deg2rad(np.rad2deg(phi) % 360.0)
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=1)


def knn_laplacian(coords: np.ndarray, k: int) -> sparse.csr_matrix:
    """The rescaled normalised Laplacian of the gaussian knn graph, fp32."""
    n = coords.shape[0]
    k_eff = min(k, n - 1)
    dist, idx = cKDTree(coords).query(coords, k=k_eff + 1)
    dist, idx = dist[:, 1:], idx[:, 1:]
    w = np.exp(-(dist ** 2) / float(np.mean(dist) ** 2))
    W = sparse.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k_eff),
                                       idx.ravel())), shape=(n, n))
    W = (W + W.T) / 2.0
    W.setdiag(0.0)
    W.eliminate_zeros()
    d = np.asarray(W.sum(axis=1)).ravel()
    d_isqrt = sparse.diags(np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)),
                                    0.0))
    lap = (sparse.identity(n, format="csr") - d_isqrt @ W @ d_isqrt).tocsr()
    lap = lap.astype(np.float64)
    lmax = sparse_linalg.eigs(lap, k=1, tol=LMAX_TOL, ncv=min(n, 10),
                              v0=np.full(n, 1.0 / np.sqrt(n)),
                              return_eigenvectors=False)
    lmax = float(np.real(lmax[0])) * (1 + 2 * LMAX_TOL)
    lap = lap * (2.0 / lmax) - sparse.identity(n, format="csr")
    return lap.tocsr().astype(np.float32)
