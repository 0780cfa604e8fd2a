"""Spherical graphs and Laplacians (numpy/scipy, build time).

The port's own copy of `deepsphere_weather_tpu/sphere/graph.py`:
gaussian-kernel knn adjacency and its symmetric normalized Laplacian
('knn'), the cotangent Laplacian of the spherical Delaunay
triangulation, mass-lumped M^-1 L ('voronoi', not symmetric) or
M^-1/2 L M^-1/2 ('mesh', symmetric), the largest eigenvalue with a fixed
ARPACK start vector, the rescale to [-1, 1], and the fixed-width ELL
arrays of a Laplacian (`laplacian_to_ell`, which the ELL operators of
`ops/bcsr.py` hold). The arithmetic is the same line for line, so the
prepared Laplacian equals the JAX package's to fp32 round-off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as sparse_linalg
from scipy.spatial import ConvexHull, cKDTree

from .samplings import Sampling, build_sampling

__all__ = ["SphereGraph", "knn_adjacency", "normalized_laplacian",
           "estimate_lmax", "scale_operator", "prepare_laplacian",
           "triangulate", "compute_cotan_laplacian", "laplacian_to_ell",
           "build_graph"]


@dataclasses.dataclass
class SphereGraph:
    """A spherical sampling + its graph and prepared Laplacian."""

    sampling: Sampling
    k: int
    # the knn adjacency; None for the cotangent graph types, whose
    # operator comes from the triangulation
    W: Optional[sparse.csr_matrix]
    L: sparse.csr_matrix          # eigenvalues rescaled to [-1, 1]
    # False for 'voronoi' (M^-1 L): the block-sparse operator then carries
    # the transposed layout for its backward
    is_symmetric: bool = True

    @property
    def n_nodes(self) -> int:
        return self.sampling.n_nodes

    @property
    def lon(self) -> np.ndarray:
        return self.sampling.lon

    @property
    def lat(self) -> np.ndarray:
        return self.sampling.lat

    @property
    def coords_3d(self) -> np.ndarray:
        return self.sampling.coords_3d

    def laplacian_dense(self, dtype=np.float32) -> np.ndarray:
        return np.asarray(self.L.todense(), dtype=dtype)

    def laplacian_ell(self, dtype=np.float32):
        return laplacian_to_ell(self.L, dtype=dtype)


def knn_adjacency(coords: np.ndarray, k: int) -> sparse.csr_matrix:
    """Symmetric gaussian-kernel knn adjacency: k nearest neighbours by 3D
    euclidean distance, weight exp(-d^2 / sigma^2) with sigma the mean knn
    distance, symmetrized by averaging."""
    n = coords.shape[0]
    k_eff = min(k, n - 1)
    tree = cKDTree(coords)
    dist, idx = tree.query(coords, k=k_eff + 1)
    dist, idx = dist[:, 1:], idx[:, 1:]  # drop self
    sigma2 = float(np.mean(dist) ** 2)
    w = np.exp(-(dist ** 2) / sigma2)
    rows = np.repeat(np.arange(n), k_eff)
    W = sparse.csr_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n))
    W = (W + W.T) / 2.0
    W.setdiag(0.0)
    W.eliminate_zeros()
    return W


def normalized_laplacian(W: sparse.csr_matrix) -> sparse.csr_matrix:
    d = np.asarray(W.sum(axis=1)).ravel()
    d_inv_sqrt = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
    D = sparse.diags(d_inv_sqrt)
    n = W.shape[0]
    return (sparse.identity(n, format="csr") - D @ W @ D).tocsr()


def estimate_lmax(laplacian: sparse.spmatrix, tol: float = 5e-3) -> float:
    """Largest-eigenvalue estimate with a 2*tol safety margin.

    ARPACK starts from a FIXED vector, so the estimate is a pure function
    of the matrix (a random start would rescale the Laplacian differently
    in every process, by up to ~1e-3)."""
    n = laplacian.shape[0]
    try:
        lmax = sparse_linalg.eigs(
            laplacian, k=1, tol=tol,
            ncv=min(n, 10),
            v0=np.full(n, 1.0 / np.sqrt(n)),
            return_eigenvectors=False,
        )
        lmax = float(np.real(lmax[0]))
    except (sparse_linalg.ArpackError, ValueError, TypeError):
        # power iteration when ARPACK cannot run (tiny graphs: k >= n - 1)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(laplacian.shape[0])
        lmax = 0.0
        for _ in range(200):
            x = laplacian @ x
            nrm = np.linalg.norm(x)
            if nrm == 0:
                break
            x /= nrm
            lmax = float(x @ (laplacian @ x))
    lmax *= 1 + 2 * tol
    return lmax


def scale_operator(laplacian: sparse.spmatrix, lmax: float, scale: float = 1.0):
    """Rescale eigenvalues from [0, lmax] to [-scale, scale]."""
    identity = sparse.identity(laplacian.shape[0], format=laplacian.format,
                               dtype=laplacian.dtype)
    laplacian = laplacian * (2 * scale / lmax)
    laplacian = laplacian - identity
    return laplacian


def prepare_laplacian(laplacian: sparse.spmatrix) -> sparse.csr_matrix:
    """float64 spectral rescale, stored as float32 CSR."""
    laplacian = laplacian.astype(np.float64)
    lmax = estimate_lmax(laplacian)
    laplacian = scale_operator(laplacian, lmax)
    return laplacian.tocsr().astype(np.float32)


def triangulate(coords: np.ndarray):
    """Spherical Delaunay triangulation: for unit-sphere points the
    convex hull's facets are the spherical Delaunay triangles."""
    return np.asarray(coords), ConvexHull(coords).simplices


def compute_cotan_laplacian(coords: np.ndarray, return_mass: bool = False):
    """Cotangent Laplacian L of the spherical triangulation and its
    barycentric-lumped mass matrix M (a third of each incident triangle's
    area): M^-1 L, or (L, M) with `return_mass`."""
    v, f = triangulate(coords)
    n = v.shape[0]
    i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]

    def _cot(a, b, c):
        # cotangent of the angle at vertex a, for triangle (a, b, c)
        u = v[b] - v[a]
        w = v[c] - v[a]
        cross = np.linalg.norm(np.cross(u, w), axis=1)
        dot = np.einsum("ij,ij->i", u, w)
        return dot / np.maximum(cross, 1e-30)

    cot0 = _cot(i0, i1, i2)  # angle at v0, opposite edge (1,2)
    cot1 = _cot(i1, i2, i0)  # angle at v1, opposite edge (2,0)
    cot2 = _cot(i2, i0, i1)  # angle at v2, opposite edge (0,1)

    rows = np.concatenate([i1, i2, i2, i0, i0, i1])
    cols = np.concatenate([i2, i1, i0, i2, i1, i0])
    vals = 0.5 * np.concatenate([cot0, cot0, cot1, cot1, cot2, cot2])
    Wc = sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    L = sparse.diags(np.asarray(Wc.sum(axis=1)).ravel()) - Wc
    asym = sparse.csr_matrix(L - L.T)
    assert (np.abs(asym.data).max() if asym.nnz else 0.0) < 1e-8

    tri_area = 0.5 * np.linalg.norm(np.cross(v[i1] - v[i0], v[i2] - v[i0]),
                                    axis=1)
    mass = np.zeros(n)
    for ii in (i0, i1, i2):
        np.add.at(mass, ii, tri_area / 3.0)
    if return_mass:
        return L, sparse.diags(mass)
    Minv = sparse.diags(1.0 / mass)
    return Minv @ L


def laplacian_to_ell(L: sparse.spmatrix, dtype=np.float32):
    """Fixed-width ELL (cols [n, W] int32, vals [n, W]) of a sparse matrix:
    row i's nonzeros in its CSR order, padded to the largest row degree W
    with column 0 and value 0."""
    csr = L.tocsr()
    n = csr.shape[0]
    deg = np.diff(csr.indptr)
    width = int(deg.max())
    cols = np.zeros((n, width), dtype=np.int32)
    vals = np.zeros((n, width), dtype=dtype)
    rows = np.repeat(np.arange(n), deg)
    offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
    cols[rows, offs] = csr.indices
    vals[rows, offs] = csr.data
    return cols, vals


def build_graph(name: str, sampling_kwargs: Dict, k: int = 20,
                graph_type: str = "knn",
                sampling: Optional[Sampling] = None) -> SphereGraph:
    """Build sampling + graph + prepared (rescaled) Laplacian.

    'knn': the normalized knn-graph Laplacian; 'voronoi': the mass-lumped
    cotangent Laplacian M^-1 L; 'mesh': the symmetric M^-1/2 L M^-1/2 of
    the same triangulation. `is_symmetric` is computed from the prepared
    operator."""
    if sampling is None:
        sampling = build_sampling(name, sampling_kwargs)
    coords = sampling.coords_3d
    W = None
    if graph_type == "knn":
        W = knn_adjacency(coords, k=k)
        L0 = normalized_laplacian(W)
    elif graph_type == "voronoi":
        L0 = compute_cotan_laplacian(coords)
    elif graph_type == "mesh":
        Lc, M = compute_cotan_laplacian(coords, return_mass=True)
        m_isqrt = sparse.diags(1.0 / np.sqrt(M.diagonal()))
        L0 = m_isqrt @ Lc @ m_isqrt
    else:
        raise ValueError("graph_type must be 'knn', 'mesh' or 'voronoi'")
    L = prepare_laplacian(L0)
    d = sparse_linalg.norm(L - L.T) if L.nnz else 0.0
    sym = bool(d <= 1e-8 * max(sparse_linalg.norm(L), 1e-30))
    return SphereGraph(sampling=sampling, k=k, W=W, L=L, is_symmetric=sym)
