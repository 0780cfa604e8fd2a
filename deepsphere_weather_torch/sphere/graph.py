"""Spherical knn graphs and Laplacians (numpy/scipy, build time).

The port's own copy of the knn path of `deepsphere_weather_tpu/sphere/graph.py`:
gaussian-kernel knn adjacency, symmetric normalized Laplacian, largest
eigenvalue with a fixed ARPACK start vector, and the rescale to [-1, 1].
The arithmetic is the same line for line, so the prepared Laplacian equals
the JAX package's to fp32 round-off. The cotangent graph types ('voronoi',
'mesh') raise `NotImplementedError` until they are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as sparse_linalg
from scipy.spatial import cKDTree

from .samplings import Sampling, build_sampling

__all__ = ["SphereGraph", "knn_adjacency", "normalized_laplacian",
           "estimate_lmax", "scale_operator", "prepare_laplacian",
           "build_graph"]


@dataclasses.dataclass
class SphereGraph:
    """A spherical sampling + its knn graph and prepared Laplacian."""

    sampling: Sampling
    k: int
    W: sparse.csr_matrix
    L: sparse.csr_matrix          # normalized Laplacian, eigenvalues rescaled to [-1, 1]
    is_symmetric: bool = True

    @property
    def n_nodes(self) -> int:
        return self.sampling.n_nodes

    def laplacian_dense(self, dtype=np.float32) -> np.ndarray:
        return np.asarray(self.L.todense(), dtype=dtype)


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


def build_graph(name: str, sampling_kwargs: Dict, k: int = 20,
                graph_type: str = "knn",
                sampling: Optional[Sampling] = None) -> SphereGraph:
    """Build sampling + knn graph + prepared (rescaled) Laplacian."""
    if graph_type != "knn":
        raise NotImplementedError(
            f"graph_type {graph_type!r} is not ported yet (knn only)")
    if sampling is None:
        sampling = build_sampling(name, sampling_kwargs)
    W = knn_adjacency(sampling.coords_3d, k=k)
    L = prepare_laplacian(normalized_laplacian(W))
    return SphereGraph(sampling=sampling, k=k, W=W, L=L, is_symmetric=True)
