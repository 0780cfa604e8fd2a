"""Pooling / unpooling between spherical samplings.

Port of `deepsphere_weather_tpu/ops/pool.py`, every method of its factory:

- hierarchical HEALPix max/avg pool on nested ordering: reshape + reduce;
  the max pool returns its argmax for the unpool;
- hierarchical equiangular max/avg pool on the 2D grid, odd dimensions
  floor-cropped by the pool and zero-padded (max) or nearest-resized
  (avg) back by the unpool;
- general matrix pooling for any sampling pair from the conservative
  remap weights (`sphere/remap.py`): 'interp' (weighted average),
  'maxarea' (one-hot of the largest-overlap cell), 'maxval' (runtime
  argmax of the weighted values; its unpool scatters back to the argmax
  sources), 'learn' (trainable logits over the remap's support).

Sparse matrices are carried in fixed-width ELL form (`sparse_to_ell`):
applied as a gather along the node axis and a contraction over the ELL
width, in the activation dtype (weights cast to it, fp32 accumulation).
All ops take and return [batch, node, channel]; pools return
(pooled, idx), idx None unless the unpool needs it. Index arithmetic
uses comparisons and gathers only, so every op runs under
`torch.func.vmap` and `torch.export`.

On a node mesh (`models.shard_geometry`) a pool whose windows cross the
node ranges runs as `ShardedPool` / `ShardedUnpool`: its input gathered
over the node group (`parallel.NodeShard.gather`, a reduce-scatter
backward), the op on the whole level, the rank's output rows kept. The
argmax idx stays whole on every rank, for the unpool.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import sparse as _sparse

from .._device import resolve_device
from ..parallel.collectives import NodeShard

__all__ = [
    "sparse_to_ell",
    "EllMatrix",
    "GeneralAvgPool", "GeneralAvgUnpool",
    "GeneralMaxAreaPool", "GeneralMaxAreaUnpool",
    "GeneralMaxValPool", "GeneralMaxValUnpool",
    "GeneralLearnPool", "GeneralLearnUnpool",
    "HealpixAvgPool", "HealpixAvgUnpool", "HealpixMaxPool", "HealpixMaxUnpool",
    "EquiangularAvgPool", "EquiangularAvgUnpool",
    "EquiangularMaxPool", "EquiangularMaxUnpool",
    "ShardedPool", "ShardedUnpool", "build_pool_unpool",
]


def sparse_to_ell(mat: "_sparse.spmatrix", dtype=np.float32):
    """Fixed-width ELL (cols, vals) from a scipy sparse matrix; padding
    entries point at column 0 with value 0."""
    csr = mat.tocsr()
    n = csr.shape[0]
    deg = np.diff(csr.indptr)
    width = max(int(deg.max()), 1)
    cols = np.zeros((n, width), dtype=np.int32)
    vals = np.zeros((n, width), dtype=dtype)
    rows = np.repeat(np.arange(n), deg)
    offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
    cols[rows, offs] = csr.indices
    vals[rows, offs] = csr.data
    return cols, vals


def _gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x [B, n_in, C] gathered at cols [D, W] along the node axis:
    [B, D, W, C]."""
    B, _, C = x.shape
    D, W = cols.shape
    return x.index_select(1, cols.reshape(-1)).reshape(B, D, W, C)


def _contract(gathered: torch.Tensor, weights: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """sum_w weights[d, w] * gathered[b, d, w, c], the weights cast to the
    activation dtype, summed in fp32, the result in that dtype."""
    return torch.einsum("bdwc,dw->bdc", gathered.float(),
                        weights.to(dtype).float()).to(dtype)


class EllMatrix:
    """A [n_out, n_in] sparse matrix in ELL form; applies along the node axis."""

    def __init__(self, cols, vals, n_in: int, device="cuda"):
        device = resolve_device(device)
        self.cols = torch.as_tensor(np.asarray(cols), dtype=torch.int64,
                                    device=device)
        self.vals = torch.as_tensor(np.asarray(vals, np.float32),
                                    device=device)
        self.n_in = int(n_in)

    @classmethod
    def from_scipy(cls, mat, device="cuda"):
        cols, vals = sparse_to_ell(mat)
        return cls(cols, vals, mat.shape[1], device=device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, n_in, C] -> [B, n_out, C] in x's dtype."""
        return _contract(_gather(x, self.cols), self.vals, x.dtype)


# ---------------------------------------------------------------------------
# General (matrix) pooling: any sampling pair
# ---------------------------------------------------------------------------

def _ell(mat, device) -> EllMatrix:
    return mat if isinstance(mat, EllMatrix) else EllMatrix.from_scipy(
        mat, device=device)


class GeneralAvgPool:
    """Weighted-average pooling with a row-normalized remap matrix
    ('interp'): a scipy sparse matrix or a pre-built EllMatrix."""

    def __init__(self, pool_matrix, device="cuda"):
        self.mat = _ell(pool_matrix, device)

    def __call__(self, x) -> Tuple[torch.Tensor, None]:
        return self.mat.apply(x), None


class GeneralAvgUnpool:
    def __init__(self, unpool_matrix, device="cuda"):
        self.mat = _ell(unpool_matrix, device)

    def __call__(self, x, idx=None) -> torch.Tensor:
        return self.mat.apply(x)


def _onehot_argmax_rows(mat: "_sparse.spmatrix") -> "_sparse.csr_matrix":
    """One-hot matrix selecting each row's max-weight column ('maxarea');
    the first column of a tie, as np.argmax over the ELL layout picks it
    (padding slots hold zero values and never win over positive
    weights)."""
    ell_cols, ell_vals = sparse_to_ell(mat)
    n_out, n_in = mat.shape
    j = ell_vals.argmax(axis=1)
    nonempty = ell_vals.max(axis=1) > 0
    rows = np.nonzero(nonempty)[0]
    cols = ell_cols[rows, j[rows]]
    return _sparse.csr_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)),
        shape=(n_out, n_in))


class GeneralMaxAreaPool:
    def __init__(self, pool_matrix, device="cuda"):
        self.mat = EllMatrix.from_scipy(_onehot_argmax_rows(pool_matrix),
                                        device=device)

    def __call__(self, x) -> Tuple[torch.Tensor, None]:
        return self.mat.apply(x), None


class GeneralMaxAreaUnpool:
    def __init__(self, unpool_matrix, device="cuda"):
        self.mat = EllMatrix.from_scipy(_onehot_argmax_rows(unpool_matrix),
                                        device=device)

    def __call__(self, x, idx=None) -> torch.Tensor:
        return self.mat.apply(x)


def _argmax_pool(pool, x):
    """An argmax pool's call over its `candidates`: the max of each
    output's candidates and the idx of its slot. torch.argmax returns the
    FIRST maximal slot, as jnp.argmax does: ties (common in bf16) unpool
    to the same node on both stacks; the gradient of the max splits
    evenly over a tie, as JAX's does."""
    g, to_idx = pool.candidates(x)
    return g.amax(dim=2), to_idx(g.argmax(dim=2))


class GeneralMaxValPool:
    """Runtime argmax of the weighted values over each destination's
    support; returns the chosen source node per (batch, destination,
    channel) for the unpool (ties: `_argmax_pool`)."""

    def __init__(self, pool_matrix, device="cuda"):
        mat = _ell(pool_matrix, device)
        self.cols, self.vals, self.n_in = mat.cols, mat.vals, mat.n_in

    def candidates(self, x):
        """(g, to_idx): g [B, D, W, C] the weighted values over each
        destination's support (-inf on padding), whose max is the pooled
        value; to_idx maps a chosen slot j [B, D, C] to its source node."""
        g = _gather(x, self.cols)                                # [B, D, W, C]
        weighted = g * self.vals[None, :, :, None].to(x.dtype)
        mask = (self.vals > 0)[None, :, :, None]
        weighted = torch.where(mask, weighted,
                               torch.full_like(weighted, float("-inf")))
        src = self.cols[None, :, :, None].expand(g.shape)
        return weighted, lambda j: src.gather(2, j[:, :, None]).squeeze(2)

    __call__ = _argmax_pool


class GeneralMaxValUnpool:
    """Scatter the pooled values back to their argmax source nodes
    (`scatter_add` along the node axis: two destinations that chose the
    same source add up there)."""

    def __init__(self, n_src: int):
        self.n_src = int(n_src)

    def __call__(self, x, idx) -> torch.Tensor:
        B, _, C = x.shape
        out = x.new_zeros((B, self.n_src, C))
        return out.scatter_add(1, idx, x)


def _ell_logits(mat):
    cols, vals = sparse_to_ell(mat)
    mask = vals > 0
    logits = np.where(mask, np.log(np.maximum(vals, 1e-20)), -1e9)
    return cols, mask, logits.astype(np.float32)


class _LearnedEll:
    """Trainable logits over a remap matrix's ELL support, softmax-
    normalized per row, so pooling stays a convex combination of source
    nodes. The logits start at log(weights): softmax(log w) = w for
    row-normalized w, so training starts at 'interp'. The model holds the
    logits as parameters (`pool{lvl}`, `unpool{lvl}`) and passes them as
    `w`; without `w` the initial logits apply."""

    def __init__(self, matrix, device="cuda"):
        device = resolve_device(device)
        cols, mask, logits = _ell_logits(matrix)
        self.cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.init_logits = torch.as_tensor(logits, device=device)

    def init(self) -> torch.Tensor:
        return self.init_logits.clone()

    def _apply(self, x, w):
        logits = self.init_logits if w is None else w
        logits = logits.masked_fill(~self.mask, -1e9)
        p = torch.softmax(logits, dim=1).to(x.dtype)             # [D, W]
        return _contract(_gather(x, self.cols), p, x.dtype)


class GeneralLearnPool(_LearnedEll):
    """Learned sparse pooling on the conservative-remap sparsity."""

    def __call__(self, x, w=None) -> Tuple[torch.Tensor, None]:
        return self._apply(x, w), None


class GeneralLearnUnpool(_LearnedEll):
    """Learned sparse unpooling over the unpool matrix's sparsity."""

    def __call__(self, x, idx=None, w=None) -> torch.Tensor:
        return self._apply(x, w)


# ---------------------------------------------------------------------------
# Hierarchical HEALPix pooling (nested ordering -> reshape)
# ---------------------------------------------------------------------------

class HealpixAvgPool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x):
        B, V, C = x.shape
        # mean accumulated in fp32, as jnp.mean does for bf16
        g = x.reshape(B, V // self.k, self.k, C).float()
        return g.mean(dim=2).to(x.dtype), None


class HealpixAvgUnpool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x, idx=None):
        return torch.repeat_interleave(x, self.k, dim=1)


class HealpixMaxPool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def candidates(self, x):
        """(g [B, V/k, k, C], to_idx): the children of each parent; the
        idx is the child's slot."""
        B, V, C = x.shape
        return x.reshape(B, V // self.k, self.k, C), lambda j: j

    __call__ = _argmax_pool


def _onehot(idx: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """idx [B, D, C] -> one-hot [B, D, k, C] by comparison (F.one_hot
    checks its values on the host, which torch.func.vmap refuses)."""
    children = torch.arange(k, device=idx.device)
    return (idx[:, :, None, :] == children[:, None]).to(dtype)


class HealpixMaxUnpool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x, idx):
        B, D, C = x.shape
        return (_onehot(idx, self.k, x.dtype)
                * x[:, :, None, :]).reshape(B, D * self.k, C)


# ---------------------------------------------------------------------------
# Hierarchical equiangular pooling (2D grid)
# ---------------------------------------------------------------------------

def _windows(x, nlat, nlon, c):
    """x [B, nlat*nlon, C] as [B, Hc, c, Wc, c, C], the trailing odd row
    and column cropped (the floor rule of AvgPool2d / MaxPool2d)."""
    B, _, C = x.shape
    g = x.reshape(B, nlat, nlon, C)
    Hc, Wc = nlat // c, nlon // c
    return g[:, :Hc * c, :Wc * c].reshape(B, Hc, c, Wc, c, C)


class EquiangularAvgPool:
    def __init__(self, nlat: int, nlon: int, kernel_size: int = 4):
        self.nlat, self.nlon = nlat, nlon
        self.c = int(np.sqrt(kernel_size))

    def __call__(self, x):
        g = _windows(x, self.nlat, self.nlon, self.c)
        pooled = g.float().mean(dim=(2, 4)).to(x.dtype)
        return pooled.reshape(x.shape[0], -1, x.shape[-1]), None


class EquiangularAvgUnpool:
    """Nearest-neighbour resize from the coarse grid (nlat, nlon) to the
    fine one (fine_nlat, fine_nlon): repeat-by-c for even dimensions."""

    def __init__(self, nlat: int, nlon: int, kernel_size: int = 4,
                 fine_nlat: Optional[int] = None,
                 fine_nlon: Optional[int] = None, device="cuda"):
        self.nlat, self.nlon = nlat, nlon  # coarse dims
        self.c = int(np.sqrt(kernel_size))
        self.fine_nlat = fine_nlat if fine_nlat is not None else nlat * self.c
        self.fine_nlon = fine_nlon if fine_nlon is not None else nlon * self.c
        device = resolve_device(device)
        rows = np.floor(np.arange(self.fine_nlat) * self.nlat
                        / self.fine_nlat).astype(np.int64)
        cols = np.floor(np.arange(self.fine_nlon) * self.nlon
                        / self.fine_nlon).astype(np.int64)
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)

    def __call__(self, x, idx=None):
        B, _, C = x.shape
        g = x.reshape(B, self.nlat, self.nlon, C)
        g = g.index_select(1, self.rows).index_select(2, self.cols)
        return g.reshape(B, -1, C)


class EquiangularMaxPool:
    def __init__(self, nlat: int, nlon: int, kernel_size: int = 4):
        self.nlat, self.nlon = nlat, nlon
        self.c = int(np.sqrt(kernel_size))

    def candidates(self, x):
        """(g [B, Hc*Wc, c*c, C], to_idx): each window's cells, row-major
        within the window; the idx is the cell's slot."""
        g = _windows(x, self.nlat, self.nlon, self.c)
        B, Hc, c, Wc, _, C = g.shape
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(B, Hc * Wc, c * c, C)
        return g, lambda j: j

    __call__ = _argmax_pool


class EquiangularMaxUnpool:
    """Each pooled value back to its argmax cell of the window; the rest
    zero, as is the cropped trailing odd row or column (MaxUnpool2d)."""

    def __init__(self, nlat: int, nlon: int, kernel_size: int = 4,
                 fine_nlat: Optional[int] = None,
                 fine_nlon: Optional[int] = None):
        self.nlat, self.nlon = nlat, nlon  # coarse dims
        self.c = int(np.sqrt(kernel_size))
        self.fine_nlat = fine_nlat if fine_nlat is not None else nlat * self.c
        self.fine_nlon = fine_nlon if fine_nlon is not None else nlon * self.c

    def __call__(self, x, idx):
        B, D, C = x.shape
        c = self.c
        g = _onehot(idx, c * c, x.dtype) * x[:, :, None, :]      # [B, D, c*c, C]
        g = g.reshape(B, self.nlat, self.nlon, c, c, C)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(
            B, self.nlat * c, self.nlon * c, C)
        pad_h = self.fine_nlat - self.nlat * c
        pad_w = self.fine_nlon - self.nlon * c
        if pad_h or pad_w:
            g = F.pad(g, (0, 0, 0, pad_w, 0, pad_h))
        return g.reshape(B, -1, C)


# ---------------------------------------------------------------------------
# Node shards of pools whose windows cross the node ranges
# ---------------------------------------------------------------------------

class ShardedPool:
    """One node rank's part of `pool`: its input `src` gathered, pooled
    whole, the rows of `dst` kept (the argmax idx whole)."""

    def __init__(self, pool, src: NodeShard, dst: NodeShard):
        self.pool, self.src, self.dst = pool, src, dst

    def __call__(self, x, w=None):
        x = self.src.gather(x)
        y, idx = self.pool(x) if w is None else self.pool(x, w=w)
        return self.dst.local(y), idx


class ShardedUnpool:
    """One node rank's part of `unpool`: its input `src` gathered,
    unpooled whole (with the whole idx), the rows of `dst` kept."""

    def __init__(self, unpool, src: NodeShard, dst: NodeShard):
        self.unpool, self.src, self.dst = unpool, src, dst

    def __call__(self, x, idx=None, w=None):
        x = self.src.gather(x)
        y = self.unpool(x, idx) if w is None else self.unpool(x, idx, w=w)
        return self.dst.local(y)


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def build_pool_unpool(pool_method: str, src_sampling, dst_sampling,
                      kernel_size: int = 4, cache: bool = True,
                      device="cuda"):
    """(pool, unpool) for a sampling pair.

    'max'/'avg' pool hierarchically (healpix and equiangular only);
    'interp'/'maxarea'/'maxval'/'learn' use the conservative remap
    matrices, cached on disk under the JAX package's key
    `poolmat_<src>__<dst>` (the ELL arrays both stacks consume)."""
    method = pool_method.lower()
    name = src_sampling.name

    if method in ("max", "avg"):
        if name == "healpix":
            ratio = src_sampling.n_nodes // dst_sampling.n_nodes
            if method == "max":
                return HealpixMaxPool(ratio), HealpixMaxUnpool(ratio)
            return HealpixAvgPool(ratio), HealpixAvgUnpool(ratio)
        if name == "equiangular":
            kw_src = src_sampling.kwargs_dict
            kw_dst = dst_sampling.kwargs_dict
            fine = dict(fine_nlat=kw_src["nlat"], fine_nlon=kw_src["nlon"])
            if method == "max":
                return (EquiangularMaxPool(kw_src["nlat"], kw_src["nlon"],
                                           kernel_size),
                        EquiangularMaxUnpool(kw_dst["nlat"], kw_dst["nlon"],
                                             kernel_size, **fine))
            return (EquiangularAvgPool(kw_src["nlat"], kw_src["nlon"],
                                       kernel_size),
                    EquiangularAvgUnpool(kw_dst["nlat"], kw_dst["nlon"],
                                         kernel_size, device=device, **fine))
        raise ValueError(
            f"hierarchical pooling '{method}' requires healpix/equiangular, "
            f"got {name}")

    if method in ("interp", "maxarea", "maxval", "learn"):
        from ..sphere.cache import cached_arrays
        from ..sphere.remap import build_pooling_matrices

        def _build():
            pool_mat, unpool_mat = build_pooling_matrices(src_sampling,
                                                          dst_sampling)
            pc, pv = sparse_to_ell(pool_mat)
            uc, uv = sparse_to_ell(unpool_mat)
            return {"pool_cols": pc, "pool_vals": pv,
                    "unpool_cols": uc, "unpool_vals": uv}

        key = f"poolmat_{src_sampling.cache_key()}__{dst_sampling.cache_key()}"
        arrs = cached_arrays(key, _build) if cache else _build()
        if method == "interp":
            return (GeneralAvgPool(EllMatrix(
                        arrs["pool_cols"], arrs["pool_vals"],
                        src_sampling.n_nodes, device=device)),
                    GeneralAvgUnpool(EllMatrix(
                        arrs["unpool_cols"], arrs["unpool_vals"],
                        dst_sampling.n_nodes, device=device)))
        if method == "maxval":
            return (GeneralMaxValPool(EllMatrix(
                        arrs["pool_cols"], arrs["pool_vals"],
                        src_sampling.n_nodes, device=device)),
                    GeneralMaxValUnpool(src_sampling.n_nodes))
        pool_csr = _ell_to_csr(arrs["pool_cols"], arrs["pool_vals"],
                               src_sampling.n_nodes)
        unpool_csr = _ell_to_csr(arrs["unpool_cols"], arrs["unpool_vals"],
                                 dst_sampling.n_nodes)
        if method == "maxarea":
            return (GeneralMaxAreaPool(pool_csr, device=device),
                    GeneralMaxAreaUnpool(unpool_csr, device=device))
        return (GeneralLearnPool(pool_csr, device=device),
                GeneralLearnUnpool(unpool_csr, device=device))

    raise ValueError(f"unknown pool_method {pool_method!r}")


def _ell_to_csr(cols: np.ndarray, vals: np.ndarray, n_in: int):
    n_out, w = cols.shape
    rows = np.repeat(np.arange(n_out), w)
    mat = _sparse.csr_matrix(
        (vals.ravel(), (rows, cols.ravel())), shape=(n_out, n_in))
    mat.eliminate_zeros()
    return mat
