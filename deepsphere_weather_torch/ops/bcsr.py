"""Block-sparse (BCSR) Laplacian operator with the SpMM kernels.

Port of `deepsphere_weather_tpu/ops/pallas_spmm.py`:

- `bcsr_from_scipy`: padded BCSR with dense 128x128 blocks (numpy).
- `bcsr_super_from_scipy`: the super-row layout: R consecutive row blocks
  share the union of their block-columns, and each row's blocks are laid
  side by side over the union slots, so a super-row is one
  `[R*128, max_u*128] @ [max_u*128, M]` product. The TPU's DMA slot
  schedule and VMEM tiling have no counterpart on the GPU, so the union
  slots are simply in sorted column order.
- `bcsr_super_spmm`: the super-row product. On a CUDA tensor it launches
  the CUDA kernel `kernels/bcsr_super_spmm.cu` (or raises); on a CPU
  tensor it runs the plain PyTorch version `bcsr_super_spmm_reference`.
- `bcsr_spmm`: the plain-BCSR product, the same way: the CUDA kernel
  `kernels/bcsr_spmm.cu` or `bcsr_spmm_reference`.
- `BlockSparseOperator`: the operator a Chebyshev convolution calls,
  with the JAX operator's padding and dtype rules in `matvec` and its
  custom VJP as a `torch.autograd.Function` (the backward computes
  A^T @ g with the same kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .._device import resolve_device

__all__ = ["bcsr_from_scipy", "bcsr_super_from_scipy",
           "bcsr_super_spmm", "bcsr_super_spmm_reference",
           "bcsr_spmm", "bcsr_spmm_reference",
           "BlockSparseOperator", "launch_counts", "reset_launch_counts"]

_BS = 128

# Launches of each CUDA kernel of this module since the last reset: a run
# reads them to show that its path went through the kernels.
launch_counts: Dict[str, int] = {"bcsr_super_spmm": 0, "bcsr_spmm": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def bcsr_from_scipy(mat, block_size: int = _BS):
    """scipy sparse [N, N] -> padded BCSR (fp32 numpy).

    Returns (vals [n_rb, max_nb, bs, bs], cols [n_rb, max_nb] int32, n_pad),
    n_pad the matrix size padded to a multiple of bs. Padding slots repeat
    block-column 0 with zero values."""
    n = mat.shape[0]
    bs = block_size
    n_pad = ((n + bs - 1) // bs) * bs
    coo = mat.tocoo()
    rb = coo.row // bs
    cb = coo.col // bs
    n_rb = n_pad // bs
    block_ids = rb.astype(np.int64) * n_rb + cb
    uniq, inv = np.unique(block_ids, return_inverse=True)
    u_rb = (uniq // n_rb).astype(np.int64)
    u_cb = (uniq % n_rb).astype(np.int32)
    counts = np.bincount(u_rb, minlength=n_rb)
    max_nb = max(int(counts.max()), 1)
    # uniq is sorted by (row block, col block): a block's slot is its rank
    # within its row block
    first = np.searchsorted(u_rb, np.arange(n_rb))
    slot_of_uniq = (np.arange(len(uniq)) - first[u_rb]).astype(np.int64)
    vals = np.zeros((n_rb, max_nb, bs, bs), dtype=np.float32)
    cols = np.zeros((n_rb, max_nb), dtype=np.int32)
    cols[u_rb, slot_of_uniq] = u_cb
    np.add.at(vals, (rb, slot_of_uniq[inv], coo.row % bs, coo.col % bs),
              coo.data)
    return vals, cols, n_pad


def bcsr_super_from_scipy(mat, block_size: int = _BS, rows_per_super: int = 2):
    """scipy sparse [N, N] -> super-row BCSR (fp32 numpy).

    Returns (svals [n_s, R, bs, max_u*bs], ucols [n_s, max_u] int32, n_pad):
    svals[s, r, :, u*bs:(u+1)*bs] is row block s*R+r's block for union slot
    u (zero where that row does not touch the slot's column), ucols[s, u]
    the slot's block-column. Union slots are the sorted union of the
    super-row's block-columns; padding slots (u >= union size) repeat its
    last column with zero values. Padding row blocks (n_s*R > n_rb) are
    zero."""
    vals, cols, n_pad = bcsr_from_scipy(mat, block_size=block_size)
    n_rb, max_nb = cols.shape
    bs = block_size
    R = int(rows_per_super)
    n_s = (n_rb + R - 1) // R
    n_rb_pad = n_s * R
    if n_rb_pad != n_rb:
        vals = np.concatenate(
            [vals, np.zeros((n_rb_pad - n_rb,) + vals.shape[1:], vals.dtype)])
        cols = np.concatenate(
            [cols, np.zeros((n_rb_pad - n_rb, max_nb), cols.dtype)])
    real = (vals != 0).reshape(n_rb_pad, max_nb, -1).any(axis=-1)
    ucols_list = [np.unique(cols[s * R:(s + 1) * R][real[s * R:(s + 1) * R]])
                  if real[s * R:(s + 1) * R].any() else
                  np.zeros(1, dtype=cols.dtype)
                  for s in range(n_s)]
    max_u = max(u.size for u in ucols_list)
    svals = np.zeros((n_s, R, bs, max_u, bs), dtype=np.float32)
    ucols = np.zeros((n_s, max_u), dtype=np.int32)
    for s, u in enumerate(ucols_list):
        ucols[s] = u[-1]
        ucols[s, :u.size] = u
    # union slot of each real block = rank of its column in the super-row's
    # sorted union, found by one global searchsorted over
    # (super_row * n_cb + col) keys, which increase across super-rows
    g_idx, b_idx = np.nonzero(real)
    s_idx, r_idx = g_idx // R, g_idx % R
    c_idx = cols[g_idx, b_idx].astype(np.int64)
    n_cb = n_pad // bs
    lens = np.array([u.size for u in ucols_list], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    keys = (np.concatenate(ucols_list).astype(np.int64)
            + np.repeat(np.arange(n_s, dtype=np.int64), lens) * n_cb)
    slot = np.searchsorted(keys, s_idx * n_cb + c_idx) - starts[s_idx]
    svals[s_idx, r_idx, :, slot, :] = vals[g_idx, b_idx]
    return svals.reshape(n_s, R, bs, max_u * bs), ucols, n_pad


def _x_regime(x: torch.Tensor) -> torch.dtype:
    """The product's dtype regime, set by x: A is cast to it (fp32 x widens
    bf16 A exactly; bf16 x rounds fp32 A to bf16) and the output is stored
    in it; accumulation is fp32 either way."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _check_dtypes(a, idx, x):
    if a.dtype not in (torch.float32, torch.bfloat16) or \
            x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("the A blocks and x must be float32 or bfloat16")
    if idx.dtype != torch.int32:
        raise TypeError("the block-column table must be int32")
    if not (a.device == idx.device == x.device):
        raise ValueError("the A blocks, their columns and x must be on one "
                         "device")


def _check_args(svals, ucols, x):
    if svals.dim() != 4 or ucols.dim() != 2 or x.dim() != 2:
        raise ValueError("expected svals [n_s, R, bs, max_u*bs], "
                         "ucols [n_s, max_u], x [rows, M]")
    n_s, R, bs, ubs = svals.shape
    if bs != _BS or ubs % bs or ucols.shape != (n_s, ubs // bs):
        raise ValueError(f"inconsistent super-row layout: svals "
                         f"{tuple(svals.shape)}, ucols {tuple(ucols.shape)}")
    if x.shape[0] != n_s * R * bs:
        raise ValueError(f"x must have n_s*R*bs = {n_s * R * bs} rows, "
                         f"got {x.shape[0]}")
    _check_dtypes(svals, ucols, x)


def _check_plain_args(vals, cols, x):
    if vals.dim() != 4 or cols.dim() != 2 or x.dim() != 2:
        raise ValueError("expected vals [n_rb, max_nb, bs, bs], "
                         "cols [n_rb, max_nb], x [rows, M]")
    n_rb, max_nb, bs, bs2 = vals.shape
    if bs != _BS or bs2 != bs or cols.shape != (n_rb, max_nb):
        raise ValueError(f"inconsistent BCSR layout: vals "
                         f"{tuple(vals.shape)}, cols {tuple(cols.shape)}")
    if x.shape[0] != n_rb * bs:
        raise ValueError(f"x must have n_rb*bs = {n_rb * bs} rows, "
                         f"got {x.shape[0]}")
    _check_dtypes(vals, cols, x)


def _check_launch(k, name, tensors, M):
    if M % getattr(k.lib, f"{name}_col_tile")():
        raise ValueError(f"x width {M} is not a multiple of the kernel's "
                         "column tile; matvec pads it")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the A blocks, their columns and x must be "
                         "contiguous")


def _raise_on(k, name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            k.lib, f"{name}_error_string")(err).decode())


def bcsr_super_spmm_reference(svals: torch.Tensor, ucols: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, fp32 einsum, cast.

    out[s*R*bs + r*bs + i, m] = sum_k svals[s, r, i, k] * xg[s, k, m] with
    xg[s] the x blocks of ucols[s] stacked. Output [n_s*R*bs, M], bf16 for
    bf16 x and fp32 otherwise."""
    _check_args(svals, ucols, x)
    n_s, R, bs, ubs = svals.shape
    M = x.shape[1]
    a = svals.to(_x_regime(x)).float()
    xb = x.float().reshape(-1, bs, M)
    xg = xb[ucols.long()].reshape(n_s, ubs, M)
    out = torch.einsum("srik,skm->srim", a, xg)
    return out.reshape(n_s * R * bs, M).to(_x_regime(x))


def _bind(name, argtypes):
    from ..kernels.build import load_kernel

    k = load_kernel(name)
    fn = getattr(k.lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    getattr(k.lib, f"{name}_col_tile").restype = ctypes.c_int
    err = getattr(k.lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return k


@functools.lru_cache(maxsize=None)
def _kernel():
    return _bind("bcsr_super_spmm", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _plain_kernel():
    return _bind("bcsr_spmm", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


def bcsr_super_spmm(svals: torch.Tensor, ucols: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in super-row BCSR; x [n_s*R*128, M], M % 128 == 0.

    CUDA tensors run the hand-written kernel (a failed build or launch
    raises); CPU tensors run `bcsr_super_spmm_reference`."""
    _check_args(svals, ucols, x)
    if not x.is_cuda:
        return bcsr_super_spmm_reference(svals, ucols, x)
    k = _kernel()
    M = x.shape[1]
    _check_launch(k, "bcsr_super_spmm", (svals, ucols, x), M)
    n_s, R, bs, ubs = svals.shape
    out = torch.empty((n_s * R * bs, M), dtype=_x_regime(x), device=x.device)
    # the C entry point launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = k.lib.bcsr_super_spmm(
            svals.data_ptr(), int(svals.dtype == torch.bfloat16),
            ucols.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            out.data_ptr(), n_s, R, ubs // bs, M, stream)
    _raise_on(k, "bcsr_super_spmm", err)
    launch_counts["bcsr_super_spmm"] += 1
    return out


def bcsr_spmm_reference(vals: torch.Tensor, cols: torch.Tensor,
                        x: torch.Tensor, round_a: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the plain-BCSR kernel: gather, fp32 einsum,
    cast.

    out[r*bs + i, m] = sum_b sum_j vals[r, b, i, j] * x[cols[r, b]*bs + j, m].
    Output [n_rb*bs, M], bf16 for bf16 x and fp32 otherwise. `round_a`
    matters only for fp32 A against bf16 x: True rounds A to bf16 (the
    compiled TPU kernel's regime), False keeps it fp32 (the interpreter
    kernel's, which widens both operands)."""
    _check_plain_args(vals, cols, x)
    n_rb, max_nb, bs, _ = vals.shape
    M = x.shape[1]
    a = (vals.to(_x_regime(x)) if round_a else vals).float()
    xg = x.float().reshape(-1, bs, M)[cols.long()]   # [n_rb, max_nb, bs, M]
    out = torch.einsum("rbij,rbjm->rim", a, xg)
    return out.reshape(n_rb * bs, M).to(_x_regime(x))


def bcsr_spmm(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
              round_a: bool = True) -> torch.Tensor:
    """y = A @ x for A in plain padded BCSR; x [n_rb*128, M], M % 64 == 0.

    CUDA tensors run the hand-written kernel (a failed build or launch
    raises); CPU tensors run `bcsr_spmm_reference`. `round_a` as there."""
    _check_plain_args(vals, cols, x)
    if not x.is_cuda:
        return bcsr_spmm_reference(vals, cols, x, round_a)
    k = _plain_kernel()
    M = x.shape[1]
    _check_launch(k, "bcsr_spmm", (vals, cols, x), M)
    n_rb, max_nb, bs, _ = vals.shape
    out = torch.empty((n_rb * bs, M), dtype=_x_regime(x), device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = k.lib.bcsr_spmm(
            vals.data_ptr(), int(vals.dtype == torch.bfloat16),
            cols.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            int(bool(round_a)), out.data_ptr(), n_rb, max_nb, M, stream)
    _raise_on(k, "bcsr_spmm", err)
    launch_counts["bcsr_spmm"] += 1
    return out


def _fit_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad or truncate axis 0 to exactly `rows` (a super layout and a
    plain one differ in their padding rows only, which no block reads)."""
    if x.shape[0] == rows:
        return x
    if x.shape[0] > rows:
        return x[:rows].contiguous()
    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


# A layout: ("super", svals, ucols) or ("plain", vals, cols)
_Layout = Tuple[str, torch.Tensor, torch.Tensor]


def _layout_rows(layout: _Layout) -> int:
    kind, a, _ = layout
    return (a.shape[0] * a.shape[1] * a.shape[2] if kind == "super"
            else a.shape[0] * a.shape[2])


def _run_mv(layout: _Layout, x_pad: torch.Tensor, n_out: int) -> torch.Tensor:
    """One product on `layout`, x fitted to its rows, output to n_out."""
    kind, a, idx = layout
    x_fit = _fit_rows(x_pad, _layout_rows(layout))
    y = (bcsr_super_spmm(a, idx, x_fit) if kind == "super"
         else bcsr_spmm(a, idx, x_fit))
    return _fit_rows(y, n_out)


class _MatVec(torch.autograd.Function):
    """y = A @ x_pad, with the JAX operator's custom VJP: the backward
    computes A^T @ g in the primal's dtype on the transposed layout. The
    operator arrays get no gradient."""

    @staticmethod
    def forward(ctx, x_pad, op):
        ctx.op = op
        ctx.x_dtype = x_pad.dtype
        return _run_mv(op.forward_layout(), x_pad, x_pad.shape[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.to(ctx.x_dtype).contiguous()
        gx = _run_mv(ctx.op.transpose_layout(), g, g.shape[0])
        return gx.to(ctx.x_dtype), None


class BlockSparseOperator:
    """Block-sparse Laplacian; `matvec(x)`: [V, M] -> [V, M], with a
    gradient in x.

    The forward product runs on the super-row layout (`svals`, `ucols`)
    when there is one, else on the plain BCSR (`vals`, `cols`). A
    symmetric operator reuses those arrays for the backward; a
    non-symmetric one carries the transposed layout, super-row
    (`svals_t`, `ucols_t`) if built, else plain (`vals_t`, `cols_t`)."""

    def __init__(self, n: int, svals=None, ucols=None, vals=None, cols=None,
                 svals_t=None, ucols_t=None, vals_t=None, cols_t=None):
        if svals is None and vals is None:
            raise ValueError("a forward layout (svals/ucols or vals/cols) "
                             "is required")
        self.n = int(n)
        self.svals, self.ucols = svals, ucols
        self.vals, self.cols = vals, cols
        self.svals_t, self.ucols_t = svals_t, ucols_t
        self.vals_t, self.cols_t = vals_t, cols_t

    @classmethod
    def from_scipy(cls, mat, symmetric: bool = True, dtype=torch.float32,
                   rows_per_super: int = 2, device="cuda"):
        """`dtype` is the stored precision of the A blocks (bf16 halves
        their bytes; bf16 activations round A to bf16 anyway).
        `rows_per_super` > 1 builds the super-row layout (the K1 kernel);
        0, None or 1 the plain padded BCSR (the K3 kernel). A
        non-symmetric `mat` also gets the same layout of its transpose."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("dtype must be torch.float32 or torch.bfloat16")
        device = resolve_device(device)

        def dev(a):
            a = torch.from_numpy(a).to(device)
            return a if a.dtype == torch.int32 else a.to(dtype)

        def layout(m):
            if rows_per_super and rows_per_super > 1:
                sv, uc, _ = bcsr_super_from_scipy(
                    m, rows_per_super=rows_per_super)
            else:
                sv, uc, _ = bcsr_from_scipy(m)
            return dev(sv), dev(uc)

        a, idx = layout(mat)
        a_t, idx_t = (None, None) if symmetric else layout(mat.T.tocsr())
        if rows_per_super and rows_per_super > 1:
            return cls(mat.shape[0], svals=a, ucols=idx, svals_t=a_t,
                       ucols_t=idx_t)
        return cls(mat.shape[0], vals=a, cols=idx, vals_t=a_t, cols_t=idx_t)

    @property
    def symmetric(self) -> bool:
        return self.svals_t is None and self.vals_t is None

    def forward_layout(self) -> _Layout:
        if self.svals is not None:
            return ("super", self.svals, self.ucols)
        return ("plain", self.vals, self.cols)

    def transpose_layout(self) -> _Layout:
        """The arrays that compute A^T @ g (`_transpose_arrays`): the
        forward ones when symmetric, else the transposed super-row layout
        if built, else the transposed plain BCSR."""
        if self.symmetric:
            return self.forward_layout()
        if self.svals_t is not None:
            return ("super", self.svals_t, self.ucols_t)
        return ("plain", self.vals_t, self.cols_t)

    @property
    def rows(self) -> int:
        """Rows of the forward product (>= n rounded up to 128)."""
        return _layout_rows(self.forward_layout())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x. Pads rows to the layout's row count and columns to a
        multiple of 128, then truncates. bf16 x gives a bf16 result, any
        other x is computed and returned in fp32 (fp32 accumulation)."""
        n, m = x.shape
        m_pad = ((m + 127) // 128) * 128
        if x.dtype != torch.bfloat16:
            x = x.float()
        x_pad = F.pad(x, (0, m_pad - m, 0, self.rows - n)).contiguous()
        return _MatVec.apply(x_pad, self)[:n, :m]
