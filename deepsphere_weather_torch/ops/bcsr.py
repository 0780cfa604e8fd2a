"""Block-sparse (BCSR) Laplacian operator with the SpMM kernels.

Port of `deepsphere_weather_tpu/ops/pallas_spmm.py`:

- `bcsr_from_scipy`: padded BCSR with dense 128x128 blocks (numpy).
- `bcsr_super_from_scipy`: the super-row layout: R consecutive row blocks
  share the union of their block-columns, and each row's blocks are laid
  side by side over the union slots, so a super-row is one
  `[R*128, max_u*128] @ [max_u*128, M]` product. The TPU's DMA slot
  schedule and VMEM tiling have no counterpart on the GPU, so the union
  slots are simply in sorted column order.
- `super_nonzero_slots`, `plain_nonzero_slots`: per row block of a
  super-row or plain layout, the slots whose block is nonzero, built once
  per operator on its device.
- `bcsr_super_spmm`: the super-row product over the listed slots. On a
  CUDA tensor it launches the CUDA kernel `kernels/bcsr_super_spmm.cu`
  (or raises); on a CPU tensor it runs the plain PyTorch version
  `bcsr_super_spmm_reference`. `spmm_regime` names the kernel body a
  launch runs for the operand types (bf16 x: the tensor cores; fp32 x: a
  gather over A's nonzero entries), `spmm_col_tile` the widths it takes.
- `bcsr_spmm`: the plain-BCSR product over the listed slots, the same
  way: the CUDA kernel `kernels/bcsr_spmm.cu` or `bcsr_spmm_reference`.
- `bcsr_super_spmm_rows`, `bcsr_spmm_rows`: the same products over a
  range of super-rows (row blocks) against the full x, the row-sharded
  lowering of `_partitioned_spmm` (K2 for the super-row layout, K3's row
  slice for the plain one); plain versions `*_rows_reference`.
- `ell_spmm`, `ell_spmm_rows`: the fp32 product over the operator's
  nonzeros held row by row (ELL: `sphere.graph.laplacian_to_ell`), whole
  or a range of rows against the full x: the CUDA kernel
  `kernels/ell_spmm.cu` on a CUDA tensor (or raise), the plain versions
  `ell_spmm_reference`, `ell_spmm_rows_reference` on a CPU tensor. It is
  the fp32 route of every fp32 operator (K1, K2 and K3's fp32 regime on
  the nonzeros held row by row; the block kernels' own fp32 entries
  gather over the nonzeros of their blocks).
- `EllOperator`: the ELL operator (JAX's `ell_matvec`, the ELL mode of
  `ChebOperator`), with the gradient of `BlockSparseOperator`.
- `BlockSparseOperator`: the operator a Chebyshev convolution calls,
  with the JAX operator's padding and dtype rules in `matvec` and its
  custom VJP as a `torch.autograd.Function` (the backward computes
  A^T @ g with the same kernels). An fp32 operator also holds its
  `EllOperator`, which takes every fp32 x; bf16 x stays on the block
  layouts.
- `ShardedBlockSparseOperator` (`BlockSparseOperator.row_shard`): one
  node rank's rows of the operator. Its product gathers x over the node
  group and runs the row-range kernel; so does its backward, on the
  transposed layout. This is what GSPMD derived from the JAX operator's
  `custom_partitioning` rule (an all-gather of x, then the row slice).
  Gather and launch are one registered op, `spmm_rows` (`spmm_rows_ell`
  for the ELL rows), whose vmap rule is K5's over K2: the members of a
  member step fold into the columns of one gather and one launch, as the
  JAX rule wraps the partitioned op.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .._device import resolve_device
from ..parallel.collectives import _groups, gather_rows, group_key
from ..sphere.graph import laplacian_to_ell

__all__ = ["bcsr_from_scipy", "bcsr_super_from_scipy", "super_nonzero_slots",
           "plain_nonzero_slots",
           "bcsr_super_spmm", "bcsr_super_spmm_reference",
           "bcsr_super_spmm_rows", "bcsr_super_spmm_rows_reference",
           "bcsr_spmm", "bcsr_spmm_reference",
           "bcsr_spmm_rows", "bcsr_spmm_rows_reference",
           "ell_spmm", "ell_spmm_reference", "ell_spmm_rows",
           "ell_spmm_rows_reference", "EllTables", "ell_tables", "ell_plan",
           "BlockSparseOperator", "ShardedBlockSparseOperator", "EllOperator",
           "spmm", "spmm_rows", "spmm_ell", "spmm_rows_ell",
           "spmm_regime", "spmm_col_tile",
           "launch_counts", "reset_launch_counts"]

_BS = 128

# Launches of each CUDA kernel entry of this module since the last reset:
# a run reads them to show that its path went through the kernels. A
# row-range launch counts under its own key.
launch_counts: Dict[str, int] = {"bcsr_super_spmm": 0, "bcsr_spmm": 0,
                                 "bcsr_super_spmm_rows": 0,
                                 "bcsr_spmm_rows": 0, "ell_spmm": 0,
                                 "ell_spmm_rows": 0}


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


def super_nonzero_slots(svals: torch.Tensor) -> torch.Tensor:
    """The nonzero union slots of each row block of a super-row layout:
    int32 [n_s, R, 1 + max_u] on svals' device. [s, r, 0] is the count c
    of union slots whose block of row block s*R + r has a nonzero entry,
    [s, r, 1:1 + c] those slots in increasing order (the zero slots follow,
    unread). The kernels walk only the listed slots: a zero block adds an
    exact zero, so skipping it changes no sum."""
    n_s, R, bs, ubs = svals.shape
    return _slot_list(
        (svals.view(n_s, R, bs, ubs // bs, bs) != 0).any(dim=4).any(dim=2))


def plain_nonzero_slots(vals: torch.Tensor) -> torch.Tensor:
    """The nonzero slots of each row block of a plain layout: int32
    [n_rb, 1 + max_nb] on vals' device, [r, 0] the count c of slots whose
    block vals[r, b] has a nonzero entry, [r, 1:1 + c] those slots in
    increasing order, as in `super_nonzero_slots`."""
    return _slot_list((vals != 0).flatten(start_dim=2).any(dim=-1))


def _slot_list(nonzero: torch.Tensor) -> torch.Tensor:
    """[..., slots] bool -> int32 [..., 1 + slots]: the count of True
    slots, then those slots in increasing order, then the others."""
    order = torch.argsort((~nonzero).to(torch.uint8), dim=-1, stable=True)
    count = nonzero.sum(dim=-1, keepdim=True)
    return torch.cat([count, order], dim=-1).to(torch.int32).contiguous()


def _listed(nz: torch.Tensor, max_u: int) -> torch.Tensor:
    """[..., max_u] bool: the slots `nz` lists for each row block."""
    listed = torch.arange(max_u, device=nz.device) < nz[..., :1]
    # unlisted entries scatter into a spare column, dropped after
    idx = torch.where(listed, nz[..., 1:].long(), max_u)
    mask = torch.zeros(nz.shape[:-1] + (max_u + 1,), dtype=torch.bool,
                       device=nz.device)
    return mask.scatter_(-1, idx, True)[..., :max_u]


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


def _check_super_layout(svals, ucols, x):
    if svals.dim() != 4 or ucols.dim() != 2 or x.dim() != 2:
        raise ValueError("expected svals [n_s, R, bs, max_u*bs], "
                         "ucols [n_s, max_u], x [rows, M]")
    n_s, R, bs, ubs = svals.shape
    if bs != _BS or ubs % bs or ucols.shape != (n_s, ubs // bs):
        raise ValueError(f"inconsistent super-row layout: svals "
                         f"{tuple(svals.shape)}, ucols {tuple(ucols.shape)}")
    _check_dtypes(svals, ucols, x)


def _check_plain_layout(vals, cols, x):
    if vals.dim() != 4 or cols.dim() != 2 or x.dim() != 2:
        raise ValueError("expected vals [n_rb, max_nb, bs, bs], "
                         "cols [n_rb, max_nb], x [rows, M]")
    n_rb, max_nb, bs, bs2 = vals.shape
    if bs != _BS or bs2 != bs or cols.shape != (n_rb, max_nb):
        raise ValueError(f"inconsistent BCSR layout: vals "
                         f"{tuple(vals.shape)}, cols {tuple(cols.shape)}")
    _check_dtypes(vals, cols, x)


def _check_x_rows(x, rows):
    if x.shape[0] != rows:
        raise ValueError(f"x must have the layout's {rows} rows, got "
                         f"{x.shape[0]}")


def _check_nz(a, nz, plain=False):
    """`nz` (or None) is the slot list of the super-row layout `a`
    ([n_s, R, 1 + max_u]) or, with `plain`, of the plain layout `a`
    ([n_rb, 1 + max_nb])."""
    if nz is None:
        return
    if plain:
        shape, names = (a.shape[0], 1 + a.shape[1]), "[n_rb, 1 + max_nb]"
    else:
        n_s, R, bs, ubs = a.shape
        shape, names = (n_s, R, 1 + ubs // bs), "[n_s, R, 1 + max_u]"
    if nz.dtype != torch.int32 or nz.device != a.device or nz.shape != shape:
        raise ValueError(f"the slot list must be int32 {names} = {shape} on "
                         f"the layout's device, got {str(nz.dtype)[6:]} "
                         f"{tuple(nz.shape)} on {nz.device}")


def _check_args(svals, ucols, x, nz=None):
    _check_super_layout(svals, ucols, x)
    _check_nz(svals, nz)
    _check_x_rows(x, svals.shape[0] * svals.shape[1] * _BS)


def _check_plain_args(vals, cols, x, nz=None):
    _check_plain_layout(vals, cols, x)
    _check_nz(vals, nz, plain=True)
    _check_x_rows(x, vals.shape[0] * _BS)


def _check_range(begin, end, n, x, what):
    """A row-range launch: [begin, end) within the layout's n units, x
    whole 128-row blocks (the full x: that every block-column of the
    range addresses one of its blocks is checked once, when a shard is
    built, not per call)."""
    if not 0 <= begin < end <= n:
        raise ValueError(f"{what} range [{begin}, {end}) is not a non-empty "
                         f"range within the layout's {n}")
    if x.shape[0] % _BS:
        raise ValueError(f"x must be whole {_BS}-row blocks, got "
                         f"{x.shape[0]} rows")


def spmm_regime(a_dtype: torch.dtype, x_dtype: torch.dtype,
                super_layout: bool = True, round_a: bool = True) -> str:
    """The body a CUDA launch of `bcsr_super_spmm` (`super_layout`) or
    `bcsr_spmm`, whole or a row range, runs for A blocks stored in
    `a_dtype` against x in `x_dtype` (float32 or bfloat16 each; raises
    TypeError otherwise):

    - "tensor cores": bf16 A, bf16 x (wgmma);
    - "tensor cores, A rounded": fp32 A rounded to bf16 in registers
      against bf16 x, the TPU kernels' cast (K1, and K3 with `round_a`);
    - "tensor cores, A split": fp32 A as bf16 hi + lo against bf16 x, the
      interpreter kernel's fp32 A (K4: the plain layout without
      `round_a`);
    - "gather": fp32 x against fp32 or bf16 A (widened exactly), fp32
      FMAs over the nonzero entries of the listed blocks alone.

    The output is bf16 for bf16 x, else fp32. The plain versions compute
    the same functions on the CPU."""
    for dt in (a_dtype, x_dtype):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError("the A blocks and x must be float32 or bfloat16")
    if x_dtype == torch.float32:
        return "gather"
    if a_dtype == torch.bfloat16:
        return "tensor cores"
    return ("tensor cores, A rounded" if super_layout or round_a
            else "tensor cores, A split")


def spmm_col_tile(M: int, a_dtype: torch.dtype, x_dtype: torch.dtype) -> int:
    """Columns a CTA of the block layouts' kernels takes at x width M in
    the regime of the operand types (`spmm_regime`); 0 where the kernel
    does not take M. The tensor-core bodies: 256, 128 or 64 by M alone, at
    most 128 with fp32 A (256 spills); the gather body: 64. A launch
    needs M a multiple of it (`matvec` pads to 128 columns). The kernels'
    own `*_col_tile` entries answer the same on the card."""
    regime = spmm_regime(a_dtype, x_dtype)
    if regime == "gather":
        return 64 if M % 64 == 0 else 0
    tile = next((t for t in (256, 128, 64) if M % t == 0), 0)
    return tile if a_dtype == torch.bfloat16 else min(tile, 128)


def _check_launch(k, name, tensors, M, a_bf16, x_bf16):
    tile = getattr(k.lib, f"{name}_col_tile")(M, a_bf16, x_bf16)
    if not tile or M % tile:
        raise ValueError(f"x width {M} is not a multiple of the kernel's "
                         "column tile; matvec pads it")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the A blocks, their columns, x and the slot list "
                         "must be contiguous")
    # the gather body copies A rows and reads x in 16-byte units (the
    # tensor-core body's descriptors raise on a misaligned x themselves)
    a, _, x = tensors[:3]
    if not x_bf16 and (a.data_ptr() % 16 or x.data_ptr() % 16):
        raise ValueError("the A blocks and x must be 16-byte aligned")


def _raise_on(k, name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            k.lib, f"{name}_error_string")(err).decode())


def bcsr_super_spmm_reference(svals: torch.Tensor, ucols: torch.Tensor,
                              x: torch.Tensor,
                              nz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, fp32 einsum, cast.

    out[s*R*bs + r*bs + i, m] = sum_k svals[s, r, i, k] * xg[s, k, m] with
    xg[s] the x blocks of ucols[s] stacked, the blocks of the slots that
    `nz` (`super_nonzero_slots`) does not list for a row block masked to
    zero. Output [n_s*R*bs, M], bf16 for bf16 x and fp32 otherwise."""
    _check_args(svals, ucols, x, nz)
    return _super_product(svals, ucols, x, nz)


def _super_product(svals, ucols, x, nz):
    n_s, R, bs, ubs = svals.shape
    M = x.shape[1]
    a = svals.to(_x_regime(x)).float()
    if nz is not None:
        a = (a.view(n_s, R, bs, ubs // bs, bs)
             * _listed(nz, ubs // bs)[:, :, None, :, None]).view(a.shape)
    xb = x.float().reshape(-1, bs, M)
    xg = xb[ucols.long()].reshape(n_s, ubs, M)
    out = torch.einsum("srik,skm->srim", a, xg)
    return out.reshape(n_s * R * bs, M).to(_x_regime(x))


def bcsr_super_spmm_rows_reference(svals: torch.Tensor, ucols: torch.Tensor,
                                   x: torch.Tensor, s_begin: int, s_end: int,
                                   nz: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the row-range kernel: the tables (and
    `nz`, as in `bcsr_super_spmm_reference`) sliced to the super-rows
    [s_begin, s_end), gathering from the full x. Output
    [(s_end - s_begin)*R*bs, M], row i the row s_begin*R*bs + i of the
    full product."""
    _check_super_layout(svals, ucols, x)
    _check_nz(svals, nz)
    _check_range(s_begin, s_end, svals.shape[0], x, "super-row")
    return _super_product(svals[s_begin:s_end], ucols[s_begin:s_end], x,
                          None if nz is None else nz[s_begin:s_end])


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _bind(name, entries):
    """Load kernels/<name>.cu and type its entries ({entry: argtypes})."""
    from ..kernels.build import load_kernel

    k = load_kernel(name)
    for entry, argtypes in entries.items():
        fn = getattr(k.lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    tile = getattr(k.lib, f"{name}_col_tile")      # (M, a_bf16, x_bf16)
    tile.argtypes = [_I64, _I, _I]
    tile.restype = ctypes.c_int
    err = getattr(k.lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return k


@functools.lru_cache(maxsize=None)
def _kernel():
    head = [_P, _I, _P, _P, _I, _P, _P]      # svals, a_bf16, ucols, x, x_bf16, nz, out
    return _bind("bcsr_super_spmm", {
        "bcsr_super_spmm": head + [_I64, _I, _I, _I64, _P],
        "bcsr_super_spmm_rows": head + [_I64, _I64, _I, _I, _I64, _I64, _P]})


@functools.lru_cache(maxsize=None)
def _plain_kernel():
    # vals, a_bf16, cols, x, x_bf16, round_a, nz, out
    head = [_P, _I, _P, _P, _I, _I, _P, _P]
    return _bind("bcsr_spmm", {
        "bcsr_spmm": head + [_I64, _I, _I64, _P],
        "bcsr_spmm_rows": head + [_I64, _I64, _I, _I64, _I64, _P]})


def _launch(k, lib_name, entry, a, idx, x, out, extra, sizes):
    """Launch `entry` of library `lib_name` on x's device and current
    stream: (A, a_bf16, idx, x, x_bf16, *extra, out, *sizes, stream), a
    tensor in `extra` passed as its pointer (None as NULL). Raise if the
    launch failed, else count it."""
    a_bf16, x_bf16 = int(a.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16)
    tensors = [a, idx, x] + [e for e in extra if isinstance(e, torch.Tensor)]
    _check_launch(k, lib_name, tensors, x.shape[1], a_bf16, x_bf16)
    extra = [e.data_ptr() if isinstance(e, torch.Tensor) else e for e in extra]
    # the C entry point launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(k.lib, entry)(
            a.data_ptr(), a_bf16, idx.data_ptr(), x.data_ptr(), x_bf16,
            *extra, out.data_ptr(), *sizes, stream)
    _raise_on(k, lib_name, err)
    launch_counts[entry] += 1
    return out


def bcsr_super_spmm(svals: torch.Tensor, ucols: torch.Tensor,
                    x: torch.Tensor,
                    nz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x for A in super-row BCSR; x [n_s*R*128, M], M a multiple
    of the kernel's column tile (`spmm_col_tile`; 64 does for every
    regime). `nz` (`super_nonzero_slots`) lists the slots each row block
    walks; None walks every slot.

    CUDA tensors run the hand-written kernel (a failed build, descriptor
    encode or launch raises) in the body `spmm_regime` names: the tensor
    cores for bf16 x (fp32 A rounded to bf16), the gather over A's
    nonzero entries for fp32 x (bf16 A widened); CPU tensors run
    `bcsr_super_spmm_reference`, the same function."""
    _check_args(svals, ucols, x, nz)
    if not x.is_cuda:
        return bcsr_super_spmm_reference(svals, ucols, x, nz)
    n_s, R, bs, ubs = svals.shape
    out = torch.empty((n_s * R * bs, x.shape[1]), dtype=_x_regime(x),
                      device=x.device)
    return _launch(_kernel(), "bcsr_super_spmm", "bcsr_super_spmm", svals,
                   ucols, x, out, (nz,), (n_s, R, ubs // bs, x.shape[1]))


def bcsr_super_spmm_rows(svals: torch.Tensor, ucols: torch.Tensor,
                         x: torch.Tensor, s_begin: int, s_end: int,
                         nz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The super-rows [s_begin, s_end) of A @ x against the full x
    [n_cb*128, M]: [(s_end - s_begin)*R*128, M] (K2). `nz` covers the
    whole layout, as in `bcsr_super_spmm`.

    CUDA tensors run the hand-written kernel's row-range entry (counted
    as `bcsr_super_spmm_rows`; a failed build, descriptor encode or
    launch raises); CPU tensors run `bcsr_super_spmm_rows_reference`."""
    _check_super_layout(svals, ucols, x)
    _check_nz(svals, nz)
    _check_range(s_begin, s_end, svals.shape[0], x, "super-row")
    if not x.is_cuda:
        return bcsr_super_spmm_rows_reference(svals, ucols, x, s_begin, s_end,
                                              nz)
    n_s, R, bs, ubs = svals.shape
    out = torch.empty(((s_end - s_begin) * R * bs, x.shape[1]),
                      dtype=_x_regime(x), device=x.device)
    return _launch(_kernel(), "bcsr_super_spmm", "bcsr_super_spmm_rows",
                   svals, ucols, x, out, (nz,),
                   (s_begin, s_end, R, ubs // bs, x.shape[0], x.shape[1]))


def bcsr_spmm_reference(vals: torch.Tensor, cols: torch.Tensor,
                        x: torch.Tensor, nz: Optional[torch.Tensor] = None,
                        round_a: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the plain-BCSR kernel: gather, fp32 einsum,
    cast.

    out[r*bs + i, m] = sum_b sum_j vals[r, b, i, j] * x[cols[r, b]*bs + j, m],
    the blocks of the slots that `nz` (`plain_nonzero_slots`) does not list
    for a row block masked to zero. Output [n_rb*bs, M], bf16 for bf16 x
    and fp32 otherwise. `round_a` matters only for fp32 A against bf16 x:
    True rounds A to bf16 (the compiled TPU kernel's regime), False keeps
    it fp32 (the interpreter kernel's, which widens both operands)."""
    _check_plain_args(vals, cols, x, nz)
    return _plain_product(vals, cols, x, nz, round_a)


def _plain_product(vals, cols, x, nz, round_a):
    n_rb, max_nb, bs, _ = vals.shape
    M = x.shape[1]
    a = (vals.to(_x_regime(x)) if round_a else vals).float()
    if nz is not None:
        a = a * _listed(nz, max_nb)[:, :, None, None]
    xg = x.float().reshape(-1, bs, M)[cols.long()]   # [n_rb, max_nb, bs, M]
    out = torch.einsum("rbij,rbjm->rim", a, xg)
    return out.reshape(n_rb * bs, M).to(_x_regime(x))


def bcsr_spmm_rows_reference(vals: torch.Tensor, cols: torch.Tensor,
                             x: torch.Tensor, rb_begin: int, rb_end: int,
                             nz: Optional[torch.Tensor] = None,
                             round_a: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the plain-BCSR row-range kernel: the
    tables (and `nz`) sliced to the row blocks [rb_begin, rb_end),
    gathering from the full x. Output [(rb_end - rb_begin)*bs, M]; `nz`
    and `round_a` as in `bcsr_spmm_reference`."""
    _check_plain_layout(vals, cols, x)
    _check_nz(vals, nz, plain=True)
    _check_range(rb_begin, rb_end, vals.shape[0], x, "row-block")
    return _plain_product(vals[rb_begin:rb_end], cols[rb_begin:rb_end], x,
                          None if nz is None else nz[rb_begin:rb_end],
                          round_a)


def bcsr_spmm(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
              nz: Optional[torch.Tensor] = None,
              round_a: bool = True) -> torch.Tensor:
    """y = A @ x for A in plain padded BCSR; x [n_rb*128, M], M a multiple
    of the kernel's column tile (`spmm_col_tile`; 64 does for every
    regime). `nz` (`plain_nonzero_slots`) lists the slots each row block
    walks; None walks every slot.

    CUDA tensors run the hand-written kernel (a failed build, descriptor
    encode or launch raises) in the body `spmm_regime` names: the tensor
    cores for bf16 x (fp32 A rounded to bf16 with `round_a`, split into
    bf16 hi + lo without), the gather over A's nonzero entries for fp32 x
    (bf16 A widened); CPU tensors run `bcsr_spmm_reference`, the same
    function. `round_a` as there."""
    _check_plain_args(vals, cols, x, nz)
    if not x.is_cuda:
        return bcsr_spmm_reference(vals, cols, x, nz, round_a)
    n_rb, max_nb, bs, _ = vals.shape
    out = torch.empty((n_rb * bs, x.shape[1]), dtype=_x_regime(x),
                      device=x.device)
    return _launch(_plain_kernel(), "bcsr_spmm", "bcsr_spmm", vals, cols, x,
                   out, (int(bool(round_a)), nz), (n_rb, max_nb, x.shape[1]))


def bcsr_spmm_rows(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   rb_begin: int, rb_end: int,
                   nz: Optional[torch.Tensor] = None,
                   round_a: bool = True) -> torch.Tensor:
    """The row blocks [rb_begin, rb_end) of A @ x for A in plain padded
    BCSR, against the full x [n_cb*128, M]: [(rb_end - rb_begin)*128, M]
    (K3's row-sharded form). `nz` covers the whole layout, as in
    `bcsr_spmm`.

    CUDA tensors run the hand-written kernel's row-range entry (counted
    as `bcsr_spmm_rows`; a failed build, descriptor encode or launch
    raises); CPU tensors run `bcsr_spmm_rows_reference`. `round_a` as in
    `bcsr_spmm`."""
    _check_plain_layout(vals, cols, x)
    _check_nz(vals, nz, plain=True)
    _check_range(rb_begin, rb_end, vals.shape[0], x, "row-block")
    if not x.is_cuda:
        return bcsr_spmm_rows_reference(vals, cols, x, rb_begin, rb_end, nz,
                                        round_a)
    n_rb, max_nb, bs, _ = vals.shape
    out = torch.empty(((rb_end - rb_begin) * bs, x.shape[1]),
                      dtype=_x_regime(x), device=x.device)
    return _launch(_plain_kernel(), "bcsr_spmm", "bcsr_spmm_rows", vals, cols,
                   x, out, (int(bool(round_a)), nz),
                   (rb_begin, rb_end, max_nb, x.shape[0], x.shape[1]))


# The union tables' row blocks (`ell_tables`): this many consecutive rows,
# halved while a block's union names more than ELL_UNION_CAP rows of x
# (the kernel's stages are sized by the largest union). An H100 sweep of
# the kernel's shapes put 32 rows first (PERF.md): three CTAs an SM; at
# knn-20 nested HEALPix their unions hold at most 109 rows.
ELL_BLOCK_ROWS, ELL_UNION_CAP = 32, 112


class EllTables(NamedTuple):
    """How the ELL kernel reads a layout (`ell_tables`): its rows cut into
    blocks of consecutive rows; block b holds the rows [blocks[0, b],
    blocks[0, b + 1]) and stages the x rows urows[blocks[1, b]:
    blocks[1, b + 1]], the sorted union of the columns they name;
    loc[r, j] (int16) is slot (r, j)'s index into its block's union.
    umax: the largest union; rmax: the most rows of a block."""

    loc: torch.Tensor
    blocks: torch.Tensor
    urows: torch.Tensor
    umax: int
    rmax: int


def ell_tables(cols: torch.Tensor) -> EllTables:
    """The union tables of the ELL layout whose column table is `cols`
    [n, W] (built on the host, once per layout; on cols' device): blocks
    of ELL_BLOCK_ROWS rows, halved while a union names more than
    ELL_UNION_CAP rows. Padding slots name column 0, so row 0 is in the
    union of every block that has one."""
    c = cols.cpu().numpy()
    n, width = c.shape
    firsts, unions = [], []
    loc = np.empty((n, width), np.int16)

    def add(b0, b1):
        u, inv = np.unique(c[b0:b1].ravel(), return_inverse=True)
        if len(u) > ELL_UNION_CAP and b1 - b0 > 1:
            mid = (b0 + b1) // 2
            add(b0, mid)
            add(mid, b1)
            return
        firsts.append(b0)
        unions.append(u.astype(np.int32))
        loc[b0:b1] = inv.reshape(b1 - b0, width)

    for b0 in range(0, n, ELL_BLOCK_ROWS):
        add(b0, min(n, b0 + ELL_BLOCK_ROWS))
    sizes = [len(u) for u in unions]
    umax = max(sizes, default=0)
    rmax = max(np.diff(firsts + [n]), default=0)
    blocks = np.stack([np.array(firsts + [n]),
                       np.concatenate([[0], np.cumsum(sizes)])])
    return EllTables(torch.from_numpy(loc).to(cols.device),
                     torch.from_numpy(blocks.astype(np.int32)).to(cols.device),
                     torch.from_numpy(np.concatenate(unions or [
                         np.zeros(0, np.int32)])).to(cols.device),
                     int(umax), int(rmax))


def _check_ell(vals, cols, x):
    if vals.dim() != 2 or cols.dim() != 2 or x.dim() != 2:
        raise ValueError("expected vals [n, W], cols [n, W], x [rows, M]")
    if vals.shape != cols.shape:
        raise ValueError(f"inconsistent ELL layout: vals {tuple(vals.shape)}, "
                         f"cols {tuple(cols.shape)}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("the ELL product is fp32: vals and x must be float32")
    if cols.dtype != torch.int32:
        raise TypeError("the ELL column table must be int32")
    if not (vals.device == cols.device == x.device):
        raise ValueError("vals, cols and x must be on one device")


def _check_ell_rows(r0, r1, n):
    if not 0 <= r0 < r1 <= n:
        raise ValueError(f"row range [{r0}, {r1}) is not a non-empty range "
                         f"within the layout's {n}")


def ell_spmm_reference(vals: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ELL kernel, in its order:
    out[r, m] = sum_j vals[r, j] * x[cols[r, j], m], each product rounded to
    fp32 and added to the row's sum for j = 0, 1, ... (as the kernel does,
    so the two agree bit for bit). Output [n, M] fp32."""
    _check_ell(vals, cols, x)
    return _ell_product(vals, cols, x)


def _ell_product(vals, cols, x):
    out = x.new_zeros((vals.shape[0], x.shape[1]))
    for j in range(vals.shape[1]):
        out = out + vals[:, j, None] * x[cols[:, j].long()]
    return out


def ell_spmm_rows_reference(vals: torch.Tensor, cols: torch.Tensor,
                            x: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Plain PyTorch version of the ELL row-range kernel: the rows
    [r0, r1) of `ell_spmm_reference`, gathering from the full x."""
    _check_ell(vals, cols, x)
    _check_ell_rows(r0, r1, vals.shape[0])
    return _ell_product(vals[r0:r1], cols[r0:r1], x)


@functools.lru_cache(maxsize=None)
def _ell_kernel():
    from ..kernels.build import load_kernel

    k = load_kernel("ell_spmm")
    head = [_P] * 6                  # vals, loc, blocks, urows, x, out
    tail = [_I, _I, _I64, _I, _I, _P]    # nb, W, M, umax, rmax, stream
    for entry, argtypes in {
            "ell_spmm": head + [_I64] + tail,
            "ell_spmm_rows": head + [_I64, _I64, _I64] + tail}.items():
        fn = getattr(k.lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    k.lib.ell_spmm_plan.argtypes = [_I64, _I, _I, _I, _P]
    k.lib.ell_spmm_plan.restype = ctypes.c_int
    k.lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
    k.lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return k


def ell_plan(tables: EllTables, width: int, M: int) -> Dict[str, int]:
    """How the ELL kernel runs at x width M over `tables` of a layout of
    width W = `width`, as the card's runtime answers it: the column tile,
    the shared memory of a CTA and the CTAs an SM holds (builds the
    kernel; needs CUDA)."""
    k = _ell_kernel()
    out = (ctypes.c_int * 3)()
    err = k.lib.ell_spmm_plan(M, tables.umax, tables.rmax, width, out)
    if err:
        raise RuntimeError("ell_spmm_plan failed: "
                           + k.lib.ell_spmm_error_string(err).decode())
    return dict(zip(("col_tile", "smem_bytes", "ctas_per_sm"), out))


def _ell_launch(entry, vals, tables, x, out, sizes):
    """Launch `entry` of the ELL kernel on x's device and current stream:
    (vals, loc, blocks, urows, x, out, n, *sizes, nb, W, M, umax, rmax,
    stream). Raise if the launch failed, else count it. A 16-byte
    misaligned x (a view) is copied first: the kernel copies x in 16-byte
    units."""
    M = x.shape[1]
    if M % 4 or M == 0:
        raise ValueError(f"x width {M} is not a positive multiple of 4; "
                         "matvec pads it")
    if tables is None:
        raise ValueError("the ELL kernel reads the layout through its union "
                         "tables (`ell_tables(cols)`)")
    loc, blocks, urows, umax, rmax = tables
    if loc.shape != vals.shape or blocks.dim() != 2 or blocks.shape[0] != 2:
        raise ValueError("the union tables are not those of this layout")
    if not all(t.is_contiguous() and t.device == x.device
               for t in (vals, loc, blocks, urows)):
        raise ValueError("the ELL vals and tables must be contiguous and on "
                         "x's device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    k = _ell_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(k.lib, entry)(
            vals.data_ptr(), loc.data_ptr(), blocks.data_ptr(),
            urows.data_ptr(), x.data_ptr(), out.data_ptr(), vals.shape[0],
            *sizes, blocks.shape[1] - 1, vals.shape[1], M, umax, rmax,
            stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           + k.lib.ell_spmm_error_string(err).decode())
    launch_counts[entry] += 1
    return out


def ell_spmm(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             tables: Optional[EllTables] = None) -> torch.Tensor:
    """y = L @ x for L in ELL (vals [n, W] fp32, cols [n, W] int32), fp32
    x [rows, M] with M a multiple of 4 and every column index below rows:
    y [n, M] fp32.

    CUDA tensors run the hand-written kernel `kernels/ell_spmm.cu`, which
    reads the layout through `tables` (`ell_tables(cols)`; without them,
    or on a failed build or launch, it raises); CPU tensors run
    `ell_spmm_reference`."""
    _check_ell(vals, cols, x)
    if not x.is_cuda:
        return ell_spmm_reference(vals, cols, x)
    out = torch.empty((vals.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _ell_launch("ell_spmm", vals, tables, x, out, ())


def ell_spmm_rows(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                  r0: int, r1: int,
                  tables: Optional[EllTables] = None) -> torch.Tensor:
    """The rows [r0, r1) of `ell_spmm` against the full x: [r1 - r0, M],
    bit for bit the full product's rows (K2's and K3's row range in
    fp32).

    CUDA tensors run the kernel's row-range entry (counted as
    `ell_spmm_rows`) over the layout's `tables`; CPU tensors run
    `ell_spmm_rows_reference`."""
    _check_ell(vals, cols, x)
    _check_ell_rows(r0, r1, vals.shape[0])
    if not x.is_cuda:
        return ell_spmm_rows_reference(vals, cols, x, r0, r1)
    out = torch.empty((r1 - r0, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _ell_launch("ell_spmm_rows", vals, tables, x, out, (r0, r1))


def _fit_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad or truncate axis 0 to exactly `rows` (a super layout and a
    plain one differ in their padding rows only, which no block reads)."""
    if x.shape[0] == rows:
        return x
    if x.shape[0] > rows:
        return x[:rows].contiguous()
    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


# A layout: ("super", svals, ucols, nz), ("plain", vals, cols, nz) or
# ("ell", vals, cols, tables), tables its `EllTables`
_Layout = Tuple[str, torch.Tensor, torch.Tensor, object]


def _layout_rows(layout) -> int:
    kind, a = layout[:2]
    if kind == "ell":
        return a.shape[0]
    return (a.shape[0] * a.shape[1] * a.shape[2] if kind == "super"
            else a.shape[0] * a.shape[2])


# The full-range product as a registered op: `torch.export` traces it
# through its fake (shape and dtype only) and `torch.func.vmap` through its
# vmap rule. Its body is the wrapper of the layout, so device dispatch and
# the launch counts stay the wrapper's.
@torch.library.custom_op(
    "deepsphere_weather_torch::spmm", mutates_args=(),
    schema="(Tensor a, Tensor idx, Tensor x, Tensor? nz, bool super_layout)"
           " -> Tensor")
def spmm(a, idx, x, nz, super_layout):
    """A @ x on a super-row (`super_layout`) or plain BCSR layout, x
    fitted to the layout's rows by the caller: the module's wrapper
    `bcsr_super_spmm` or `bcsr_spmm` (round_a=True), looked up by name at
    each call, so a replaced module attribute is the one that runs."""
    if super_layout:
        return bcsr_super_spmm(a, idx, x, nz)
    return bcsr_spmm(a, idx, x, nz)


@spmm.register_fake
def _(a, idx, x, nz, super_layout):
    rows = (a.shape[0] * a.shape[1] * a.shape[2] if super_layout
            else a.shape[0] * a.shape[2])
    return x.new_empty((rows, x.shape[1]), dtype=_x_regime(x))


def _fold_vmap(op, x_arg: int):
    """K5 (`custom_vmap` of `_partitioned_spmm`) for the product op `op`,
    whose argument `x_arg` is x [n, m]: a mapped x [K, n, m] folds into
    the columns, one product on [n, K*m], reshaped back. The product is
    linear per column, so this is exact. A mapped operator array raises."""

    def rule(info, in_dims, *args):
        if any(d is not None for i, d in enumerate(in_dims) if i != x_arg):
            raise NotImplementedError(
                "vmap over BlockSparseOperator arrays themselves is not "
                "supported (one shared operator per vmap is: the mapped "
                "axis folds into the matvec columns)")
        x_d = in_dims[x_arg]
        if x_d is None:
            return op(*args), None
        x = args[x_arg].movedim(x_d, 0)
        k, n, m = x.shape
        args = list(args)
        args[x_arg] = x.movedim(0, 1).reshape(n, k * m).contiguous()
        y = op(*args)
        return y.reshape(y.shape[0], k, m).movedim(1, 0), 0

    return rule


torch.library.register_vmap(spmm, _fold_vmap(spmm, 2))


# The ELL product as a registered op, as `spmm` is for the block layouts;
# the layout's union tables (`EllTables`) enter as their tensors and ints.
@torch.library.custom_op(
    "deepsphere_weather_torch::spmm_ell", mutates_args=(),
    schema="(Tensor vals, Tensor cols, Tensor loc, Tensor blocks, "
           "Tensor urows, Tensor x, int umax, int rmax) -> Tensor")
def spmm_ell(vals, cols, loc, blocks, urows, x, umax, rmax):
    """L @ x on an ELL layout: the module's wrapper `ell_spmm`, looked up
    by name at each call."""
    return ell_spmm(vals, cols, x, EllTables(loc, blocks, urows, umax, rmax))


@spmm_ell.register_fake
def _(vals, cols, loc, blocks, urows, x, umax, rmax):
    return x.new_empty((vals.shape[0], x.shape[1]), dtype=torch.float32)


torch.library.register_vmap(spmm_ell, _fold_vmap(spmm_ell, 5))


def _run_mv(layout: _Layout, x_pad: torch.Tensor, n_out: int) -> torch.Tensor:
    """One product on `layout` (the registered op), x fitted to its rows,
    output to n_out."""
    kind, a, idx, nz = layout
    x_fit = _fit_rows(x_pad, _layout_rows(layout))
    if kind == "ell":
        loc, blocks, urows, umax, rmax = nz
        return _fit_rows(spmm_ell(a, idx, loc, blocks, urows, x_fit, umax,
                                  rmax), n_out)
    return _fit_rows(spmm(a, idx, x_fit, nz, kind == "super"), n_out)


class _MatVec(torch.autograd.Function):
    """y = A @ x_pad, with the JAX operator's custom VJP: the backward
    computes A^T @ g in the primal's dtype on the transposed layout
    (`kind_t`, `a_t`, `idx_t`, `nz_t`: the forward's own arrays when A is
    symmetric). The operator arrays get no gradient. In torch.func's form
    (`setup_context`, `generate_vmap_rule`): vmap runs it through the op's
    rule, forward and backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x_pad, kind, a, idx, nz, kind_t, a_t, idx_t, nz_t):
        return _run_mv((kind, a, idx, nz), x_pad, x_pad.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_pad, _, _, _, _, kind_t, a_t, idx_t, nz_t = inputs
        ctx.kind_t, ctx.x_dtype = kind_t, x_pad.dtype
        # an ELL layout's tables: their tensors saved, their ints kept
        ctx.tables_ints = nz_t[3:] if kind_t == "ell" else None
        ctx.save_for_backward(a_t, idx_t, *(nz_t[:3] if kind_t == "ell"
                                            else (nz_t,)))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a_t, idx_t, *nz_t = ctx.saved_tensors
        nz_t = (EllTables(*nz_t, *ctx.tables_ints) if ctx.kind_t == "ell"
                else nz_t[0])
        g = g.to(ctx.x_dtype).contiguous()
        gx = _run_mv((ctx.kind_t, a_t, idx_t, nz_t), g, g.shape[0])
        return (gx.to(ctx.x_dtype),) + (None,) * 8


def _ell_x(x: torch.Tensor):
    """x as the ELL product takes it: fp32, its columns zero-padded to a
    multiple of 4, contiguous; and the dtype of the result (bf16 for bf16
    x, else fp32)."""
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    m = x.shape[1]
    x = x.float()
    if m % 4:
        x = F.pad(x, (0, 4 - m % 4))
    return x.contiguous(), out_dtype


class BlockSparseOperator:
    """Block-sparse Laplacian; `matvec(x)`: [V, M] -> [V, M], with a
    gradient in x.

    The forward product runs on the super-row layout (`svals`, `ucols`)
    when there is one, else on the plain BCSR (`vals`, `cols`). A
    symmetric operator reuses those arrays for the backward; a
    non-symmetric one carries the transposed layout, super-row
    (`svals_t`, `ucols_t`) if built, else plain (`vals_t`, `cols_t`). Each
    layout gets its list of nonzero slots (`nz`, `nz_t`:
    `super_nonzero_slots` or `plain_nonzero_slots`), built here once, on
    its device. `ell`, an `EllOperator` of the same matrix (fp32 operators
    from `from_scipy`), takes every x that is not bf16: the product over
    the nonzeros, forward and backward."""

    def __init__(self, n: int, svals=None, ucols=None, vals=None, cols=None,
                 svals_t=None, ucols_t=None, vals_t=None, cols_t=None,
                 ell: Optional["EllOperator"] = None):
        if svals is None and vals is None:
            raise ValueError("a forward layout (svals/ucols or vals/cols) "
                             "is required")
        self.n = int(n)
        self.ell = ell
        self.svals, self.ucols = svals, ucols
        self.vals, self.cols = vals, cols
        self.svals_t, self.ucols_t = svals_t, ucols_t
        self.vals_t, self.cols_t = vals_t, cols_t
        self.nz = (super_nonzero_slots(svals) if svals is not None
                   else plain_nonzero_slots(vals))
        self.nz_t = (super_nonzero_slots(svals_t) if svals_t is not None
                     else None if vals_t is None
                     else plain_nonzero_slots(vals_t))

    @classmethod
    def from_scipy(cls, mat, symmetric: bool = True, dtype=torch.float32,
                   rows_per_super: int = 2, device="cuda"):
        """`dtype` is the stored precision of the A blocks (bf16 halves
        their bytes; bf16 activations round A to bf16 anyway).
        `rows_per_super` > 1 builds the super-row layout (the K1 kernel);
        0, None or 1 the plain padded BCSR (the K3 kernel). A
        non-symmetric `mat` also gets the same layout of its transpose.
        An fp32 operator also holds the `EllOperator` of `mat`, which
        computes its products with fp32 x."""
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
        ell = (EllOperator.from_scipy(mat, symmetric=symmetric, device=device)
               if dtype == torch.float32 else None)
        if rows_per_super and rows_per_super > 1:
            return cls(mat.shape[0], svals=a, ucols=idx, svals_t=a_t,
                       ucols_t=idx_t, ell=ell)
        return cls(mat.shape[0], vals=a, cols=idx, vals_t=a_t, cols_t=idx_t,
                   ell=ell)

    @property
    def symmetric(self) -> bool:
        return self.svals_t is None and self.vals_t is None

    def forward_layout(self) -> _Layout:
        if self.svals is not None:
            return ("super", self.svals, self.ucols, self.nz)
        return ("plain", self.vals, self.cols, self.nz)

    def transpose_layout(self) -> _Layout:
        """The arrays that compute A^T @ g (`_transpose_arrays`): the
        forward ones when symmetric, else the transposed super-row layout
        if built, else the transposed plain BCSR."""
        if self.symmetric:
            return self.forward_layout()
        if self.svals_t is not None:
            return ("super", self.svals_t, self.ucols_t, self.nz_t)
        return ("plain", self.vals_t, self.cols_t, self.nz_t)

    @property
    def rows(self) -> int:
        """Rows of the forward product (>= n rounded up to 128)."""
        return _layout_rows(self.forward_layout())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x. A block layout's product pads rows to the layout's row
        count and columns to a multiple of 128, then truncates. bf16 x
        gives a bf16 result, any other x is computed and returned in fp32
        (fp32 accumulation): on `ell` when the operator has one."""
        if x.dtype != torch.bfloat16 and self.ell is not None:
            return self.ell.matvec(x)
        n, m = x.shape
        m_pad = ((m + 127) // 128) * 128
        if x.dtype != torch.bfloat16:
            x = x.float()
        x_pad = F.pad(x, (0, m_pad - m, 0, self.rows - n)).contiguous()
        if not torch.is_grad_enabled():
            return _run_mv(self.forward_layout(), x_pad, x_pad.shape[0])[:n, :m]
        return _MatVec.apply(x_pad, *self.forward_layout(),
                             *self.transpose_layout())[:n, :m]

    def row_shard(self, v0: int, v1: int, group) -> "ShardedBlockSparseOperator":
        """The rows [v0, v1) of this operator for one rank of the node
        process group `group`, whose ranks hold consecutive equal node
        ranges in rank order. The shard keeps only the super-rows (row
        blocks) that cover [v0, v1), of the forward and, when the
        operator is not symmetric, of the transposed layout."""
        if not 0 <= v0 < v1 <= self.n:
            raise ValueError(f"node range [{v0}, {v1}) is not within the "
                             f"operator's {self.n} rows")
        fwd = _shard_layout(self.forward_layout(), v0, v1)
        bwd = None if self.symmetric else _shard_layout(
            self.transpose_layout(), v0, v1)
        ell = None if self.ell is None else self.ell.row_shard(v0, v1, group)
        return ShardedBlockSparseOperator(self.n, v0, v1, group, fwd, bwd,
                                          ell=ell)


class EllOperator:
    """L in ELL (`sphere.graph.laplacian_to_ell`: vals [n, W] fp32, cols
    [n, W] int32, every column index below n); `matvec(x)`: [n, M] ->
    [n, M], with a gradient in x. The product runs `ell_spmm` (the
    registered op `spmm_ell`), forward and, through `_MatVec`, backward on
    the transposed layout (`vals_t`, `cols_t`: the forward's own when L is
    symmetric). Each layout's union tables (`tables`, `tables_t`:
    `ell_tables`), which the kernel reads it through, are built here once.
    It is computed in fp32; bf16 x gives a bf16 result."""

    def __init__(self, n: int, vals: torch.Tensor, cols: torch.Tensor,
                 vals_t: Optional[torch.Tensor] = None,
                 cols_t: Optional[torch.Tensor] = None):
        for v, c in ((vals, cols), (vals_t, cols_t)):
            if (v is None) != (c is None):
                raise ValueError("an ELL layout needs both vals and cols")
            if v is not None and (v.dim() != 2 or v.shape != c.shape
                                  or v.shape[0] != n):
                raise ValueError(f"ELL layout of {n} rows expected, got vals "
                                 f"{tuple(v.shape)}, cols {tuple(c.shape)}")
        self.n = int(n)
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.tables = ell_tables(cols)
        self.tables_t = None if cols_t is None else ell_tables(cols_t)

    @classmethod
    def from_scipy(cls, mat, symmetric: bool = True, dtype=torch.float32,
                   device="cuda"):
        """The ELL layouts of `mat` (and of its transpose unless
        `symmetric`). `dtype` is the precision of the values (bf16 rounds
        them); they are kept in fp32, the kernel's type."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("dtype must be torch.float32 or torch.bfloat16")
        device = resolve_device(device)

        def layout(m):
            cols, vals = laplacian_to_ell(m)
            return (torch.from_numpy(vals).to(device).to(dtype).float()
                    .contiguous(), torch.from_numpy(cols).to(device))

        vals, cols = layout(mat)
        vals_t, cols_t = (None, None) if symmetric else layout(mat.T.tocsr())
        return cls(mat.shape[0], vals, cols, vals_t, cols_t)

    @property
    def symmetric(self) -> bool:
        return self.vals_t is None

    def forward_layout(self) -> _Layout:
        return ("ell", self.vals, self.cols, self.tables)

    def transpose_layout(self) -> _Layout:
        if self.symmetric:
            return self.forward_layout()
        return ("ell", self.vals_t, self.cols_t, self.tables_t)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x: x in fp32 with its columns padded to a multiple of 4,
        the result truncated and in fp32 (bf16 for bf16 x)."""
        n, m = x.shape
        x_pad, out_dtype = _ell_x(x)
        if not torch.is_grad_enabled():
            y = _run_mv(self.forward_layout(), x_pad, n)
        else:
            y = _MatVec.apply(x_pad, *self.forward_layout(),
                              *self.transpose_layout())
        return y[:, :m].to(out_dtype)

    def row_shard(self, v0: int, v1: int,
                  group) -> "ShardedBlockSparseOperator":
        """The rows [v0, v1) of this operator for one rank of the node
        process group `group`, as `BlockSparseOperator.row_shard`: the
        rows [v0, v1) of the forward layout and, when L is not
        symmetric, of the transposed one, each with the union tables of
        those rows against the full x."""
        if not 0 <= v0 < v1 <= self.n:
            raise ValueError(f"node range [{v0}, {v1}) is not within the "
                             f"operator's {self.n} rows")

        def rows(layout):
            _, vals, cols, _ = layout
            cols = cols[v0:v1].contiguous()
            return ("ell", vals[v0:v1].contiguous(), cols, ell_tables(cols),
                    v0, self.n)

        return ShardedBlockSparseOperator(
            self.n, v0, v1, group, rows(self.forward_layout()),
            None if self.symmetric else rows(self.transpose_layout()))


# One rank's slice of a layout: (kind, A blocks, block-column table, slot
# list, first row of the slice in the full product, rows of the full
# layout); an ELL slice is ("ell", vals, cols, tables, v0, n), its rows
# [v0, v1) exactly and their union tables
_ShardLayout = Tuple[str, torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                     int, int]


def _shard_layout(layout: _Layout, v0: int, v1: int) -> _ShardLayout:
    """The units (super-rows or row blocks) of `layout` that cover rows
    [v0, v1); checks once, on the host, that every block-column they name
    addresses a block of the full x."""
    kind, a, idx, nz = layout
    unit = _BS * (a.shape[1] if kind == "super" else 1)
    lo, hi = v0 // unit, -(-v1 // unit)
    full_rows = _layout_rows(layout)
    top = int(idx[lo:hi].cpu().numpy().max())
    if top >= full_rows // _BS:
        raise ValueError(f"block-column {top} lies outside the full x's "
                         f"{full_rows // _BS} blocks")
    return (kind, a[lo:hi].contiguous(), idx[lo:hi].contiguous(),
            nz[lo:hi].contiguous(), lo * unit, full_rows)


def _run_rows(layout: _ShardLayout, x_full: torch.Tensor, v0: int,
              v1: int) -> torch.Tensor:
    """Rows [v0, v1) of the product of a shard's layout with the full x
    (fitted to the full layout's rows): one row-range launch over the
    shard's units, then the rank's rows of its output."""
    kind, a, idx, nz, r0, full_rows = layout
    x_fit = _fit_rows(x_full, full_rows)
    rows = (bcsr_super_spmm_rows if kind == "super" else bcsr_spmm_rows)
    y = rows(a, idx, x_fit, 0, a.shape[0], nz)
    return y[v0 - r0:v1 - r0]


# The row-sharded product as a registered op: the node gather of x and
# the row-range launch (K2, or K3's row range) in one, so that its vmap
# rule folds a mapped x into one gather and one launch for every member.
@torch.library.custom_op(
    "deepsphere_weather_torch::spmm_rows", mutates_args=(),
    schema="(Tensor a, Tensor idx, Tensor x_local, Tensor nz, "
           "bool super_layout, int group, int v0, int v1, int r0, "
           "int full_rows) -> Tensor")
def spmm_rows(a, idx, x_local, nz, super_layout, group, v0, v1, r0,
              full_rows):
    """Rows [v0, v1) of A @ x from this rank's rows of x: x gathered over
    the registered node group `group` (`parallel.collectives.group_key`),
    then `_run_rows` on the shard's layout."""
    x_full = gather_rows(x_local, _groups[group], 0)
    layout = ("super" if super_layout else "plain", a, idx, nz, r0,
              full_rows)
    return _run_rows(layout, x_full, v0, v1).contiguous()


torch.library.register_vmap(spmm_rows, _fold_vmap(spmm_rows, 2))


# The ELL rows of a row shard as a registered op, as `spmm_rows` is for
# the block layouts: the node gather and the row-range launch in one.
@torch.library.custom_op(
    "deepsphere_weather_torch::spmm_rows_ell", mutates_args=(),
    schema="(Tensor vals, Tensor cols, Tensor loc, Tensor blocks, "
           "Tensor urows, Tensor x_local, int umax, int rmax, int group, "
           "int v0, int v1) -> Tensor")
def spmm_rows_ell(vals, cols, loc, blocks, urows, x_local, umax, rmax, group,
                  v0, v1):
    """Rows [v0, v1) of L @ x from this rank's rows of x, `vals` and
    `cols` those rows of the ELL layout and (loc, blocks, urows, umax,
    rmax) their union tables: x gathered over the registered node group
    `group`, then one `ell_spmm_rows` launch."""
    x_full = gather_rows(x_local, _groups[group], 0)
    return ell_spmm_rows(vals, cols, x_full, 0, v1 - v0,
                         EllTables(loc, blocks, urows, umax, rmax))


@spmm_rows_ell.register_fake
def _(vals, cols, loc, blocks, urows, x_local, umax, rmax, group, v0, v1):
    return x_local.new_empty((v1 - v0, x_local.shape[1]), dtype=torch.float32)


torch.library.register_vmap(spmm_rows_ell, _fold_vmap(spmm_rows_ell, 5))


class _RowShardMatVec(torch.autograd.Function):
    """y_local = (A @ x)[v0:v1] from x_local = x[v0:v1]: gather x over the
    node group, then the rank's row range (`spmm_rows`). Backward: the
    gradient of the global loss with respect to the rank's rows of x,
    (A^T @ g)[v0:v1], from the gathered g and the rows [v0, v1) of the
    transposed layout (the forward's own when A is symmetric), in the
    primal's dtype. Only all-gathers, in both directions; the operator
    arrays get no gradient. In torch.func's form (`setup_context`,
    `generate_vmap_rule`): vmap runs it through the op's rule, forward
    and backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x_local, op):
        return op.product(op.fwd, x_local)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op, ctx.x_dtype = inputs[1], inputs[0].dtype

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        op = ctx.op
        gx = op.product(op.transpose_layout(), g.to(ctx.x_dtype).contiguous())
        return gx.to(ctx.x_dtype), None


class ShardedBlockSparseOperator:
    """One node rank's rows [v0, v1) of a `BlockSparseOperator` of n rows;
    `matvec(x_local)`: [v1 - v0, M] -> [v1 - v0, M], with a gradient in
    x_local. The ranks of `group` must call `matvec` together, in the same
    order (each product is an all-gather), and their backwards likewise.
    `ell`, the shard of the operator's `EllOperator`, takes every x that
    is not bf16."""

    def __init__(self, n: int, v0: int, v1: int, group, fwd: _ShardLayout,
                 bwd: Optional[_ShardLayout] = None,
                 ell: Optional["ShardedBlockSparseOperator"] = None):
        self.n, self.v0, self.v1, self.group = int(n), int(v0), int(v1), group
        self.fwd, self.bwd, self.ell = fwd, bwd, ell

    def forward_layout(self) -> _ShardLayout:
        return self.fwd

    def transpose_layout(self) -> _ShardLayout:
        return self.fwd if self.bwd is None else self.bwd

    def product(self, layout: _ShardLayout,
                x_local: torch.Tensor) -> torch.Tensor:
        """Rows [v0, v1) of `layout`'s product from this rank's rows of x
        (`spmm_rows` or `spmm_rows_ell`: one gather, one row-range
        launch)."""
        kind, a, idx, nz, r0, full_rows = layout
        if kind == "ell":
            loc, blocks, urows, umax, rmax = nz
            return spmm_rows_ell(a, idx, loc, blocks, urows, x_local, umax,
                                 rmax, group_key(self.group), self.v0,
                                 self.v1)
        return spmm_rows(a, idx, x_local, nz, kind == "super",
                         group_key(self.group), self.v0, self.v1, r0,
                         full_rows)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """(L @ x)[v0:v1] from this rank's rows of x, with the padding and
        dtype rules of `BlockSparseOperator.matvec` (of
        `EllOperator.matvec` on an ELL shard)."""
        n, m = x.shape
        if n != self.v1 - self.v0:
            raise ValueError(f"x must hold this rank's {self.v1 - self.v0} "
                             f"rows, got {n}")
        if x.dtype != torch.bfloat16 and self.ell is not None:
            return self.ell.matvec(x)
        if self.fwd[0] == "ell":
            x_pad, out_dtype = _ell_x(x)
            return _RowShardMatVec.apply(x_pad, self)[:, :m].to(out_dtype)
        m_pad = ((m + 127) // 128) * 128
        if x.dtype != torch.bfloat16:
            x = x.float()
        x_pad = F.pad(x, (0, m_pad - m)).contiguous()
        return _RowShardMatVec.apply(x_pad, self)[:, :m]
