"""Chebyshev graph convolution.

Port of `deepsphere_weather_tpu/ops/cheb.py`: the same three evaluation
branches, the same weight layout [Fin, K, Fout] and the same points where
values are cast to the compute dtype (bf16 parity depends on them). Every
contraction the JAX code runs with `preferred_element_type=float32` runs
here on fp32-widened operands and is cast back to the compute dtype.

Operators: a dense [V, V] Laplacian, the block-sparse
`BlockSparseOperator` (its CUDA kernels on the card), or the ELL
`EllOperator` (JAX's `ell_matvec`; on the card the ELL kernel, which also
runs every fp32 product of a block-sparse operator).
`ChebOperator.row_shard` gives one node rank's rows of any of them
(node-parallel training): every product then gathers its input over the
node group first.

`ell_matvec`, `cheb_basis_dense` and `cheb_basis_ell` are the JAX
module's functional forms: one product of ELL arrays, and the stacked
Chebyshev basis [K, V, M] of x [V, M] over a dense or an ELL Laplacian.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from .._device import resolve_device
from ..parallel.collectives import all_gather_op, group_key
from ..utils.tracing import span
from .bcsr import BlockSparseOperator, EllOperator

__all__ = ["ChebOperator", "cheb_basis_dense", "cheb_basis_ell", "cheb_conv",
           "ell_matvec"]


class _RowShardDense(torch.autograd.Function):
    """The rank's rows of (L @ h.float()).to(out_dtype) along the node axis
    (-2) of h: gather h over the node group, then multiply by the rank's
    rows of L (`a` [V_local, V] fp32, cast as the caller casts L).
    Backward: the rank's rows of L^T @ g, from the gathered g and `a_t`
    (the rank's rows of L^T), in h's dtype: the block-sparse shard's rule.
    In torch.func's form: under vmap each gather is one for every member
    (`all_gather_op`'s rule)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, a, a_t, group, out_dtype):
        h_full = all_gather_op(h, group, h.dim() - 2)
        return (a @ h_full.float()).to(out_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, _, a_t, ctx.group, _ = inputs
        ctx.h_dtype = h.dtype
        ctx.save_for_backward(a_t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (a_t,) = ctx.saved_tensors
        g_full = all_gather_op(g.contiguous(), ctx.group, g.dim() - 2)
        gh = (a_t @ g_full.float()).to(ctx.h_dtype)
        return gh, None, None, None, None


class ChebOperator:
    """Prepared Laplacian of one graph level: dense [V, V], block-sparse or
    ELL.

    `matvec(X)` computes L @ X for X [V, M]. A row shard (`row_shard`)
    holds one node rank's rows: `dense` [V_local, V] with `dense_t` the
    same rows of L^T, or a `ShardedBlockSparseOperator` (as `bcsr` or
    `ell`); its products take and give the rank's rows."""

    def __init__(self, dense: Optional[torch.Tensor] = None,
                 bcsr: Optional[BlockSparseOperator] = None,
                 dense_t: Optional[torch.Tensor] = None, group=None,
                 ell: Optional[EllOperator] = None):
        if sum(o is not None for o in (dense, bcsr, ell)) != 1:
            raise ValueError("provide exactly one of dense / bcsr / ell")
        if (dense_t is None) != (group is None):
            raise ValueError("a dense row shard needs both dense_t and a "
                             "group")
        self.dense = dense
        self.bcsr = bcsr
        self.ell = ell
        self.dense_t = dense_t
        self.group = group

    def row_shard(self, v0: int, v1: int, group) -> "ChebOperator":
        """This operator's rows [v0, v1) for one rank of the node process
        group `group` (ranks hold consecutive equal node ranges in rank
        order)."""
        if self.bcsr is not None:
            return ChebOperator(bcsr=self.bcsr.row_shard(v0, v1, group))
        if self.ell is not None:
            return ChebOperator(ell=self.ell.row_shard(v0, v1, group))
        return ChebOperator(dense=self.dense[v0:v1].contiguous(),
                            dense_t=self.dense.T[v0:v1].contiguous(),
                            group=group)

    def batched_matvec(self, cdt: torch.dtype) -> Callable:
        """h [B, V, F] -> L @ h along V, for a dense operator, as the
        batch-major branches of `cheb_conv` compute it: L cast to `cdt`
        once, fp32 products, the output cast to `cdt`."""
        a = self.dense.to(cdt).float()
        if self.group is None:
            return lambda h: (a @ h.float()).to(cdt)
        a_t = self.dense_t.to(cdt).float()
        key = group_key(self.group)
        return lambda h: _RowShardDense.apply(h, a, a_t, key, cdt)

    @classmethod
    def from_graph(cls, graph, mode: str, dtype=torch.float32, device="cuda"):
        """mode 'dense' keeps the [V, V] Laplacian; 'bcsr' stores it
        block-sparse in `dtype`; 'ell' holds its ELL arrays (those of
        `graph.laplacian_ell()`), the values rounded to `dtype`. Which
        levels take which is `build_model_geometry`'s rule."""
        device = resolve_device(device)
        if mode == "dense":
            return cls(dense=torch.as_tensor(graph.laplacian_dense(),
                                             device=device))
        if mode == "bcsr":
            return cls(bcsr=BlockSparseOperator.from_scipy(
                graph.L, symmetric=graph.is_symmetric, dtype=dtype,
                device=device))
        if mode == "ell":
            return cls(ell=EllOperator.from_scipy(
                graph.L, symmetric=graph.is_symmetric, dtype=dtype,
                device=device))
        raise ValueError(f"unknown ChebOperator mode {mode!r}; expected "
                         "'dense', 'bcsr' or 'ell'")

    @property
    def n_nodes(self) -> int:
        """The graph level's node count (a row shard's too: the whole
        level's)."""
        if self.bcsr is not None:
            return self.bcsr.n
        if self.ell is not None:
            return self.ell.n
        return self.dense.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x for x of shape [V, M] (a row shard: its rows of both)."""
        if self.bcsr is not None:
            return self.bcsr.matvec(x)
        if self.ell is not None:
            return self.ell.matvec(x)
        if self.group is None:
            return (self.dense.float() @ x.float()).to(x.dtype)
        return _RowShardDense.apply(x, self.dense.float(),
                                    self.dense_t.float(),
                                    group_key(self.group), x.dtype)


def _transposed_ell(cols: torch.Tensor, vals: torch.Tensor):
    """The ELL arrays (cols_t int32, vals_t fp32) of L^T for L in ELL,
    built on L's device: each row's nonzeros in CSR order, padded with
    column 0 and value 0 (`laplacian_to_ell` of the transposed matrix;
    zero values drop out as its scipy build eliminates them)."""
    n, width = cols.shape
    keep = (vals != 0).reshape(-1)
    rows = torch.arange(n, device=cols.device).repeat_interleave(width)[keep]
    c = cols.reshape(-1).long()[keep]
    v = vals.reshape(-1)[keep]
    order = torch.argsort(c * n + rows)
    c, rows, v = c[order], rows[order], v[order]
    deg = torch.bincount(c, minlength=n)
    width_t = int(deg.max()) if c.numel() else 0
    offs = torch.arange(c.numel(), device=c.device) - (deg.cumsum(0) - deg)[c]
    cols_t = torch.zeros((n, width_t), dtype=torch.int32, device=cols.device)
    vals_t = torch.zeros((n, width_t), dtype=torch.float32, device=cols.device)
    cols_t[c, offs] = rows.to(torch.int32)
    vals_t[c, offs] = v
    return cols_t, vals_t


class _EllArrays:
    """L in ELL at one call site of `ell_matvec` or `cheb_basis_ell`: its
    `EllOperator` (fp32 values, the kernel's type), and L^T's, built once,
    at the first backward that needs a gradient in x."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor):
        self.cols = cols.to(torch.int32).contiguous()
        self.vals = vals.detach().float().contiguous()
        self.op = EllOperator(self.cols.shape[0], self.vals, self.cols)
        self._op_t = None

    def transposed(self) -> EllOperator:
        if self._op_t is None:
            cols_t, vals_t = _transposed_ell(self.cols, self.vals)
            self._op_t = EllOperator(self.cols.shape[0], vals_t, cols_t)
        return self._op_t


class _EllMatVec(torch.autograd.Function):
    """L @ x over `_EllArrays` (the JAX `ell_matvec`, differentiable in x
    and in vals). Forward and the gradient in x (L^T g) run the ELL
    product (the kernel on the card); the gradient in vals,
    dvals[v, w] = sum_m g[v, m] x[cols[v, w], m], is a gather and a
    row-wise dot. The result is fp32 unless x and vals are both bf16 (the
    JAX promotion)."""

    @staticmethod
    def forward(x, vals, arrays):
        y = arrays.op.matvec(x.float())
        if x.dtype == vals.dtype == torch.bfloat16:
            return y.to(torch.bfloat16)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, vals, ctx.arrays = inputs
        ctx.x_dtype, ctx.vals_dtype = x.dtype, vals.dtype
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gx = gvals = None
        if ctx.needs_input_grad[0]:
            gx = ctx.arrays.transposed().matvec(g.float()).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            gathered = x.float()[ctx.arrays.cols.long()]      # [V, W, M]
            gvals = torch.einsum("vwm,vm->vw", gathered,
                                 g.float()).to(ctx.vals_dtype)
        return gx, gvals, None


def ell_matvec(cols: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """L @ x for L in ELL: cols [V, W] int, vals [V, W], x [V, M] ->
    [V, M] (the JAX `ell_matvec`, sum_w vals[v, w] * x[cols[v, w]]).

    The product runs `EllOperator.matvec`: the ELL kernel on the card, its
    plain version on the CPU, in fp32; the result is fp32 unless x and
    vals are both bf16, as JAX promotes them. Gradients reach x (through
    L^T's layout, built on L's device at the first backward) and vals."""
    return _EllMatVec.apply(x, vals, _EllArrays(cols, vals))


def cheb_basis_dense(L: torch.Tensor, x: torch.Tensor, K: int
                     ) -> torch.Tensor:
    """Chebyshev basis [K, V, M] of x [V, M] over a dense L [V, V]: fp32
    products, each term in x's dtype."""
    a = L.float()

    def mv(h):
        return (a @ h.float()).to(x.dtype)
    return _basis(mv, x, K)


def cheb_basis_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                   K: int) -> torch.Tensor:
    """Chebyshev basis [K, V, M] of x [V, M] over L in ELL: `ell_matvec`
    of its arrays, whose operators (L's, and L^T's for the backward) are
    built once for all K - 1 products."""
    arrays = _EllArrays(cols, vals)
    return _basis(lambda h: _EllMatVec.apply(h, vals, arrays), x, K)


def _basis(mv: Callable, x: torch.Tensor, K: int) -> torch.Tensor:
    xs = [x]
    if K > 1:
        xs.append(mv(x))
    for _ in range(2, K):
        xs.append(2.0 * mv(xs[-1]) - xs[-2])
    return torch.stack(xs)


def cheb_conv(op: ChebOperator, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chebyshev graph convolution.

    x [B, V, Fin], weight [Fin, K, Fout], bias [Fout] or None -> [B, V, Fout],
    computed in x.dtype with fp32 accumulation."""
    with span("dsw.cheb_conv"):
        B, V, Fin = x.shape
        Fin_w, K, Fout = weight.shape
        if Fin != Fin_w:
            raise ValueError(f"input features {Fin} do not match weight "
                             f"in_channels {Fin_w}")
        # the channel mixes contract operands of the compute dtype (bf16 on
        # the tensor cores) with fp32 accumulation, rounded once to cdt
        cdt = x.dtype
        w = weight.to(cdt)

        # sparse operators consume [V, B*F]: run the recurrence node-major with
        # one layout transpose at entry and exit
        node_major = op.dense is None
        if not node_major:
            mv = op.batched_matvec(cdt)              # [B, V, F] -> [B, V, F]
        else:
            def mv(h):  # node-major [V, B, F]
                V_, B_, F_ = h.shape
                out = op.matvec(h.reshape(V_, B_ * F_))
                return out.reshape(V_, B_, F_).to(cdt)

        if node_major:
            x = x.permute(1, 0, 2).contiguous()              # [V, B, Fin]

        if Fout < Fin and K > 1:
            # output side (Clenshaw): mix channels first, then run the matvecs
            # on the narrow Fout-wide tensors:
            #   b_k = z_k + 2 L b_{k+1} - b_{k+2},  out = z_0 + L b_1 - b_2
            z = torch.einsum(
                "vbf,fko->kvbo" if node_major else "bvf,fko->kbvo", x, w)
            b1 = z[K - 1]
            b2 = torch.zeros_like(b1)
            for k in range(K - 2, 0, -1):
                b1, b2 = z[k] + 2.0 * mv(b1) - b2, b1
            out = z[0] + mv(b1) - b2
        elif node_major:
            # input side, node-major: stack the basis, mix in one contraction
            out = torch.einsum("kvbf,fko->vbo", _basis(mv, x, K), w)
        else:
            # input side, batch-major (dense): mix each basis term as it
            # comes, the terms' mixes added in fp32 before the one rounding
            w32 = w.float()
            x0 = x
            out = torch.einsum("bvf,fo->bvo", x0.float(), w32[:, 0])
            if K > 1:
                x1 = mv(x0)
                out = out + torch.einsum("bvf,fo->bvo", x1.float(), w32[:, 1])
            for k in range(2, K):
                x2 = 2.0 * mv(x1) - x0
                out = out + torch.einsum("bvf,fo->bvo", x2.float(), w32[:, k])
                x0, x1 = x1, x2
        out = out.to(cdt)
        if node_major:
            out = out.permute(1, 0, 2)                       # [B, V, Fout]
        if bias is not None:
            out = out + bias.to(cdt)
        return out
