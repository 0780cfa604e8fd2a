"""Chebyshev graph convolution.

Port of `deepsphere_weather_tpu/ops/cheb.py`: the same three evaluation
branches, the same weight layout [Fin, K, Fout] and the same points where
values are cast to the compute dtype (bf16 parity depends on them). Every
contraction the JAX code runs with `preferred_element_type=float32` runs
here on fp32-widened operands and is cast back to the compute dtype.

Operators: a dense [V, V] Laplacian, or the block-sparse
`BlockSparseOperator` (its CUDA kernel on the card). The ELL gather
operator is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from .bcsr import BlockSparseOperator

__all__ = ["ChebOperator", "cheb_conv"]


class ChebOperator:
    """Prepared Laplacian of one graph level: dense [V, V] or block-sparse.

    `matvec(X)` computes L @ X for X [V, M]."""

    def __init__(self, dense: Optional[torch.Tensor] = None,
                 bcsr: Optional[BlockSparseOperator] = None):
        if (dense is None) == (bcsr is None):
            raise ValueError("provide exactly one of dense / bcsr")
        self.dense = dense
        self.bcsr = bcsr

    @classmethod
    def from_graph(cls, graph, mode: str, dtype=torch.float32, device="cuda"):
        """mode 'dense' keeps the [V, V] Laplacian; 'bcsr' stores it
        block-sparse in `dtype`. Which levels take which is
        `build_model_geometry`'s rule."""
        device = resolve_device(device)
        if mode == "dense":
            return cls(dense=torch.as_tensor(graph.laplacian_dense(),
                                             device=device))
        if mode == "bcsr":
            return cls(bcsr=BlockSparseOperator.from_scipy(
                graph.L, symmetric=graph.is_symmetric, dtype=dtype,
                device=device))
        raise ValueError(f"unknown ChebOperator mode {mode!r}; expected "
                         "'dense' or 'bcsr' (ELL is not ported yet)")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x for x of shape [V, M]."""
        if self.dense is not None:
            return (self.dense.float() @ x.float()).to(x.dtype)
        return self.bcsr.matvec(x)


def cheb_conv(op: ChebOperator, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chebyshev graph convolution.

    x [B, V, Fin], weight [Fin, K, Fout], bias [Fout] or None -> [B, V, Fout],
    computed in x.dtype with fp32 accumulation."""
    B, V, Fin = x.shape
    Fin_w, K, Fout = weight.shape
    if Fin != Fin_w:
        raise ValueError(
            f"input features {Fin} do not match weight in_channels {Fin_w}")
    cdt = x.dtype
    w32 = weight.to(cdt).float()

    # sparse operators consume [V, B*F]: run the recurrence node-major with
    # one layout transpose at entry and exit
    node_major = op.dense is None
    if not node_major:
        dense32 = op.dense.to(cdt).float()

        def mv(h):  # [B, V, F] -> [B, V, F]
            return (dense32 @ h.float()).to(cdt)
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
        z = torch.einsum("vbf,fko->kvbo" if node_major else "bvf,fko->kbvo",
                         x.float(), w32).to(cdt)
        b1 = z[K - 1]
        b2 = torch.zeros_like(b1)
        for k in range(K - 2, 0, -1):
            b1, b2 = z[k] + 2.0 * mv(b1) - b2, b1
        out = z[0] + mv(b1) - b2
    elif node_major:
        # input side, node-major: stack the basis, mix in one contraction
        xs = [x]
        if K > 1:
            xs.append(mv(x))
        for _ in range(2, K):
            xs.append(2.0 * mv(xs[-1]) - xs[-2])
        out = torch.einsum("kvbf,fko->vbo", torch.stack(xs).float(), w32)
    else:
        # input side, batch-major (dense): mix each basis term as it comes
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
