"""Operations, bytes and peaks: the benchmark's own arithmetic.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): 67 TFLOP/s in fp32 without the tensor cores, 495 in TF32, 989 in
bf16; 3.35 TB/s of HBM3.

The model's operations follow the architecture, not any kernel's layout:
- the channel mix of every ConvBlock, 2 B V K c_in c_out;
- the residual projections, 2 B V c_in c_out;
- the Laplacian products, 2 nnz width (K - 1), where a Chebyshev
  convolution needs K - 1 products of the narrower of its two sides
  (input side: width B c_in; output side, Clenshaw: B c_out).
A backward counts twice its forward. Pools, elementwise work, the
optimizer and recomputation are not counted.

The least time of one Laplacian product is the larger of its byte bound
(each nonzero of L moved once, its value in the operator's type and a
4-byte column; x's rows read once; the output written once; at the HBM
rate) and its operation bound (2 nnz width at the peak of x's type).

The layers counted are the architecture's (`reference/arch/<name>.py`
`layers`): each ConvBlock and projection as (level, c_in, c_out).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
DTYPE_BYTES = {"fp32": 4, "bf16": 2}

Layer = Tuple[int, int, int]


def laplacian_products(convs: Sequence[Layer], batch: int, K: int
                       ) -> List[Tuple[int, int]]:
    """(level, width) of each Laplacian product of one forward."""
    return [(lvl, batch * min(cin, cout))
            for lvl, cin, cout in convs for _ in range(K - 1)]


def forward_flops(convs: Sequence[Layer], projs: Sequence[Layer], batch: int,
                  K: int, nodes: Sequence[int], nnz: Sequence[int]
                  ) -> Dict[str, float]:
    """Operations of one forward at `batch`: {'gemm', 'projection',
    'laplacian', 'total'}."""
    gemm = sum(2.0 * batch * nodes[lvl] * K * cin * cout
               for lvl, cin, cout in convs)
    proj = sum(2.0 * batch * nodes[lvl] * cin * cout
               for lvl, cin, cout in projs)
    lap = sum(2.0 * nnz[lvl] * width
              for lvl, width in laplacian_products(convs, batch, K))
    return {"gemm": gemm, "projection": proj, "laplacian": lap,
            "total": gemm + proj + lap}


def laplacian_least_s(nodes: int, nnz: int, width: int, op_dtype: str,
                      x_dtype: str) -> float:
    """Least seconds of one product L @ x, x [nodes, width] (module
    docstring)."""
    xb = DTYPE_BYTES[x_dtype]
    nbytes = nnz * (DTYPE_BYTES[op_dtype] + 4) + 2 * nodes * width * xb
    return max(nbytes / HBM_BYTES_PER_S, 2.0 * nnz * width / PEAK_FLOPS[x_dtype])
