"""Equiangular image convolution with periodic longitude padding.

Port of `deepsphere_weather_tpu/ops/conv2d.py`: the equiangular sampling is
a regular lat/lon grid, so the node axis reshapes to (nlat, nlon) (rows
are latitude rings) and a 2D convolution applies, with zero padding along
latitude and circular padding along longitude. The convolution is
`torch.nn.functional.conv2d` on fp32-widened operands, cast back to the
activation dtype: one rounding of an fp32 sum, as the JAX convolution of
bf16 operands gives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["equiangular_conv2d", "equiangular_1d_to_2d", "equiangular_2d_to_1d"]


def equiangular_1d_to_2d(x: torch.Tensor, nlat: int, nlon: int) -> torch.Tensor:
    """[B, V, C] -> [B, nlat, nlon, C] (row-major latitude rings)."""
    B, V, C = x.shape
    if V != nlat * nlon:
        raise ValueError(f"V={V} != nlat*nlon={nlat * nlon}")
    return x.reshape(B, nlat, nlon, C)


def equiangular_2d_to_1d(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


def equiangular_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor], nlat: int, nlon: int,
                       periodic_padding: bool = True) -> torch.Tensor:
    """2D convolution on the equiangular grid.

    x: [B, V, Cin]; kernel: [kh, kw, Cin, Cout] (HWIO, the JAX layout);
    returns [B, V, Cout] in x's dtype."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    g = equiangular_1d_to_2d(x, nlat, nlon).permute(0, 3, 1, 2)    # NCHW
    pad_h = ((kh - 1) // 2, kh // 2)
    pad_w = ((kw - 1) // 2, kw // 2)
    if periodic_padding:
        g = torch.cat([g[..., nlon - pad_w[0]:], g, g[..., :pad_w[1]]],
                      dim=3)
        pad_w = (0, 0)
    g = F.pad(g.float(), (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
    w = kernel.to(x.dtype).float().permute(3, 2, 0, 1)             # OIHW
    out = F.conv2d(g, w).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)[:, None, None]
    return equiangular_2d_to_1d(out.permute(0, 2, 3, 1))
