"""Model building blocks: ConvBlock and ResBlock.

Port of `deepsphere_weather_tpu/models/layers.py` as `nn.Module`s, with the
same parameter names (`weight`, `bias`, `rezero_weight`, `res_kernel`,
`res_bias`) and shapes, the same activation map and the same He/Glorot
initialization table. Graph convolutions without normalization only,
which is what every shipped configuration uses: 'batch'/'layer' norm and
the equiangular image convolution raise `NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cheb import ChebOperator, cheb_conv

__all__ = ["get_activation", "init_cheb_weight", "ConvBlock", "ResBlock"]

_RELU_FAMILY = {
    "relu", "celu", "selu", "prelu", "hardswish", "mish", "silu", "swish",
    "gelu", "softplus", "softmax", "logsigmoid", "relu6", "rrelu", "rrlu",
    "leaky_relu", "elu",
}
_LINEAR_FAMILY = {
    "linear", "identity", "hardshrink", "sigmoid", "hardsigmoid", "tanh",
    "hardtanh", "softsign",
}

_RRELU_EVAL_SLOPE = (1 / 8 + 1 / 3) / 2

_ACT_MAP = {
    "relu": F.relu,
    "relu6": F.relu6,
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
    "logsigmoid": F.logsigmoid,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": F.hardsigmoid,
    "tanh": torch.tanh,
    "hardtanh": F.hardtanh,
    "softsign": F.softsign,
    "hardswish": F.hardswish,
    "softmax": lambda x: F.softmax(x, dim=-1),
    "hardshrink": lambda x: torch.where(x.abs() > 0.5, x, torch.zeros_like(x)),
    "prelu": lambda x: F.leaky_relu(x, negative_slope=0.25),
    "rrelu": lambda x: F.leaky_relu(x, negative_slope=_RRELU_EVAL_SLOPE),
    "rrlu": lambda x: F.leaky_relu(x, negative_slope=_RRELU_EVAL_SLOPE),
    "linear": lambda x: x,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable:
    key = name.lower()
    if key not in _ACT_MAP:
        raise ValueError(f"unknown activation_fun {name!r}")
    return _ACT_MAP[key]


def _he_scale(activation: str) -> float:
    key = activation.lower()
    if key in _RELU_FAMILY:
        return 2.0
    if key in _LINEAR_FAMILY:
        return 1.0
    raise ValueError(f"Unknown activation {activation!r} for init scale")


def init_cheb_weight(in_channels: int, out_channels: int, kernel_size: int,
                     activation: str = "relu", fan: str = "in",
                     distribution: str = "normal", device=None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """He/Glorot init of a [Fin, K, Fout] Chebyshev weight."""
    if fan == "in":
        fan_v = in_channels * kernel_size
    elif fan == "out":
        fan_v = out_channels * kernel_size
    elif fan == "avg":
        fan_v = (in_channels + out_channels) / 2 * kernel_size
    else:
        raise ValueError("unknown fan")
    scale = _he_scale(activation)
    shape = (in_channels, kernel_size, out_channels)
    if distribution == "normal":
        std = math.sqrt(scale / fan_v)
        return std * torch.randn(shape, generator=generator, device=device)
    if distribution == "uniform":
        limit = math.sqrt(3 * scale / fan_v)
        u = torch.rand(shape, generator=generator, device=device)
        return (2 * u - 1) * limit
    raise ValueError("unknown distribution")


class ConvBlock(nn.Module):
    """Chebyshev conv -> activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 cheb_op: Optional[ChebOperator],
                 kernel_size: int = 3, conv_type: str = "graph",
                 bias: bool = True, batch_norm=False,
                 activation: bool = True, activation_fun: str = "relu",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if batch_norm:
            raise NotImplementedError(
                "batch/layer normalization is not ported yet (ROADMAP Queue "
                "1 item 5)")
        if conv_type != "graph":
            raise NotImplementedError(
                "conv_type='image' (equiangular conv) is not ported yet")
        self.cheb_op = cheb_op
        self.act = activation
        self.act_fun = get_activation(activation_fun)
        self.weight = nn.Parameter(init_cheb_weight(
            in_channels, out_channels, kernel_size,
            activation=activation_fun if activation else "linear",
            device=device, generator=generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor,
                cheb_op: Optional[ChebOperator] = None) -> torch.Tensor:
        x = cheb_conv(cheb_op if cheb_op is not None else self.cheb_op,
                      x, self.weight, self.bias)
        if self.act:
            x = self.act_fun(x)
        return x


class ResBlock(nn.Module):
    """ConvBlocks + ReZero residual: the last ConvBlock has no activation;
    the residual is identity when channels match, else a linear
    projection; the branch is scaled by a zero-initialized weight."""

    def __init__(self, in_channels: int, out_channels, cheb_op,
                 convblock_kwargs: dict, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if isinstance(out_channels, int):
            out_channels = [out_channels]
        self.in_channels = in_channels
        self.out_channels = list(out_channels)
        self.n_blocks = len(self.out_channels)
        tmp_in = in_channels
        for i, tmp_out in enumerate(self.out_channels):
            kw = dict(convblock_kwargs)
            if i == self.n_blocks - 1:
                kw["activation"] = False
            self.add_module(f"convblock{i + 1}", ConvBlock(
                tmp_in, tmp_out, cheb_op, device=device, generator=generator,
                **kw))
            tmp_in = tmp_out
        self.rezero_weight = nn.Parameter(torch.zeros(1, device=device))
        self.needs_projection = in_channels != self.out_channels[-1]
        if self.needs_projection:
            # torch.nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
            limit = 1.0 / math.sqrt(in_channels)
            u = torch.rand((in_channels, self.out_channels[-1]),
                           generator=generator, device=device)
            self.res_kernel = nn.Parameter((2 * u - 1) * limit)
            self.res_bias = nn.Parameter(
                torch.zeros(self.out_channels[-1], device=device))

    def forward(self, x: torch.Tensor,
                cheb_op: Optional[ChebOperator] = None) -> torch.Tensor:
        out = x
        for i in range(self.n_blocks):
            out = getattr(self, f"convblock{i + 1}")(out, cheb_op=cheb_op)
        out = out * self.rezero_weight.to(out.dtype)
        if self.needs_projection:
            res = ((x.float() @ self.res_kernel.to(x.dtype).float()).to(x.dtype)
                   + self.res_bias.to(x.dtype))
        else:
            res = x
        return out + res
