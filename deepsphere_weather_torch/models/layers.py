"""Model building blocks: ConvBlock and ResBlock.

Port of `deepsphere_weather_tpu/models/layers.py` as `nn.Module`s, with the
same parameter names (`weight`, `bias`, `norm_scale`, `norm_bias`,
`rezero_weight`, `res_kernel`, `res_bias`) and shapes, the same activation
map and the same He/Glorot initialization table. `conv_type='graph'` is the
Chebyshev convolution over the level's Laplacian; `conv_type='image'` the
equiangular 2D convolution (`ops/conv2d.py`), its `weight` [kh, kw, Cin,
Cout] as in the JAX package.

Normalization (`batch_norm`) follows the JAX package's functional design,
not `nn.BatchNorm1d`'s in-place one:

- True / 'batch': BatchNorm over every leading axis (batch and node), in
  fp32 whatever the compute dtype, eps 1e-5. `train=True` (the default,
  as in the JAX `apply`) normalizes with the batch's biased statistics;
  `train=False` with the running statistics, the buffers `mean` and `var`
  (registered non-persistent: `state_dict()` stays the JAX params tree,
  and the running statistics are the JAX `norm_state`, saved apart).
  A forward never updates them: with a `stats_out` dict it only collects
  its batch mean and unbiased variance there, and the caller folds them
  in (`engine.step.fold_running_stats`, `prob.bn.bn_update`), outside any
  gradient or `torch.func.vmap`.
- On a node or data mesh the training-mode statistics are the global
  batch's: inside `batch_stats_over(groups)` (set by `engine.step`
  around each model call) the per-channel sum and then the centred sum
  of squares are each summed over those process groups
  (`parallel.all_reduce_sum`, whose backward sums the ranks' gradients),
  with n the global count, as GSPMD computes the JAX statistics over the
  sharded axes.
- 'layer' / 'layernorm': stateless normalization over the channels.
- False: none (every shipped configuration).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cheb import ChebOperator, cheb_conv
from ..ops.conv2d import equiangular_conv2d
from ..parallel.collectives import NodeShard, all_reduce_sum

__all__ = ["get_activation", "init_cheb_weight", "ConvBlock", "ResBlock",
           "block_has_batch_norm", "batch_stats_over"]

NORM_EPS = 1e-5

# (process group, ranks) pairs a training-mode BatchNorm sums its
# statistics over; empty on one process (`batch_stats_over`)
_STATS_GROUPS: Tuple = ()


@contextlib.contextmanager
def batch_stats_over(groups: Sequence):
    """Within this context, training-mode BatchNorm statistics are those of
    the global batch: summed over each (process group, number of ranks)
    pair of `groups` (module docstring)."""
    global _STATS_GROUPS
    prev, _STATS_GROUPS = _STATS_GROUPS, tuple(groups)
    try:
        yield
    finally:
        _STATS_GROUPS = prev


def _batch_stats(x32: torch.Tensor):
    """(mean, biased variance, n) per channel over every leading axis of
    x32 and, inside `batch_stats_over`, over the ranks of its groups: two
    passes, each one all-reduce a group."""
    dims = tuple(range(x32.dim() - 1))
    n = x32.numel() // x32.shape[-1]
    if not _STATS_GROUPS:
        return x32.mean(dim=dims), x32.var(dim=dims, unbiased=False), n
    s = x32.sum(dim=dims)
    for group, size in _STATS_GROUPS:
        s = all_reduce_sum(s, group)
        n *= size
    mean = s / n
    c = (x32 - mean).square().sum(dim=dims)
    for group, _ in _STATS_GROUPS:
        c = all_reduce_sum(c, group)
    return mean, c / n, n

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
    """Chebyshev conv -> [norm] -> activation -> [norm] (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int,
                 cheb_op: Optional[ChebOperator],
                 kernel_size: int = 3, conv_type: str = "graph",
                 bias: bool = True, batch_norm=False,
                 batch_norm_before_activation: bool = False,
                 activation: bool = True, activation_fun: str = "relu",
                 periodic_padding: bool = True,
                 nlat: Optional[int] = None, nlon: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if batch_norm is True or batch_norm == "batch":
            self.norm_kind: Optional[str] = "batch"
        elif batch_norm in ("layer", "layernorm"):
            self.norm_kind = "layer"
        elif not batch_norm:
            self.norm_kind = None
        else:
            raise ValueError(f"batch_norm must be bool, 'batch' or 'layer'; "
                             f"got {batch_norm!r}")
        if conv_type not in ("graph", "image"):
            raise ValueError("conv_type must be 'graph' or 'image'")
        if conv_type == "image" and (nlat is None or nlon is None):
            raise ValueError("conv_type='image' needs the grid's nlat and "
                             "nlon")
        if self.norm_kind:
            bias = False
        self.conv_type = conv_type
        self.cheb_op = cheb_op
        self.periodic_padding = periodic_padding
        self.nlat, self.nlon = nlat, nlon
        self.norm_before_act = batch_norm_before_activation
        self.act = activation
        self.act_fun = get_activation(activation_fun)
        act_for_init = activation_fun if activation else "linear"
        if conv_type == "graph":
            weight = init_cheb_weight(
                in_channels, out_channels, kernel_size,
                activation=act_for_init, device=device, generator=generator)
        else:
            # HWIO kernel, He-normal over its fan-in Cin * k^2
            std = math.sqrt(_he_scale(act_for_init)
                            / (in_channels * kernel_size ** 2))
            weight = std * torch.randn(
                (kernel_size, kernel_size, in_channels, out_channels),
                generator=generator, device=device)
        self.weight = nn.Parameter(weight)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)
        if self.norm_kind:
            self.norm_scale = nn.Parameter(torch.ones(out_channels,
                                                      device=device))
            self.norm_bias = nn.Parameter(torch.zeros(out_channels,
                                                      device=device))
        if self.norm_kind == "batch":
            # the JAX norm_state: mean 0, var 1 (torch BN's initial buffers)
            self.register_buffer("mean", torch.zeros(out_channels,
                                                     device=device),
                                 persistent=False)
            self.register_buffer("var", torch.ones(out_channels,
                                                   device=device),
                                 persistent=False)

    def _norm(self, x: torch.Tensor, train: bool,
              stats_out: Optional[dict]) -> torch.Tensor:
        # statistics in fp32 whatever the compute dtype
        x32 = x.float()
        if self.norm_kind == "layer":
            mean = x32.mean(dim=-1, keepdim=True)
            var = x32.var(dim=-1, unbiased=False, keepdim=True)
        elif train:
            # per channel over every leading (batch, node) axis, biased
            mean, var, n = _batch_stats(x32)
            if stats_out is not None:
                # the running update takes the unbiased variance
                stats_out["mean"] = mean.detach()
                stats_out["var"] = (var * (n / max(n - 1, 1))).detach()
        else:
            mean, var = self.mean, self.var
        xn = (x32 - mean) * torch.rsqrt(var + NORM_EPS)
        return (xn * self.norm_scale + self.norm_bias).to(x.dtype)

    def forward(self, x: torch.Tensor,
                cheb_op: Optional[ChebOperator] = None, train: bool = True,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        """`train` and `stats_out` only matter for 'batch' normalization
        (module docstring)."""
        if self.conv_type == "graph":
            x = cheb_conv(cheb_op if cheb_op is not None else self.cheb_op,
                          x, self.weight, self.bias)
        elif isinstance(cheb_op, NodeShard):
            # a node shard's image convolution: its windows cross the node
            # ranges, so it runs on the gathered grid
            x = cheb_op.local(equiangular_conv2d(
                cheb_op.gather(x), self.weight, self.bias, self.nlat,
                self.nlon, self.periodic_padding))
        else:
            x = equiangular_conv2d(x, self.weight, self.bias, self.nlat,
                                   self.nlon, self.periodic_padding)
        if self.norm_kind and self.norm_before_act:
            x = self._norm(x, train, stats_out)
        if self.act:
            x = self.act_fun(x)
        if self.norm_kind and not self.norm_before_act:
            x = self._norm(x, train, stats_out)
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
        last = getattr(self, f"convblock{self.n_blocks}")
        if last.norm_kind == "batch":
            # the last BN of each residual branch starts at zero scale and
            # bias, so the block starts as identity
            nn.init.zeros_(last.norm_scale)
            nn.init.zeros_(last.norm_bias)
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
                cheb_op: Optional[ChebOperator] = None, train: bool = True,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        """`stats_out` collects each 'batch' block's statistics under its
        name (`convblock1`, ...), as the JAX norm_state nests them."""
        out = x
        for i in range(self.n_blocks):
            name = f"convblock{i + 1}"
            blk = getattr(self, name)
            sub = (stats_out.setdefault(name, {})
                   if stats_out is not None and blk.norm_kind == "batch"
                   else None)
            out = blk(out, cheb_op=cheb_op, train=train, stats_out=sub)
        out = out * self.rezero_weight.to(out.dtype)
        if self.needs_projection:
            res = x @ self.res_kernel.to(x.dtype) + self.res_bias.to(x.dtype)
        else:
            res = x
        return out + res


def block_has_batch_norm(block) -> bool:
    """True when a ConvBlock, or any ConvBlock of a ResBlock, uses 'batch'
    normalization (and so has running statistics)."""
    if isinstance(block, ResBlock):
        return any(getattr(block, f"convblock{i + 1}").norm_kind == "batch"
                   for i in range(block.n_blocks))
    return block.norm_kind == "batch"
