"""Alternative architectures: ResNetSpherical, EPDNetSpherical,
ConvNetSpherical, DownscalingNetSpherical.

Port of `deepsphere_weather_tpu/models/variants.py` as `nn.Module`s with the
JAX params tree's block names and shapes:

- ResNetSpherical: 4 ResBlocks (each 4 x 128 convolutions back to the
  input channels), 4 ConvBlocks at 128 features, a final convolution;
- EPDNetSpherical: encode (2 convolutions to 128), process (4 ResBlocks at
  128), decode (1 convolution), a final convolution;
- ConvNetSpherical: 6 stacked ConvBlocks at 128 features, a final
  convolution;
- DownscalingNetSpherical: coarse-sampling input, convolutions on the
  coarse graph, the conservative 'interp' unpool to the fine sampling
  ('avg' for image convolutions), a ResBlock and a final convolution on
  the fine graph. `sampling_kwargs` is the fine (output) sampling; the
  input is its `kernel_size_pooling`-fold coarsening.

All share UNetSpherical's [B, T, V, F] contract and its boundary casts
(`SphericalModel`). The final convolution has no normalization and no
activation. `get_model` passes every model setting on; a variant ignores
those it does not use (pool_method, increment_learning, ...).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .._device import resolve_device
from .geometry import build_model_geometry
from .layers import ConvBlock, ResBlock
from .unet import SphericalModel

__all__ = ["ResNetSpherical", "EPDNetSpherical", "ConvNetSpherical",
           "DownscalingNetSpherical"]

N_FEAT = 128


class _VariantBase(SphericalModel):
    """Sizes, geometry and ConvBlock options of a variant; `BLOCKS` lists
    its blocks in the order the forward runs them."""

    def __init__(self, tensor_info: Dict, sampling: str, sampling_kwargs: Dict,
                 depth: int, kernel_size_conv: int = 3,
                 conv_type: str = "graph", graph_type: str = "knn",
                 knn: int = 20, periodic_padding: bool = True,
                 bias: bool = True, batch_norm=False,
                 batch_norm_before_activation: bool = False,
                 activation: bool = True, activation_fun: str = "relu",
                 kernel_size_pooling: int = 4,
                 dense_threshold: Optional[int] = None,
                 numeric_precision: str = "float32", device="cuda",
                 generator: Optional[torch.Generator] = None, **_ignored):
        super().__init__()
        self._device = resolve_device(device)
        self._generator = generator
        self._set_sizes(tensor_info, numeric_precision)
        self.increment_learning = False
        self.geometry = build_model_geometry(
            sampling=sampling, sampling_kwargs=dict(sampling_kwargs),
            depth=depth, knn=knn, graph_type=graph_type, conv_type=conv_type,
            pool_method="interp" if conv_type == "graph" else "avg",
            kernel_size_pooling=kernel_size_pooling,
            dense_threshold=dense_threshold,
            operator_dtype=self._operator_dtype(), device=self._device)
        self.convblock_kwargs = dict(
            kernel_size=kernel_size_conv, conv_type=self.geometry.conv_type,
            bias=bias, batch_norm=batch_norm,
            batch_norm_before_activation=batch_norm_before_activation,
            activation=activation, activation_fun=activation_fun,
            periodic_padding=periodic_padding)

    def _conv(self, cin, cout, level=0, final=False):
        kw = self._level_kwargs(self.convblock_kwargs, level)
        if final:
            kw.update(batch_norm=False, activation=False)
        return ConvBlock(cin, cout, self.geometry.cheb_ops[level],
                         device=self._device, generator=self._generator, **kw)

    def _res(self, cin, couts, level=0):
        return ResBlock(cin, couts, self.geometry.cheb_ops[level],
                        self._level_kwargs(self.convblock_kwargs, level),
                        device=self._device, generator=self._generator)


class _SingleLevelModel(_VariantBase):
    """A stack of blocks on one level: [B, T, V, F] -> [B, T_out, V, F_out]."""

    def __init__(self, tensor_info, sampling, sampling_kwargs, **kwargs):
        super().__init__(tensor_info, sampling, sampling_kwargs, depth=1,
                         **kwargs)

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        n_node = self.geometry.n_nodes[0]
        op = self.geometry.cheb_ops[0]
        h = self._to_nodes(x, n_node)
        for name in self.BLOCKS:
            h = getattr(self, name)(h, cheb_op=op,
                                    **self._nkw(name, train, stats_out))
        return self._from_nodes(h, n_node)


class ResNetSpherical(_SingleLevelModel):
    """4 ResBlocks + 4 ConvBlocks + final convolution."""

    BLOCKS = ("resblock1", "resblock2", "resblock3", "resblock4",
              "conv1", "conv2", "conv3", "conv4", "conv_final")

    def __init__(self, tensor_info, sampling, sampling_kwargs, **kwargs):
        super().__init__(tensor_info, sampling, sampling_kwargs, **kwargs)
        res_shape = [N_FEAT] * 4 + [self.input_channels]
        for i in range(1, 5):
            setattr(self, f"resblock{i}",
                    self._res(self.input_channels, res_shape))
        self.conv1 = self._conv(self.input_channels, N_FEAT)
        for i in range(2, 5):
            setattr(self, f"conv{i}", self._conv(N_FEAT, N_FEAT))
        self.conv_final = self._conv(N_FEAT, self.output_channels, final=True)


class EPDNetSpherical(_SingleLevelModel):
    """Encode-process-decode."""

    BLOCKS = ("enc_conv1", "enc_conv2", "resblock1", "resblock2",
              "resblock3", "resblock4", "dec_conv1", "conv_final")

    def __init__(self, tensor_info, sampling, sampling_kwargs, **kwargs):
        super().__init__(tensor_info, sampling, sampling_kwargs, **kwargs)
        self.enc_conv1 = self._conv(self.input_channels, N_FEAT)
        self.enc_conv2 = self._conv(N_FEAT, N_FEAT)
        for i in range(1, 5):
            setattr(self, f"resblock{i}", self._res(N_FEAT, [N_FEAT] * 3))
        self.dec_conv1 = self._conv(N_FEAT, N_FEAT)
        self.conv_final = self._conv(N_FEAT, self.output_channels, final=True)


class ConvNetSpherical(_SingleLevelModel):
    """6 stacked ConvBlocks + final convolution."""

    BLOCKS = tuple(f"conv{i}" for i in range(1, 7)) + ("conv_final",)

    def __init__(self, tensor_info, sampling, sampling_kwargs, **kwargs):
        super().__init__(tensor_info, sampling, sampling_kwargs, **kwargs)
        cin = self.input_channels
        for i in range(1, 7):
            setattr(self, f"conv{i}", self._conv(cin, N_FEAT))
            cin = N_FEAT
        self.conv_final = self._conv(N_FEAT, self.output_channels, final=True)


class DownscalingNetSpherical(_VariantBase):
    """Decode-only downscaler: coarse-sampling input -> fine-sampling
    output (forward = decode). tensor_info's input nodes must be the
    coarse sampling's, its output nodes the fine one's."""

    BLOCKS = ("conv_coarse1", "conv_coarse2", "res_fine", "conv_final")

    def __init__(self, tensor_info, sampling, sampling_kwargs, **kwargs):
        # depth-2 pyramid over the fine sampling: level 0 fine (output),
        # level 1 coarse (input); unpools[0] maps coarse -> fine
        super().__init__(tensor_info, sampling, sampling_kwargs, depth=2,
                         **kwargs)
        n = self.geometry.n_nodes
        if n[1] != self.input_n_node or n[0] != self.output_n_node:
            raise ValueError(f"coarse/fine sampling nodes {n[1]}/{n[0]} != "
                             f"tensor_info input/output nodes "
                             f"{self.input_n_node}/{self.output_n_node}")
        self.conv_coarse1 = self._conv(self.input_channels, N_FEAT, level=1)
        self.conv_coarse2 = self._conv(N_FEAT, N_FEAT, level=1)
        self.res_fine = self._res(N_FEAT, (N_FEAT, N_FEAT))
        self.conv_final = self._conv(N_FEAT, self.output_channels, final=True)

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        ops = self.geometry.cheb_ops

        def nkw(name):
            return self._nkw(name, train, stats_out)
        h = self._to_nodes(x, self.geometry.n_nodes[1])
        h = self.conv_coarse1(h, cheb_op=ops[1], **nkw("conv_coarse1"))
        h = self.conv_coarse2(h, cheb_op=ops[1], **nkw("conv_coarse2"))
        h = self.geometry.unpools[0](h, None)
        h = self.res_fine(h, cheb_op=ops[0], **nkw("res_fine"))
        h = self.conv_final(h, cheb_op=ops[0], **nkw("conv_final"))
        return self._from_nodes(h, self.geometry.n_nodes[0])
