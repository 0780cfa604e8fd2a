"""UNetSpherical — the flagship architecture.

Port of `deepsphere_weather_tpu/models/unet.py` as an `nn.Module`: the same
channel plan, stack/sum/avg/none skip connections, ReZero residual blocks,
increment learning, and the same boundary casts (inputs to the compute
dtype on entry, outputs to fp32 before the increment). Parameters stay
fp32; `numeric_precision='bfloat16'` (or 'float16') computes in bf16.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..sphere.samplings import check_skip_connection
from .geometry import ModelGeometry, build_model_geometry
from .layers import ResBlock

__all__ = ["UNetSpherical"]

_COMPUTE_DTYPES = {
    "float32": torch.float32, "float64": torch.float32,
    "bfloat16": torch.bfloat16, "float16": torch.bfloat16,
}


class UNetSpherical(nn.Module):
    """3-level spherical UNet: [B, T_in, V, F_in] -> [B, T_out, V, F_out]."""

    def __init__(
        self,
        tensor_info: Dict,
        sampling: str,
        sampling_kwargs: Dict,
        kernel_size_conv: int = 3,
        conv_type: str = "graph",
        graph_type: str = "knn",
        knn: int = 20,
        bias: bool = True,
        batch_norm: bool = False,
        activation: bool = True,
        activation_fun: str = "relu",
        pool_method: str = "max",
        kernel_size_pooling: int = 4,
        skip_connection: str = "stack",
        increment_learning: bool = False,
        numeric_precision: str = "float32",
        dense_threshold: Optional[int] = None,
        geometry: Optional[ModelGeometry] = None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.input_n_feature = tensor_info["input_n_feature"]
        self.output_n_feature = tensor_info["output_n_feature"]
        self.input_n_time = tensor_info["input_n_time"]
        self.output_n_time = tensor_info["output_n_time"]
        self.input_n_node = tensor_info["input_shape_info"]["dynamic"]["node"]
        self.output_n_node = tensor_info["output_shape_info"]["dynamic"]["node"]
        self.input_channels = self.input_n_feature * self.input_n_time
        self.output_channels = self.output_n_feature * self.output_n_time
        self.increment_learning = increment_learning
        self.compute_dtype = _COMPUTE_DTYPES[str(numeric_precision)]

        if geometry is None:
            geometry = build_model_geometry(
                sampling=sampling, sampling_kwargs=dict(sampling_kwargs),
                depth=3, knn=knn, graph_type=graph_type, conv_type=conv_type,
                pool_method=pool_method,
                kernel_size_pooling=kernel_size_pooling,
                dense_threshold=dense_threshold,
                # bf16 models store the block-sparse Laplacian in bf16
                operator_dtype=(torch.bfloat16
                                if self.compute_dtype == torch.bfloat16
                                else None),
                device=device)
        self.geometry = geometry
        if geometry.n_nodes[0] != self.input_n_node:
            raise ValueError(f"sampling nodes {geometry.n_nodes[0]} != "
                             f"tensor_info node {self.input_n_node}")

        convblock_kwargs = dict(kernel_size=kernel_size_conv,
                                conv_type=geometry.conv_type, bias=bias,
                                batch_norm=batch_norm, activation=activation,
                                activation_fun=activation_fun)

        def res(level, cin, couts):
            return ResBlock(cin, couts, geometry.cheb_ops[level],
                            convblock_kwargs, device=device,
                            generator=generator)

        self.skip_connection = check_skip_connection(skip_connection)
        mult = 2 if self.skip_connection == "stack" else 1
        self.conv1 = res(0, self.input_channels, (32 * 2, 64 * 2))
        self.conv2 = res(1, 64 * 2, (96 * 2, 128 * 2))
        self.conv3 = res(2, 128 * 2, (256 * 2, 128 * 2))
        self.uconv2 = res(1, 128 * 2 * mult, (128 * 2, 64 * 2))
        self.uconv1 = res(0, 64 * 2 * mult, (64 * 2, 32 * 2))
        self.uconv1_final = res(0, 32 * 2, self.output_channels)
        if increment_learning:
            self.res_increment = nn.Parameter(torch.zeros(1, device=device))

    def _skip(self, h, enc):
        if self.skip_connection == "stack":
            return torch.cat((h, enc), dim=2)
        if self.skip_connection == "sum":
            return h + enc
        if self.skip_connection == "avg":
            return (h + enc) * 0.5
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.geometry
        ops, pools, unpools = g.cheb_ops, g.pools, g.unpools
        B = x.shape[0]
        # last timestep's dynamic features, for increment learning
        x_last = x[:, -1:, :, -self.output_n_feature:]
        # [B, T, V, F] -> [B, V, T*F] (time-major flatten)
        h = x.permute(0, 2, 1, 3).reshape(
            B, self.input_n_node, self.input_channels).to(self.compute_dtype)

        x_enc1 = self.conv1(h, cheb_op=ops[0])
        x_enc2_ini, idx1 = pools[0](x_enc1)
        x_enc2 = self.conv2(x_enc2_ini, cheb_op=ops[1])
        x_enc3_ini, idx2 = pools[1](x_enc2)
        x_enc3 = self.conv3(x_enc3_ini, cheb_op=ops[2])

        h = self._skip(unpools[1](x_enc3, idx2), x_enc2)
        h = self.uconv2(h, cheb_op=ops[1])
        h = self._skip(unpools[0](h, idx1), x_enc1)
        h = self.uconv1(h, cheb_op=ops[0])
        h = self.uconv1_final(h, cheb_op=ops[0])

        # [B, V, T*F] -> [B, T_out, V, F_out], fp32 at the model boundary
        h = h.float().reshape(B, self.output_n_node, self.output_n_time,
                              self.output_n_feature).permute(0, 2, 1, 3)
        if self.increment_learning:
            h = h * self.res_increment + x_last
        return h
