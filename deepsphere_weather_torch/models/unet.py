"""UNetSpherical — the flagship architecture.

Port of `deepsphere_weather_tpu/models/unet.py` as an `nn.Module`: the same
channel plan, stack/sum/avg/none skip connections, ReZero residual blocks,
increment learning, and the same boundary casts (inputs to the compute
dtype on entry, outputs to fp32 before the increment). Parameters stay
fp32; `numeric_precision='bfloat16'` (or 'float16') computes in bf16. The
learned pools' logits are parameters `pool{lvl}` / `unpool{lvl}`, as in
the JAX params tree, passed to the pools as `w`. `SphericalModel` holds
what every architecture shares (`models/variants.py`).
Node-parallel training builds the model whole and then sets
`model.geometry = shard_geometry(model.geometry, mesh)`: the forward then
takes and gives the rank's node shard.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..ops.pool import GeneralLearnPool, GeneralLearnUnpool
from ..sphere.samplings import check_skip_connection
from .geometry import ModelGeometry, build_model_geometry
from .layers import ResBlock, block_has_batch_norm

__all__ = ["SphericalModel", "UNetSpherical"]

_COMPUTE_DTYPES = {
    "float32": torch.float32, "float64": torch.float32,
    "bfloat16": torch.bfloat16, "float16": torch.bfloat16,
}


class SphericalModel(nn.Module):
    """What the architectures share: the tensor_info sizes, the compute
    dtype, the [B, T, V, F] <-> [B, V, T*F] boundary casts, the running
    statistics of 'batch' normalization over the blocks named in
    `BLOCKS`, and the ConvBlock options of a geometry level."""

    BLOCKS: tuple = ()

    def _set_sizes(self, tensor_info: Dict, numeric_precision: str):
        self.input_n_feature = tensor_info["input_n_feature"]
        self.output_n_feature = tensor_info["output_n_feature"]
        self.input_n_time = tensor_info["input_n_time"]
        self.output_n_time = tensor_info["output_n_time"]
        self.input_n_node = tensor_info["input_shape_info"]["dynamic"]["node"]
        self.output_n_node = tensor_info["output_shape_info"]["dynamic"]["node"]
        self.input_channels = self.input_n_feature * self.input_n_time
        self.output_channels = self.output_n_feature * self.output_n_time
        self.compute_dtype = _COMPUTE_DTYPES[str(numeric_precision)]
        if self.compute_dtype == torch.bfloat16:
            # bf16 channel mixes accumulate in fp32 end to end: cuBLAS may
            # otherwise add the split-K partials of a long contraction (a
            # weight's gradient sums over batch x nodes) in bf16
            matmul = torch.backends.cuda.matmul
            matmul.allow_bf16_reduced_precision_reduction = False

    def _operator_dtype(self):
        # bf16 models store the block-sparse Laplacian in bf16
        return (torch.bfloat16 if self.compute_dtype == torch.bfloat16
                else None)

    def _level_kwargs(self, convblock_kwargs: Dict, level: int) -> Dict:
        """ConvBlock options at a geometry level: an image convolution
        needs the level's grid."""
        kw = dict(convblock_kwargs)
        if self.geometry.conv_type == "image":
            samp_kw = self.geometry.samplings[level].kwargs_dict
            kw["nlat"], kw["nlon"] = samp_kw["nlat"], samp_kw["nlon"]
        return kw

    def _to_nodes(self, x: torch.Tensor, n_node: int) -> torch.Tensor:
        """[B, T, V, F] -> [B, V, T*F] (time-major flatten), compute dtype."""
        return x.permute(0, 2, 1, 3).reshape(
            x.shape[0], n_node, self.input_channels).to(self.compute_dtype)

    def _from_nodes(self, h: torch.Tensor, n_node: int) -> torch.Tensor:
        """[B, V, T*F] -> [B, T_out, V, F_out], fp32 at the model boundary."""
        return h.float().reshape(h.shape[0], n_node, self.output_n_time,
                                 self.output_n_feature).permute(0, 2, 1, 3)

    def _nkw(self, name: str, train: bool, stats_out: Optional[dict]):
        sub = (stats_out.setdefault(name, {})
               if stats_out is not None
               and block_has_batch_norm(getattr(self, name)) else None)
        return {"train": train, "stats_out": sub}

    @property
    def has_batch_norm(self) -> bool:
        """True when the model uses 'batch' normalization: eval-mode passes
        then read its running statistics (`norm_state`)."""
        return any(block_has_batch_norm(getattr(self, n)) for n in self.BLOCKS)

    def init_norm_state(self) -> Dict[str, torch.Tensor]:
        """Fresh running statistics (mean 0, var 1), keyed like the
        buffers (`conv1.convblock1.mean`, ...); empty without
        BatchNorm. `weights.norm_state_to_jax` gives the JAX nesting."""
        return {k: (torch.zeros_like(v) if k.endswith("mean")
                    else torch.ones_like(v))
                for k, v in self.named_buffers()}

    def norm_state(self) -> Dict[str, torch.Tensor]:
        """The running statistics, the buffers themselves (not copies)."""
        return dict(self.named_buffers())


class UNetSpherical(SphericalModel):
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
        periodic_padding: bool = True,
        bias: bool = True,
        batch_norm=False,
        batch_norm_before_activation: bool = False,
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
        self._set_sizes(tensor_info, numeric_precision)
        self.increment_learning = increment_learning

        if geometry is None:
            geometry = build_model_geometry(
                sampling=sampling, sampling_kwargs=dict(sampling_kwargs),
                depth=3, knn=knn, graph_type=graph_type, conv_type=conv_type,
                pool_method=pool_method,
                kernel_size_pooling=kernel_size_pooling,
                dense_threshold=dense_threshold,
                operator_dtype=self._operator_dtype(), device=device)
        self.geometry = geometry
        if geometry.n_nodes[0] != self.input_n_node:
            raise ValueError(f"sampling nodes {geometry.n_nodes[0]} != "
                             f"tensor_info node {self.input_n_node}")

        convblock_kwargs = dict(kernel_size=kernel_size_conv,
                                conv_type=geometry.conv_type, bias=bias,
                                batch_norm=batch_norm,
                                batch_norm_before_activation=(
                                    batch_norm_before_activation),
                                activation=activation,
                                activation_fun=activation_fun,
                                periodic_padding=periodic_padding)

        def res(level, cin, couts):
            return ResBlock(cin, couts, geometry.cheb_ops[level],
                            self._level_kwargs(convblock_kwargs, level),
                            device=device, generator=generator)

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
        # learned pools: trainable logits over the remap sparsity
        for lvl, (p, u) in enumerate(zip(geometry.pools, geometry.unpools)):
            if isinstance(p, GeneralLearnPool):
                setattr(self, f"pool{lvl}", nn.Parameter(p.init()))
            if isinstance(u, GeneralLearnUnpool):
                setattr(self, f"unpool{lvl}", nn.Parameter(u.init()))

    BLOCKS = ("conv1", "conv2", "conv3", "uconv2", "uconv1", "uconv1_final")

    def _pool(self, lvl, x):
        w = getattr(self, f"pool{lvl}", None)
        pool = self.geometry.pools[lvl]
        return pool(x) if w is None else pool(x, w=w)

    def _unpool(self, lvl, x, idx):
        w = getattr(self, f"unpool{lvl}", None)
        unpool = self.geometry.unpools[lvl]
        return unpool(x, idx) if w is None else unpool(x, idx, w=w)

    def _skip(self, h, enc):
        if self.skip_connection == "stack":
            return torch.cat((h, enc), dim=2)
        if self.skip_connection == "sum":
            return h + enc
        if self.skip_connection == "avg":
            return (h + enc) * 0.5
        return h

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        """With 'batch' normalization, `train=True` (the default, as in the
        JAX `apply`) normalizes with each batch's statistics and
        `train=False` with the running ones; a `stats_out` dict collects
        this call's batch statistics, nested like the JAX norm_state
        (`stats_out["conv1"]["convblock1"]["mean"]`)."""
        ops = self.geometry.cheb_ops

        def nkw(name):
            return self._nkw(name, train, stats_out)
        # the geometry's level-0 nodes: all of them, or a node shard's
        # (`shard_geometry`)
        n_node = self.geometry.n_nodes[0]
        # last timestep's dynamic features, for increment learning
        x_last = x[:, -1:, :, -self.output_n_feature:]
        h = self._to_nodes(x, n_node)

        x_enc1 = self.conv1(h, cheb_op=ops[0], **nkw("conv1"))
        x_enc2_ini, idx1 = self._pool(0, x_enc1)
        x_enc2 = self.conv2(x_enc2_ini, cheb_op=ops[1], **nkw("conv2"))
        x_enc3_ini, idx2 = self._pool(1, x_enc2)
        x_enc3 = self.conv3(x_enc3_ini, cheb_op=ops[2], **nkw("conv3"))

        h = self._skip(self._unpool(1, x_enc3, idx2), x_enc2)
        h = self.uconv2(h, cheb_op=ops[1], **nkw("uconv2"))
        h = self._skip(self._unpool(0, h, idx1), x_enc1)
        h = self.uconv1(h, cheb_op=ops[0], **nkw("uconv1"))
        h = self.uconv1_final(h, cheb_op=ops[0],
                              **nkw("uconv1_final"))

        h = self._from_nodes(h, n_node)
        if self.increment_learning:
            h = h * self.res_increment + x_last
        return h
