"""UNetSpherical (deepsphere-weather, modules/my_models_graph.py): three
levels of a nested sampling, ResBlocks of two ConvBlocks (the last one a
single ConvBlock), the configuration's pool between levels and stack
skips on the way up.

Parameter names and shapes follow the layer layout of the architecture:
`<block>.convblock<i>.weight` [Fin, K, Fout], `.bias` [Fout],
`<block>.rezero_weight` [1], `<block>.res_kernel` [Fin, Fout] and
`<block>.res_bias` [Fout] where a block changes the channel count, and
whatever the pool declares (`param_shapes`, `init`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import ChebNet

LEVELS = 3
POOL_RATIO = 4
# (name, level, input channels (None: the model's), ConvBlock outputs
# (None: the model's output channels)); stack skips give the decoder
# blocks their doubled inputs
BLOCKS = (
    ("conv1", 0, None, (64, 128)),
    ("conv2", 1, 128, (192, 256)),
    ("conv3", 2, 256, (512, 256)),
    ("uconv2", 1, 512, (256, 128)),
    ("uconv1", 0, 256, (128, 64)),
    ("uconv1_final", 0, 64, None),
)


def _blocks(in_channels: int, out_channels: int):
    for name, lvl, cin, couts in BLOCKS:
        yield (name, lvl, in_channels if cin is None else cin,
               (out_channels,) if couts is None else couts)


def layers(in_channels: int, out_channels: int
           ) -> Tuple[List[Tuple[int, int, int]], List[Tuple[int, int, int]]]:
    """(ConvBlocks, projections), each (level, c_in, c_out)."""
    convs, projs = [], []
    for _, lvl, cin, couts in _blocks(in_channels, out_channels):
        c = cin
        for cout in couts:
            convs.append((lvl, c, cout))
            c = cout
        if cin != couts[-1]:
            projs.append((lvl, cin, couts[-1]))
    return convs, projs


def param_shapes(in_channels: int, out_channels: int, K: int, pool,
                 nodes: int) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every parameter, in the architecture's order;
    `nodes` is the finest level's."""
    shapes = {}
    for name, _, cin, couts in _blocks(in_channels, out_channels):
        c = cin
        for i, cout in enumerate(couts):
            shapes[f"{name}.convblock{i + 1}.weight"] = (c, K, cout)
            shapes[f"{name}.convblock{i + 1}.bias"] = (cout,)
            c = cout
        shapes[f"{name}.rezero_weight"] = (1,)
        if cin != couts[-1]:
            shapes[f"{name}.res_kernel"] = (cin, couts[-1])
            shapes[f"{name}.res_bias"] = (couts[-1],)
    if hasattr(pool, "param_shapes"):
        shapes.update(pool.param_shapes(
            [nodes // POOL_RATIO ** lvl for lvl in range(LEVELS)]))
    return shapes


def draw(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device,
         rezero: float, pool) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw: Chebyshev weights He-scaled
    over c_in K (ReLU after all but a block's last ConvBlock), projections
    at the variance of the published U(-1/sqrt(c_in), 1/sqrt(c_in)),
    biases at 0.01, ReZero weights rezero (1 + 0.1 z); the pool's own
    by its `init`."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = z[at:at + n].view(shape)
        at += n
        block, _, leaf_name = name.rpartition(".")
        if not block:
            leaf = pool.init(name, leaf)
        elif leaf_name == "weight":
            owner, _, conv = block.rpartition(".")
            nxt = f"{owner}.convblock{int(conv[len('convblock'):]) + 1}.weight"
            gain = 2.0 if nxt in shapes else 1.0
            leaf = leaf * math.sqrt(gain / (shape[0] * shape[1]))
        elif leaf_name == "res_kernel":
            leaf = leaf / math.sqrt(3.0 * shape[0])
        elif leaf_name == "rezero_weight":
            leaf = rezero * (1.0 + 0.1 * leaf)
        else:
            leaf = 0.01 * leaf
        out[name] = leaf.contiguous()
    return out


class Net(ChebNet):
    """forward(params, x [B, T_in, V, F_in]) -> [B, 1, V, F_out]."""

    def __init__(self, laps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 K: int, out_features: int, pool, prec: str = "fp32"):
        super().__init__(laps, K, prec)
        self.out_features = out_features
        self.pool = pool

    def resblock(self, p, name, x, lvl):
        out, i = x, 1
        while f"{name}.convblock{i}.weight" in p:
            last = f"{name}.convblock{i + 1}.weight" not in p
            out = self.cheb(out, lvl, p[f"{name}.convblock{i}.weight"],
                            p[f"{name}.convblock{i}.bias"])
            if not last:
                out = F.relu(out)
            i += 1
        out = out * p[f"{name}.rezero_weight"]
        if f"{name}.res_kernel" in p:
            res = (torch.einsum("bvf,fo->bvo", self.q(x),
                                self.q(p[f"{name}.res_kernel"]))
                   + p[f"{name}.res_bias"])
        else:
            res = x
        return out + res

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor):
        B, T, V, Fin = x.shape
        h = x.permute(0, 2, 1, 3).reshape(B, V, T * Fin).float()
        e1 = self.resblock(p, "conv1", h, 0)
        h, i1 = self.pool.pool(e1, p, 0)
        e2 = self.resblock(p, "conv2", h, 1)
        h, i2 = self.pool.pool(e2, p, 1)
        h = self.resblock(p, "conv3", h, 2)
        h = torch.cat((self.pool.unpool(h, i2, p, 1), e2), dim=2)
        h = self.resblock(p, "uconv2", h, 1)
        h = torch.cat((self.pool.unpool(h, i1, p, 0), e1), dim=2)
        h = self.resblock(p, "uconv1", h, 0)
        h = self.resblock(p, "uconv1_final", h, 0)
        return h.reshape(B, V, 1, self.out_features).permute(0, 2, 1, 3)
