"""Weight bridge between the JAX params pytree and the port's modules.

The JAX package keeps parameters in nested dicts (`conv1/convblock1/weight`,
`.../bias`, `conv1/rezero_weight`, `conv1/res_kernel`, `conv1/res_bias`,
`res_increment`); the port's `nn.Module`s use the same names and shapes,
so a path maps to a state-dict key by joining with dots. Both directions
carry numpy arrays on the JAX side and fp32 tensors on the port side.
`broadcast_params` gives every rank of a mesh rank 0's parameters, as the
JAX package replicates them over its mesh (`device_put` replicated).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .parallel.collectives import broadcast_

__all__ = ["params_from_jax", "params_to_jax", "seeded_params",
           "broadcast_params"]


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (JAX layout) -> port state dict (fp32, CPU);
    load it with `model.load_state_dict`."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + ".")
            else:
                out[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """Port state dict -> nested dict of fp32 numpy arrays (JAX layout),
    copies: a later in-place update of the parameters leaves them as they
    were, like the JAX package's immutable arrays."""
    tree: Dict = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def seeded_params(model: torch.nn.Module, seed: int) -> Dict:
    """Every parameter of `model` drawn from np.random.default_rng(seed),
    in the JAX layout.

    Unlike the init, nothing is zero: the ReZero weights, biases and the
    increment scale start at zero after init, which would multiply every
    convolution branch by 0 and hide it from a comparison. Weights use
    the He-normal scale of their fan-in; the ReZero weights and the
    increment scale are drawn from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(model.state_dict())

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("rezero_weight", "res_increment"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "weight":             # [Fin, K, Fout]
                std = np.sqrt(2.0 / (v.shape[0] * v.shape[1]))
                node[k] = (std * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "res_kernel":         # [Fin, Fout]
                lim = 1.0 / np.sqrt(v.shape[0])
                node[k] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            else:                           # biases
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    fill(tree)
    return tree


def broadcast_params(model: torch.nn.Module, mesh) -> None:
    """In place: rank 0's parameters of `model` on every rank of `mesh`,
    in one flat buffer: over each data group from its data rank 0, then
    over each node group from its node rank 0 (which then holds rank
    0's). Every rank of the mesh must call it."""
    if mesh is None:
        return
    params = [p.detach() for p in model.parameters()]
    flat = torch.cat([p.reshape(-1) for p in params])
    if mesh.n_data > 1:
        broadcast_(flat, mesh.rank_of(0, mesh.node_rank), mesh.data_group)
    if mesh.n_node > 1:
        broadcast_(flat, mesh.rank_of(mesh.data_rank, 0), mesh.node_group)
    for p, part in zip(params, flat.split([p.numel() for p in params])):
        p.copy_(part.view_as(p))
