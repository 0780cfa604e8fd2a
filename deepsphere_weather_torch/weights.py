"""Weight bridge between the JAX params pytree and the port's modules.

The JAX package keeps parameters in nested dicts (`conv1/convblock1/weight`,
`.../bias`, `conv1/rezero_weight`, `conv1/res_kernel`, `conv1/res_bias`,
`res_increment`, the learned pools' logits `pool{lvl}` and `unpool{lvl}`,
and the variants' blocks); the port's `nn.Module`s use the same names and shapes,
so a path maps to a state-dict key by joining with dots. Both directions
carry numpy arrays on the JAX side and fp32 tensors on the port side.
`broadcast_params` gives every rank of a mesh rank 0's parameters, as the
JAX package replicates them over its mesh (`device_put` replicated).

The BatchNorm running statistics cross the same way: the JAX `norm_state`
(`conv1/convblock1/{mean,var}`) is the port's buffers under the same
dotted names (`norm_state_from_jax`, `norm_state_to_jax`). Member-stacked
trees (DeepEnsemble members, SWAG samples: every leaf with a leading [M]
axis, as `jax.vmap` stacks them) map to `torch.func.stack_module_state`'s
layout, {name: [M, ...]}, by the same functions; `stack_states` and
`member_state` stack and take apart per-member state dicts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .parallel.collectives import broadcast_

__all__ = ["params_from_jax", "params_to_jax", "norm_state_from_jax",
           "norm_state_to_jax", "stack_states", "member_state",
           "seeded_params", "broadcast_params"]


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


def norm_state_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX norm_state (nested {mean, var} leaves, member-stacked or not)
    -> the port's running statistics {buffer name: fp32 tensor}."""
    return params_from_jax(tree)


def norm_state_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The port's running statistics -> the JAX norm_state nesting, fp32
    numpy copies."""
    return params_to_jax(state)


def stack_states(states) -> Dict[str, torch.Tensor]:
    """Per-member state dicts with the same keys -> {key: [M, ...]}, in
    the first one's key order."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def member_state(stacked: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Member i of a {key: [M, ...]} stack (views)."""
    return {k: v[i] for k, v in stacked.items()}


def seeded_params(model: torch.nn.Module, seed: int) -> Dict:
    """Every parameter of `model` drawn from np.random.default_rng(seed),
    in the JAX layout.

    Unlike the init, nothing is zero: the ReZero weights, biases and the
    increment scale start at zero after init, which would multiply every
    convolution branch by 0 and hide it from a comparison. Weights use
    the He-normal scale of their fan-in; the ReZero weights, the
    increment scale and the normalization scales are drawn from
    U(0.5, 1.5); the learned pools' logits (`pool{lvl}`, `unpool{lvl}`)
    are their initial values (log of the remap weights) plus
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(model.state_dict())

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("rezero_weight", "res_increment", "norm_scale"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "weight":   # [Fin, K, Fout] or [kh, kw, Cin, Cout]
                std = np.sqrt(2.0 / np.prod(v.shape[:-1]))
                node[k] = (std * rng.standard_normal(v.shape)).astype(np.float32)
            elif k.startswith(("pool", "unpool")):      # [D, W] logits
                node[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "res_kernel":         # [Fin, Fout]
                lim = 1.0 / np.sqrt(v.shape[0])
                node[k] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            else:                           # biases
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    fill(tree)
    return tree


def broadcast_params(model: torch.nn.Module, mesh) -> None:
    """In place: rank 0's parameters of `model` (a whole member stack, on
    a member mesh) on every rank of `mesh`, in one flat buffer: over each
    data group from its data rank 0, then over each node group from its
    node rank 0, then over each member group from its member rank 0
    (which then holds rank 0's). Every rank of the mesh must call it."""
    if mesh is None:
        return
    params = [p.detach() for p in model.parameters()]
    flat = torch.cat([p.reshape(-1) for p in params])
    d, j, m = mesh.data_rank, mesh.node_rank, mesh.member_rank
    if mesh.n_data > 1:
        broadcast_(flat, mesh.rank_of(0, j, m), mesh.data_group)
    if mesh.n_node > 1:
        broadcast_(flat, mesh.rank_of(d, 0, m), mesh.node_group)
    if mesh.n_member > 1:
        broadcast_(flat, mesh.rank_of(d, j, 0), mesh.member_group)
    for p, part in zip(params, flat.split([p.numel() for p in params])):
        p.copy_(part.view_as(p))
