"""Member-stacked models: M DeepEnsemble members (or SWAG samples) of one
architecture, advanced together.

The JAX package stacks member parameters into a leading pytree axis and
`jax.vmap`s the model over it. `MemberStack` is that stack as an
`nn.Module`: every parameter and buffer of the template model, under the
same dotted name, with a leading [M] axis (`torch.func.stack_module_state`'s
layout). So `Adam(stack.parameters())` updates every member at once (Adam
is elementwise), `stack.state_dict()` is the JAX member-stacked params tree
(`utils.Checkpointer` saves it with the leading axis, as the JAX package
saves vmapped params), and `stack.norm_state()` the member-stacked
running statistics.

The stack holds no geometry and is never called as a model: the member
steps (`engine.step`) run the template through
`torch.func.functional_call` on `tensors()` under `torch.func.vmap`. Each
block-sparse product then folds the members into its columns (the
registered SpMM op's vmap rule, `ops/bcsr.py`): one kernel launch for all
members.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

__all__ = ["MemberStack"]


class MemberStack(nn.Module):
    """M members of `model`'s architecture (module docstring), on its
    device.

    `params` ({name: [M, ...]}) and `buffers` (the running statistics,
    {name: [M, C]}) default to M copies of the template's own."""

    def __init__(self, model: nn.Module, n_members: Optional[int] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if params is None:
            if n_members is None:
                raise ValueError("give n_members or member-stacked params")
            params = {k: v.detach().expand((n_members,) + v.shape).clone()
                      for k, v in model.named_parameters()}
        names = [k for k, _ in model.named_parameters()]
        if sorted(params) != sorted(names):
            raise ValueError(f"member params {sorted(params)} do not match "
                             f"the model's {sorted(names)}")
        m = {int(v.shape[0]) for v in params.values()}
        if len(m) != 1 or (n_members is not None and m != {n_members}):
            raise ValueError(f"member axes {m} (n_members={n_members})")
        self.n_members = m.pop()
        # the template, not registered: its parameters are not the stack's
        self._template = [model]
        if buffers is None:
            buffers = {k: v.detach().expand((self.n_members,) + v.shape
                                            ).clone()
                       for k, v in model.named_buffers()}
        device = next(model.parameters()).device
        for name in names:
            self._put(name, nn.Parameter(
                params[name].detach().to(device, torch.float32).clone()))
        for name, _ in model.named_buffers():
            self._put(name, buffers[name].detach().to(
                device, torch.float32).clone(), buffer=True)

    def _put(self, name: str, t, buffer: bool = False):
        *path, leaf = name.split(".")
        mod = self
        for p in path:
            if p not in mod._modules:
                mod.add_module(p, nn.Module())
            mod = mod._modules[p]
        if buffer:
            mod.register_buffer(leaf, t, persistent=False)
        else:
            mod.register_parameter(leaf, t)

    @property
    def model(self) -> nn.Module:
        """The template whose forward the members run."""
        return self._template[0]

    @classmethod
    def from_states(cls, model: nn.Module,
                    states: Sequence[Dict[str, torch.Tensor]],
                    norm_states: Optional[Sequence[Dict]] = None
                    ) -> "MemberStack":
        """Stack per-member state dicts (and running statistics)."""
        from ..weights import stack_states

        return cls(model, params=stack_states(states),
                   buffers=(stack_states(norm_states)
                            if norm_states else None))

    def select(self, m0: int, m1: int) -> "MemberStack":
        """A new stack of the members [m0, m1) of this one (copies), on
        the same template: a member rank's part (`parallel.member_range`)."""
        return MemberStack(
            self.model,
            params={k: v[m0:m1] for k, v in self.named_parameters()},
            buffers={k: v[m0:m1] for k, v in self.named_buffers()})

    @property
    def has_batch_norm(self) -> bool:
        return bool(getattr(self.model, "has_batch_norm", False))

    def norm_state(self) -> Dict[str, torch.Tensor]:
        """The member-stacked running statistics (the buffers)."""
        return dict(self.named_buffers())

    def tensors(self) -> Dict[str, torch.Tensor]:
        """{name: [M, ...]}: parameters and buffers, for `functional_call`
        under `vmap`."""
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}
