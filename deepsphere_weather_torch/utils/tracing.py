"""Spans of the port's layers, as CPU ops of any `torch.profiler` trace.

`span(name)` marks what runs inside it as one CPU op named `name`
(category `cpu_op` in the profiler's Chrome trace, beside the ATen ops
and on the profiler's clock), so a trace ties each device operation to
the layer that launched it: by its launch to the spans open on the
launching thread, and, for the backward, by the autograd node's sequence
number to the forward op that made the node and the spans open around
that op. There is no switch: the spans are recorded exactly when a
profiler is active, and otherwise cost well under a microsecond each and
record nothing.

The spans (all under the prefix `dsw.`):

    dsw.train.step       a training update (`engine.step`'s
                         `_optimizer_step`, `_member_update`)
    dsw.train.gather     the window batch taken from the device-resident
                         dataset (`_gather_window_batch`)
    dsw.train.loss       the AR loop's forward, the loss function's call
    dsw.train.backward   `backward()` of the step's loss
    dsw.train.optimizer  `optimizer.step()`, its clipping pre-hook with it
    dsw.rollout          a block rollout (`make_rollout_block`'s function)
    dsw.model            one model call, in the AR loss and in the rollout
    dsw.cheb_conv        one Chebyshev convolution (`ops.cheb.cheb_conv`)
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

__all__ = ["span"]


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records what runs inside it as the CPU op
    `name` while a `torch.profiler` is active, and does nothing
    otherwise."""
    return _RecordFunctionFast(name)
