"""Steer one run of the port's UNetSpherical onto another run's decisions.

A ReLU or max-pool decision that one rounding flips changes a seeded
network's output and gradients by far more than the rounding. To compare
two runs that round differently (card and CPU), the second takes the
first's decisions, and each decision that differs from its own is
reported with how far its input sat from the kink or tie. A max pool's
decision is its set of maximal elements per window: its gradient splits
evenly over a tie (as `amax` and the JAX package's `max` do), and in bf16
exact ties are common, so one rounding that makes or breaks a tie moves
the gradient below the pool even where the argmax agrees. The pools that
decide are the argmax pools: HEALPix and equiangular max (a window of
the grid) and the remap 'maxval' pool (the weighted values over a
destination's support), each with a `candidates` method that its own
call reduces. A member step (`members`: the model's forward under
`torch.func.vmap` over that many members) records its decisions, each
stacked over the members (the member axis first), so that each member's
own run can take them; it takes none itself. Where one member's run is
all that is compared, `member` keeps that member's decisions alone (a
fifth of the host memory for five members). Used by the card tests
and by chip_smoke.py (a helper module, not a test)."""

import dataclasses

import torch
from torch._C import _functorch

from deepsphere_weather_torch.models import ConvBlock


def _plain(t):
    """`t` without torch.func's wrappers (vmap's mapped axis moved first):
    a decision taken under a member step, for all members at once."""
    while _functorch.is_functorch_wrapped_tensor(t):
        if _functorch.is_batchedtensor(t):
            t = _functorch.get_unwrapped(t).movedim(
                _functorch.maybe_get_bdim(t), 0)
        else:
            t = _functorch.get_unwrapped(t)
    return t


def steer(model, pinned=None, members=None, member=None):
    """Route the model's ReLUs and argmax pools through a recorder of their
    decisions (ReLU: x > 0, [B, V, C]; pool: the maximal elements of each
    output's candidates, [B, D, W, C]), in call order. With `pinned`, another
    run's decisions are taken instead: a pool then outputs this run's
    value at the pinned argmax (the first maximal element) and splits its
    gradient over the pinned tie; on an input without a gradient only its
    argmax is compared. Where they differ from this run's own, `gaps` gets
    how far this run's input sat from the kink (|x|) or from the window's
    max, over the call's largest |x|. With `members`, the model runs a
    member step of that many members and each decision is recorded stacked
    over them (raises if one is not), or only member `member`'s when given.
    Returns (decisions, gaps), filled as the model runs."""
    decisions, gaps = [], []

    def record(mask):
        plain = _plain(mask)
        if members is not None and (plain is mask
                                    or plain.shape[0] != members):
            raise ValueError(f"a decision of the member step is not "
                             f"stacked over its {members} members")
        decisions.append((plain if member is None else plain[member]).cpu())

    taken = None if pinned is None else iter(pinned)

    def relu(x):
        mask = x > 0
        if taken is not None:
            want = next(taken).to(x.device)
            if (want != mask).any():
                xd = x.detach()
                gaps.append(float(xd[want != mask].abs().max()
                                  / xd.abs().max()))
            mask = want
        record(mask)
        return torch.where(mask, x, torch.zeros_like(x))

    def steered(pool):
        if not hasattr(pool, "candidates"):
            return pool

        def call(x):
            y, idx = pool(x)
            g, to_idx = pool.candidates(x)
            ties = g == y[:, :, None]
            if taken is not None:
                want = next(taken).to(x.device)
                differ = want != ties
                if not x.requires_grad:
                    # without a gradient only the argmax reaches the output
                    differ &= (want.int().argmax(dim=2)
                               != ties.int().argmax(dim=2))[:, :, None]
                # a call whose decisions all agree keeps the pool's own
                # output
                if differ.any():
                    gd = g.detach()
                    gap = gd.amax(2, keepdim=True) - gd
                    scale = gd[torch.isfinite(gd)].abs().max()
                    gaps.append(float(gap[differ].max() / scale))
                    j = want.int().argmax(dim=2)
                    idx = to_idx(j)
                    val = gd.gather(2, j[:, :, None])[:, :, 0]
                    # forward: val; gradient: evenly over the pinned tie
                    y = val + torch.where(want, g - gd, 0).sum(2) / want.sum(2)
                    ties = want
            record(ties)
            return y, idx
        return call

    for m in model.modules():
        if isinstance(m, ConvBlock) and m.act:
            m.act_fun = relu
    model.geometry = dataclasses.replace(
        model.geometry, pools=[steered(p) for p in model.geometry.pools])
    return decisions, gaps
