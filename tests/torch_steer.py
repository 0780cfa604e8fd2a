"""Steer one run of the port's UNetSpherical onto another run's decisions.

A ReLU or max-pool decision that one rounding flips changes a seeded
network's output and gradients by far more than the rounding. To compare
two runs that round differently (card and CPU), the second takes the
first's decisions, and each decision that differs from its own is
reported with how far its input sat from the kink or tie. Used by the
card tests and by chip_smoke.py (a helper module, not a test)."""

import dataclasses

import torch

from deepsphere_weather_torch.models import ConvBlock


def steer(model, pinned=None):
    """Route the model's ReLUs and max pools through a recorder of their
    decisions (ReLU: x > 0; pool: the argmax), in call order. With
    `pinned`, another run's decisions are taken instead, and where they
    differ from this run's own, `gaps` gets how far this run's input sat
    from the kink (|x|) or tie (the gap), over the call's largest |x|.
    Returns (decisions, gaps), filled as the model runs."""
    decisions, gaps = [], []
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
        decisions.append(mask.cpu())
        return torch.where(mask, x, torch.zeros_like(x))

    def steered(pool):
        def call(x):
            y, idx = pool(x)
            if taken is not None:
                want = next(taken).to(x.device)
                B, D, C = idx.shape
                g = x.reshape(B, D, pool.k, C)
                if (want != idx).any():
                    gd = g.detach()
                    gap = (gd.gather(2, idx[:, :, None])
                           - gd.gather(2, want[:, :, None])).abs()[:, :, 0]
                    gaps.append(float(gap[want != idx].max()
                                      / gd.abs().max()))
                y, idx = g.gather(2, want[:, :, None])[:, :, 0], want
            decisions.append(idx.cpu())
            return y, idx
        return call

    for m in model.modules():
        if isinstance(m, ConvBlock) and m.act:
            m.act_fun = relu
    model.geometry = dataclasses.replace(
        model.geometry, pools=[steered(p) for p in model.geometry.pools])
    return decisions, gaps
