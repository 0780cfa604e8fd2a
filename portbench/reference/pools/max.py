"""Max pooling of a nested sampling (`pool_method: "Max"`): each parent
takes the largest of its four children, channel by channel; the unpool
puts each value back on the child it came from and zeros elsewhere."""

import torch


def pool(x, p, lvl):
    """x [B, V, C] -> ([B, V / 4, C], the argmax child of each)."""
    B, V, C = x.shape
    g = x.reshape(B, V // 4, 4, C)
    return g.amax(dim=2), g.argmax(dim=2)


def unpool(x, idx, p, lvl):
    B, D, C = x.shape
    hot = (idx[:, :, None, :] == torch.arange(4, device=x.device)[:, None])
    return (hot.to(x.dtype) * x[:, :, None, :]).reshape(B, D * 4, C)
