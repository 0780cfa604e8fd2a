"""What every plain PyTorch reference model shares.

The published DeepSphere-Weather models (deepsphere-weather,
modules/my_models_graph.py) are Chebyshev convolutions of order K over
each level's rescaled Laplacian. `ChebNet` writes one out with plain
torch operations in float32: the Laplacian products as torch.sparse CSR
products (their transposes in the backward), the channel mixes as
einsums. An architecture (`arch/<architecture_name>.py`) builds on it,
with the pool of its configuration (`pools/<pool_method>.py`); the
training and forecasting around any of them (`ar_loss`, `adam_train`,
`rollout`) are here. It imports nothing of the program and takes nothing
the program made: the caller hands it the parameters it drew and the
Laplacians it built (`graphs/`).

`prec` names the precision every product is computed in: "fp32" (the
reference), or a control one step below a configuration's own precision:
"tf32" (operands rounded to a 10-bit mantissa, as the tensor cores take
fp32 with TF32 on) and "fp8" (operands scaled per tensor and rounded to
float8 e4m3). A control rounds each product's operands in the forward
and the gradients it passes back to them in the backward; sums stay in
fp32.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    s = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


_ROUND = {"tf32": _round_tf32, "fp8": _round_fp8}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class _LapMM(torch.autograd.Function):
    """L @ x for a CSR L, with L^T @ g as the gradient in x."""

    @staticmethod
    def forward(ctx, x, lap, lap_t):
        ctx.lap_t = lap_t
        return torch.sparse.mm(lap, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.lap_t, g.contiguous()), None, None


def csr_pair(lap, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A scipy CSR matrix and its transpose as fp32 torch CSR tensors."""
    def one(m):
        m = m.tocsr()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.as_tensor(m.indptr, dtype=torch.int64),
                torch.as_tensor(m.indices, dtype=torch.int64),
                torch.as_tensor(m.data, dtype=torch.float32), size=m.shape,
                device=device)
    return one(lap), one(lap.T)


class ChebNet:
    """The Chebyshev convolution over a level's Laplacian, in `prec`."""

    def __init__(self, laps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 K: int, prec: str = "fp32"):
        self.q: Callable = ((lambda t: t) if prec == "fp32"
                            else (lambda t: _Round.apply(t, _ROUND[prec])))
        if prec != "fp32":
            laps = [(self._round_csr(a, _ROUND[prec]),
                     self._round_csr(b, _ROUND[prec])) for a, b in laps]
        self.laps: List = list(laps)
        self.K = K

    @staticmethod
    def _round_csr(m, fn):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(m.crow_indices(), m.col_indices(),
                                           fn(m.values()), size=m.shape)

    def cheb(self, x, lvl, w, b):
        """x [B, V, Fin], w [Fin, K, Fout], b [Fout] -> [B, V, Fout]."""
        B, V, Fin = x.shape
        lap, lap_t = self.laps[lvl]
        h = x.transpose(0, 1).reshape(V, B * Fin)
        terms = [h]
        if self.K > 1:
            terms.append(_LapMM.apply(self.q(h), lap, lap_t))
        for _ in range(2, self.K):
            terms.append(2.0 * _LapMM.apply(self.q(terms[-1]), lap, lap_t)
                         - terms[-2])
        basis = torch.stack(terms).reshape(self.K, V, B, Fin)
        return torch.einsum("kvbf,fko->bvo", self.q(basis), self.q(w)) + b


def model_input(dyn, bc, static, pos):
    """[B, n_in, V, F] of window positions `pos` [n_in]: static, then bc,
    then dynamic features (dyn, bc [B, W, V, *], static [V, Fs])."""
    B, _, V, _ = dyn.shape
    n = len(pos)
    return torch.cat([static[None, None].expand(B, n, V, static.shape[-1]),
                      bc[:, pos], dyn[:, pos]], dim=-1)


def ar_loss(net, p, dyn, bc, static, in_pos, out_pos,
            ar_weights, area_w, remat: bool = True):
    """The RNN multi-step loss: each iteration's area-weighted MSE against
    the truth at its output positions, its prediction written into the
    window that later iterations read. Returns (total, per_iter).
    `remat` recomputes each iteration in the backward (memory only)."""
    w = area_w.reshape(1, 1, -1, 1)
    n_points = dyn.shape[0] * len(out_pos[0])

    def iteration(buf, i):
        y = net.forward(p, model_input(buf, bc, static, in_pos[i]))
        loss = ((y - dyn[:, out_pos[i]]) ** 2 * w).sum() / area_w.sum() \
            / n_points / y.shape[-1]
        return buf.index_copy(1, torch.as_tensor(out_pos[i],
                                                 device=buf.device), y), loss

    buf, losses = dyn, []
    for i in range(len(in_pos)):
        if remat:
            buf, loss = checkpoint(iteration, buf, i, use_reentrant=False)
        else:
            buf, loss = iteration(buf, i)
        losses.append(loss)
    per_iter = torch.stack(losses)
    aw = torch.as_tensor(ar_weights, dtype=torch.float32,
                         device=dyn.device)[:len(in_pos)]
    return (per_iter * (aw / aw.sum())).sum(), per_iter


def adam_train(net, params: Dict[str, torch.Tensor], batches,
               static, in_pos, out_pos, ar_weights, area_w, lr: float,
               clip: float, eps: float = 1e-7, betas=(0.9, 0.999)):
    """Steps of Adam(lr, eps) after optax's global-norm clipping (kept when
    the norm is under `clip`, else scaled to it), one per (dyn, bc) batch.
    Returns (losses, the first step's clipped gradients, the parameters
    after the last step)."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, (dyn, bc) in enumerate(batches, start=1):
        total, _ = ar_loss(net, p, dyn, bc, static, in_pos, out_pos,
                           ar_weights, area_w)
        grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if float(norm) >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                mhat = m[k] / (1 - betas[0] ** t)
                vhat = v2[k] / (1 - betas[1] ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + eps))
    return losses, first, {k: v.detach() for k, v in p.items()}


@torch.no_grad()
def rollout(net, params: Dict[str, torch.Tensor], dyn, bc,
            static, t0s, n_leads: int, input_k: Sequence[int], cycle: int):
    """[B, n_leads, V, F] forecasts from reference times `t0s` [B] over the
    series dyn [T, V, F] and bc [T, V, Fb]: lead i predicts t0 + i cycle
    from the fields at its input offsets, the truth before t0 and the
    forecast's own predictions from t0 on."""
    t0s = torch.as_tensor(t0s, dtype=torch.long, device=dyn.device)
    preds: List[torch.Tensor] = []
    for i in range(n_leads):
        t = t0s + i * cycle
        xs, bcs = [], []
        for k in input_k:
            lag = i * cycle + k            # offset of the input from t0
            xs.append(dyn[t + k] if lag < 0 else preds[lag // cycle])
            bcs.append(bc[t + k])
        x = torch.cat([static[None, None].expand(len(t0s), len(input_k),
                                                 *static.shape),
                       torch.stack(bcs, 1), torch.stack(xs, 1)], dim=-1)
        preds.append(net.forward(params, x)[:, 0])
    return torch.stack(preds, 1)


def ar_windows(input_k: Sequence[int], output_k: Sequence[int], cycle: int,
               ar_iterations: int):
    """(offsets, in_pos, out_pos): the sorted time offsets of a training
    window from its reference time, and each AR iteration's input and
    output positions in it (iteration i is shifted by i cycle)."""
    n = ar_iterations + 1
    offs = sorted({i * cycle + k for i in range(n)
                   for k in list(input_k) + list(output_k)})
    pos = {o: j for j, o in enumerate(offs)}
    in_pos = [[pos[i * cycle + k] for k in input_k] for i in range(n)]
    out_pos = [[pos[i * cycle + k] for k in output_k] for i in range(n)]
    return offs, in_pos, out_pos
