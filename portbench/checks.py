"""The comparison that decides `correct`: the numbers and their limits.

Training (the first steps the window's own step function took in
set-up, against the reference following the same batches):
- `loss_gap`: the largest |program - reference| / |reference| over the
  steps' losses;
- `grad_gap`: over the leaves, the largest gap between the program's
  and the reference's norm of the first step's clipped gradient (the
  program's read from Adam's first moment), against the larger of the
  reference leaf's norm and the median leaf's;
- `change_gap`: the same of each leaf's change over the steps;
- `loss1_gap`, `grad_median_gap`, `change_median_gap`: the first step's
  loss alone, and the median leaf's gap of each, which the noise of one
  small leaf or of the later steps does not move;
- `grad_median_err`, `change_median_err`: the median leaf's norm of the
  difference, |program - reference|, against the larger of its reference
  norm and the median leaf's. A gap of norms sees rounding noise only at
  second order, where it is orthogonal to the leaf; these see it at the
  first.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the changes.
A cell compares the numbers its limits file names.

Forecasts (a seeded sample of those the window made, every lead):
- `lead_gap`: the largest relative L2 error of a lead, over the batch's
  nodes and fields, against the reference's rollout from the same
  reference times;
- `lead_median_gap`: the largest, over the leads, of the median absolute
  error of a lead's values over the reference lead's RMS: the rounding
  of the whole field, which a few nodes' flipped ReLU or max-pool
  decisions do not move.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

DEAD_LEAF = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep
               ) -> Dict[str, float]:
    base = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], base, 1e-30)
            for k in keep}


def _leaf_errors(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keep) -> Dict[str, float]:
    """Each leaf's |prog - ref| over the larger of its reference norm and
    the median leaf's."""
    r = _norms({k: ref[k] for k in keep})
    base = statistics.median(r.values())
    return {k: float((prog[k].double() - ref[k].double()).norm())
            / max(r[k], base, 1e-30) for k in keep}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog and ref: {'losses': [..], 'grads': {leaf: tensor},
    'params0': {..}, 'params': {..}} (the parameters before and after)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    g_p, g_r = _norms(prog["grads"]), _norms(ref["grads"])
    g_med = statistics.median(g_r.values())
    live = [k for k in g_r if g_r[k] >= DEAD_LEAF * g_med]
    d_p = _norms({k: prog["params"][k].float() - prog["params0"][k].float()
                  for k in prog["params"]})
    d_r = _norms({k: ref["params"][k].float() - ref["params0"][k].float()
                  for k in ref["params"]})
    grad = _leaf_gaps(g_p, g_r, list(g_r))
    change = _leaf_gaps(d_p, d_r, live)
    loss1 = (abs(prog["losses"][0] - ref["losses"][0])
             / max(abs(ref["losses"][0]), 1e-30))
    grad_err = _leaf_errors(prog["grads"], ref["grads"], list(g_r))
    change_err = _leaf_errors(
        {k: prog["params"][k].float() - prog["params0"][k].float()
         for k in live},
        {k: ref["params"][k].float() - ref["params0"][k].float()
         for k in live}, live)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "grad_median_err": statistics.median(grad_err.values()),
            "change_median_err": statistics.median(change_err.values()),
            "change_gap": max(change.values()),
            "loss1_gap": loss1 if math.isfinite(loss1) else math.inf,
            "grad_median_gap": statistics.median(grad.values()),
            "change_median_gap": statistics.median(change.values()),
            "worst_leaves": {"grad": max(grad, key=grad.get),
                             "change": max(change, key=change.get)}}


def lead_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """prog, ref [B, leads, V, F]: the largest relative L2 error of a
    lead."""
    d = (prog.double() - ref.double()).flatten(2).norm(dim=2).norm(dim=0)
    r = ref.double().flatten(2).norm(dim=2).norm(dim=0)
    gap = float((d / r.clamp_min(1e-30)).max())
    return gap if math.isfinite(gap) else math.inf


def lead_median_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """prog, ref [B, leads, V, F]: the largest, over the leads, of the
    median |prog - ref| over the reference lead's RMS."""
    d = (prog.float() - ref.float()).abs().transpose(0, 1).flatten(1)
    rms = ref.double().transpose(0, 1).flatten(1).square().mean(1).sqrt()
    gap = float((d.median(dim=1).values.double()
                 / rms.clamp_min(1e-30)).max())
    return gap if math.isfinite(gap) else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {'value', 'limit'}} for every limit; a number that is absent
    or not finite reads None and fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v if math.isfinite(v) else None,
                     "limit": limit}
    return out


def passed(checks: Dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
