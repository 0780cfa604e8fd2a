"""Profiling and scalability harness.

Port of `deepsphere_weather_tpu/utils/profiling.py` (the reference's
observability tooling):

- `summarize_model`: parameters per top-level block (the reference's
  torchinfo summary), in the JAX package's layout and wording;
- `profile_model`: a forward pass's step times and, on the card, its peak
  device memory;
- `profile_step`: step times of any step function, synchronized with the
  device (`torch.cuda.synchronize()`; `jax.jit` has no counterpart: the
  port runs eagerly), and optionally a `torch.profiler` trace of one more
  call written as a Chrome trace (`trace.json` under `trace_dir`, CPU and
  CUDA activities: the kernels by name and device time);
- `scalability_sweep`: forward and forward + backward wall time against
  nodes x knn for UNetSpherical (the reference's scalability harness,
  scripts_figs/scalability_plot.py). Its models are the port's at fp32,
  so on the card every block-sparse level (above 8192 nodes) runs the ELL
  kernel and every dense one cuBLAS.

Every number these return is a wall time of the port on the device its
tensors live on (or a byte count of that device's allocator).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["summarize_model", "profile_model", "profile_step",
           "scalability_sweep"]


def summarize_model(model, params: Optional[Dict] = None) -> str:
    """Parameter-count summary per top-level block: one line per block
    (count, and its tensor count or shape in the JAX layout) and the
    total. `params` (a state dict) defaults to the model's own."""
    from ..weights import params_to_jax

    tree = params_to_jax(model.state_dict() if params is None else params)
    lines = [f"{type(model).__name__}"]
    total = 0
    for name, sub in tree.items():
        leaves = _leaves(sub)
        n = sum(int(np.prod(leaf.shape)) for leaf in leaves)
        total += n
        shapes = (f"{len(leaves)} tensors" if len(leaves) > 1
                  else str(leaves[0].shape))
        lines.append(f"  {name:<22} {n:>12,}  ({shapes})")
    lines.append(f"  {'TOTAL':<22} {total:>12,} parameters")
    return "\n".join(lines)


def _leaves(tree) -> List[np.ndarray]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def profile_model(model, batch_size: int = 1, n: int = 10,
                  trace_dir: Optional[str] = None, seed: int = 0) -> Dict:
    """Step times of one forward pass of `model` on a standard-normal
    input (numpy seeded with `seed`) on the model's device, no gradient;
    on the card also its peak device memory (`peak_memory_bytes`, the
    allocator's peak over the timed calls). `trace_dir` as in
    `profile_step`."""
    device = next(model.parameters()).device
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch_size, model.input_n_time, model.input_n_node,
         model.input_n_feature)).astype(np.float32)).to(device)
    out: Dict = {"batch_size": batch_size}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def forward(x):
        with torch.no_grad():
            return model(x)

    out.update(profile_step(forward, x, n=n, trace_dir=trace_dir))
    if device.type == "cuda":
        out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return out


def _sync(out) -> None:
    """Wait for the device work behind `out` (any nesting of tensors)."""
    stack = [out]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
                return
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)


def profile_step(fn, *args, n: int = 10, warmup: int = 2,
                 trace_dir: Optional[str] = None,
                 pipelined: bool = False) -> Dict:
    """Median and percentile wall times of `fn(*args)`, each call waited
    for on the device; with `trace_dir`, one more call under
    `torch.profiler` (CPU and, on the card, CUDA activities), written as
    `trace_dir/trace.json` (Chrome trace format).

    pipelined=True measures steady-state throughput: all n calls are
    enqueued back to back with one final wait (as training loops run);
    per-call percentiles are then not meaningful and only median_s (the
    per-step average) is reported."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    if pipelined:
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        _sync(out)
        per = (time.perf_counter() - t0) / n
        return {"median_s": per, "p10_s": per, "p90_s": per, "n": n,
                "pipelined": True}
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            _sync(fn(*args))
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
    times = sorted(times)
    return {"median_s": times[len(times) // 2],
            "p10_s": times[int(len(times) * 0.1)],
            "p90_s": times[int(len(times) * 0.9)],
            "n": n}


def scalability_sweep(samplings: Optional[List[Dict]] = None,
                      knn_list=(8, 20, 40),
                      batch_size: int = 1,
                      out_json: Optional[str] = None,
                      device="cuda") -> List[Dict]:
    """Forward and forward + backward wall time against nodes x knn for
    UNetSpherical (7 features x 3 lags -> 2, max pool, fp32), one entry
    per (sampling, knn): the mean of 10 pipelined forwards without
    gradient, and of 10 chained SGD steps (lr 1e-9 on sum(y^2)), as the
    JAX sweep measures them. Runs on `device` ("cuda" by default; raises
    without CUDA)."""
    import json

    from .._device import resolve_device
    from ..models import UNetSpherical
    from ..sphere import build_sampling

    device = resolve_device(device)
    if samplings is None:
        samplings = [
            {"sampling": "healpix", "sampling_kwargs": {"subdivisions": s,
                                                        "nest": True}}
            for s in (8, 16, 32)
        ]
    results = []
    for spec in samplings:
        n_node = build_sampling(spec["sampling"],
                                dict(spec["sampling_kwargs"])).n_nodes
        for knn in knn_list:
            tensor_info = {
                "input_n_feature": 7, "output_n_feature": 2,
                "input_n_time": 3, "output_n_time": 1,
                "input_shape_info": {"dynamic": {"node": n_node}},
                "output_shape_info": {"dynamic": {"node": n_node}},
                "dim_order": {"dynamic": ["sample", "time", "node",
                                          "feature"]},
            }
            model = UNetSpherical(tensor_info=tensor_info, knn=knn,
                                  pool_method="max", device=device,
                                  generator=torch.Generator(
                                      device=device).manual_seed(0),
                                  **spec)
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (batch_size, 3, n_node, 7)).astype(np.float32)).to(device)

            def forward(x):
                with torch.no_grad():
                    return model(x)

            def train(x):
                model.zero_grad(set_to_none=True)
                loss = (model(x) ** 2).sum()
                loss.backward()
                with torch.no_grad():
                    for p in model.parameters():
                        p.sub_(1e-9 * p.grad)
                return loss

            t_fwd = profile_step(forward, x, n=10, pipelined=True)
            t_bwd = profile_step(train, x, n=10, warmup=1, pipelined=True)
            results.append({
                "sampling": spec["sampling"],
                "sampling_kwargs": spec["sampling_kwargs"],
                "n_nodes": n_node, "knn": knn, "batch_size": batch_size,
                "forward_ms": t_fwd["median_s"] * 1e3,
                "forward_backward_ms": t_bwd["median_s"] * 1e3,
            })
            print(results[-1], flush=True)
    if out_json:
        Path(out_json).write_text(json.dumps(results, indent=1))
    return results
