#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the HEALPix-16 bf16 forecast service, on the
card and checks it, in phases printed one per line:

1. card      name and power limit (nvidia-smi)
2. build     the CUDA kernel, compiled with nvcc from this checkout
3. parity    the super-row SpMM kernel at HEALPix-16 and HEALPix-64 level 0,
             fp32 and bf16, against scipy `L @ x` (bars: fp32 < 1e-5,
             bf16 < 2e-2, max abs error / max abs) and against its plain
             PyTorch version on the card, there and at each width the main
             path gives it (same bars); its time at the main path's shapes
             beside its bound, the plain version and cuSPARSE
4. slice     UNetSpherical, HEALPix-16, knn-20, max pool, increment
             learning, bf16, 7 features x 3 lags -> 2, seeded weights in
             the JAX layout loaded through `weights.py`, behind
             ForecastService (batch 16, block 4): a 20-step forecast of 16
             histories and 5 concurrent submit() requests; finite outputs
             of the right shapes, agreement with the same forward on the
             CPU plain path (3e-2), 10 kernel launches per forward
5. times     time per forecast step and per kernel launch

Any failed phase raises, and the script exits non-zero. The second-to-last
lines are the kernel table as JSON and the card; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
`--profile` adds the device time by kernel of three forwards.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
SLICE_SUBDIV, BIG_SUBDIV, KNN = 16, 64, 20
BATCH, BLOCK, N_STEPS, N_SUBMIT = 16, 4, 20, 5
F_DYN, F_BC, F_STATIC, INPUT_K = 2, 1, 4, (-3, -2, -1)
MATVEC_WIDTH = 1024
BARS = {"fp32": 1e-5, "bf16": 2e-2}
SLICE_TOL = 3e-2
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}   # fp32 non-tensor; bf16 dense
KERNEL = "bcsr_super_spmm"
LAUNCHES_PER_FORWARD = 10


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def time_ms(fn, n_iter=20, n_warm=3):
    """Mean device time of fn() over n_iter calls (CUDA events)."""
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n_iter):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n_iter


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from deepsphere_weather_torch.kernels.build import load_kernel

    k = load_kernel(KERNEL)
    log("build", f"{KERNEL}: {'built' if k.built else 'loaded from cache'} "
                 f"({k.path.name}), nvcc {k.nvcc_seconds:.1f} s")
    for line in k.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


def _bound(op, x, nnz_blocks):
    """(bytes ms, operations ms) of L @ x at x's own, unpadded shape: the
    nonzero 128x128 blocks of A, x and the output each moved once over
    HBM; the nonzero block products at the type's peak rate. The least
    time the card could take is the larger of the two."""
    import torch

    n, m = x.shape
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    out_size = 2 if dt == "bf16" else 4
    nbytes = (nnz_blocks * 128 * 128 * op.svals.element_size()
              + n * m * (x.element_size() + out_size))
    ops = 2.0 * nnz_blocks * 128 * 128 * m
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[dt]


def _block_counts(op):
    """(nonzero 128x128 blocks, block slots) of the super-row layout."""
    n_s, R, bs, ubs = op.svals.shape
    blocks = op.svals.view(n_s, R, bs, ubs // bs, bs)
    return int((blocks != 0).any(dim=4).any(dim=2).sum()), n_s * R * ubs // bs


def _csr(L, device, dtype):
    import torch

    L = L.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr.astype(np.int64)),
        torch.from_numpy(L.indices.astype(np.int64)),
        torch.from_numpy(L.data), size=L.shape, device=device, dtype=dtype)


def measure(op, L, x, device, label):
    """Kernel vs plain version on the same padded input, held to the bar of
    x's dtype (raises if it breaks it); times and bound."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import (
        bcsr_super_spmm,
        bcsr_super_spmm_reference,
    )

    n, m = x.shape
    x_pad = torch.nn.functional.pad(x, (0, (-m) % 128, 0, op.rows - n))
    y = bcsr_super_spmm(op.svals, op.ucols, x_pad)
    ref = bcsr_super_spmm_reference(op.svals, op.ucols, x_pad)
    bar = BARS["bf16" if x.dtype == torch.bfloat16 else "fp32"]
    err_plain = rel_err(y.float().cpu(), ref.float().cpu())
    if not err_plain < bar:
        raise AssertionError(f"{label}: kernel vs plain version "
                             f"{err_plain:.3e} breaks the {bar:g} bar")
    csr = _csr(L, device, x.dtype)
    nnz, slots = _block_counts(op)
    t_bytes, t_ops = _bound(op, x, nnz)
    return {
        "max_abs_err": float((y.float() - ref.float()).abs().max()),
        "rel_err_plain": err_plain,
        "blocks_nonzero": f"{nnz}/{slots}",
        "ms": time_ms(lambda: bcsr_super_spmm(op.svals, op.ucols, x_pad)),
        "plain_ms": time_ms(
            lambda: bcsr_super_spmm_reference(op.svals, op.ucols, x_pad),
            n_iter=5),
        "library_ms": time_ms(lambda: torch.sparse.mm(csr, x)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops}


def phase_parity(device, subdivs, width):
    import torch

    from deepsphere_weather_torch.models.geometry import cached_graph_laplacian
    from deepsphere_weather_torch.ops.bcsr import BlockSparseOperator

    rng = np.random.default_rng(SEED)
    errs = []
    for subdiv in subdivs:
        t0 = time.perf_counter()
        _, L = cached_graph_laplacian(
            "healpix", {"subdivisions": subdiv, "nest": True}, KNN, "knn")
        x_np = rng.standard_normal((L.shape[0], width)).astype(np.float32)
        ref = L @ x_np
        log("parity", f"HEALPix-{subdiv}: {L.shape[0]} nodes, graph + scipy "
                      f"reference {time.perf_counter() - t0:.1f} s")
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            op = BlockSparseOperator.from_scipy(L, dtype=dt, device=device)
            x = torch.from_numpy(x_np).to(device, dt)
            y = op.matvec(x)
            err = rel_err(y.float().cpu().numpy(), ref)
            res = measure(op, L, x, device, f"HEALPix-{subdiv} {name}")
            n_s, R, _, ubs = op.svals.shape
            log("parity", f"HEALPix-{subdiv} {name} x[{L.shape[0]}, {width}] "
                          f"n_s={n_s} R={R} max_u={ubs // 128}: "
                          f"rel err vs scipy {err:.3e} (bar {BARS[name]:g}), "
                          + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                      else f"{k} {v}"
                                      for k, v in res.items()))
            if not err < BARS[name]:
                raise AssertionError(
                    f"HEALPix-{subdiv} {name}: kernel vs scipy {err:.3e} "
                    f"breaks the {BARS[name]:g} bar")
            errs.append(f"HEALPix-{subdiv} {name} {err:.3e} / "
                        f"{res['max_abs_err']:.3e}")
    log("parity", f"kernels: {KERNEL} (K1, pallas_spmm.py:493), rel err vs "
                  f"scipy / max abs err vs plain version: " + "; ".join(errs))


def tensor_info(n_node):
    n_in = F_STATIC + F_BC + F_DYN
    return {"input_n_feature": n_in, "output_n_feature": F_DYN,
            "input_n_time": len(INPUT_K), "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n_node}},
            "output_shape_info": {"dynamic": {"node": n_node}}}


def build_flagship(device, subdiv, params=None):
    from deepsphere_weather_torch.models import UNetSpherical

    model = UNetSpherical(
        tensor_info(12 * subdiv ** 2), "healpix",
        {"subdivisions": subdiv, "nest": True}, knn=KNN, pool_method="max",
        increment_learning=True, numeric_precision="bfloat16", device=device)
    if params is not None:
        model.load_state_dict(params)
    return model.eval()


def phase_slice(device, subdiv, batch, n_steps):
    """Drive the forecast service; returns the main-path figures."""
    import torch

    from deepsphere_weather_torch.data.scalers import GlobalStandardScaler
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.serve import ForecastService, export_rollout
    from deepsphere_weather_torch.weights import params_from_jax, seeded_params

    t0 = time.perf_counter()
    model = build_flagship(device, subdiv)
    V = model.input_n_node
    params = params_from_jax(seeded_params(model, SEED))
    ops = model.geometry.cheb_ops
    if ops[0].bcsr is None or ops[0].bcsr.svals.dtype != torch.bfloat16:
        raise AssertionError("level 0 must run the bf16 block-sparse operator")
    log("slice", f"UNetSpherical HEALPix-{subdiv} levels "
                 f"{model.geometry.n_nodes} (level 0 block-sparse bf16), "
                 f"built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED + 1)
    H = 1 - min(INPUT_K)

    def history(n):             # z500 (~5400 m) and t850 (~270 K) scales
        return (rng.standard_normal((n, H, V, F_DYN)) * [300.0, 10.0]
                + [5400.0, 270.0]).astype(np.float32)

    def boundary(n, steps):     # TOA solar radiation scale
        return (rng.standard_normal((n, steps, len(INPUT_K), V, F_BC)) * 100.0
                + 300.0).astype(np.float32)

    static = rng.standard_normal((V, F_STATIC)).astype(np.float32)
    scaler = GlobalStandardScaler().fit(history(8).reshape(-1, V, F_DYN))
    scaler_bc = GlobalStandardScaler().fit(boundary(2, 4).reshape(-1, V, F_BC))
    rollout = export_rollout(
        model, params, input_k=INPUT_K, output_k=[0], forecast_cycle=1,
        batch_size=batch, block_size=BLOCK, static=static, n_bc_features=F_BC,
        timestep_hours=6.0)
    svc = ForecastService(rollout, scaler=scaler, scaler_bc=scaler_bc)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    hist, bc = history(batch), boundary(batch, n_steps)
    svc.predict(hist, n_steps=BLOCK, bc=bc[:, :BLOCK])          # warm-up

    # the main path: counts from 0, then a forecast and concurrent requests
    reset_launch_counts()
    forwards[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.predict(hist, n_steps=n_steps, bc=bc)
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    # request i: history i and its first block of boundary conditions
    t0 = time.perf_counter()
    futs = [None] * N_SUBMIT
    threads = [threading.Thread(target=lambda i=i: futs.__setitem__(
        i, svc.submit(hist[i], n_steps=BLOCK, bc=bc[i, :BLOCK])))
        for i in range(N_SUBMIT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if None in futs:
        raise AssertionError("not every submit() returned a future")
    answers = [f.result(timeout=600) for f in futs]
    t_submit = time.perf_counter() - t0
    launches = launch_counts[KERNEL]
    n_fwd = forwards[0]

    if out.shape != (batch, n_steps, 1, V, F_DYN) or not np.isfinite(out).all():
        raise AssertionError(f"forecast {out.shape} is not finite of shape "
                             f"{(batch, n_steps, 1, V, F_DYN)}")
    for a in answers:
        if a.shape != (BLOCK, 1, V, F_DYN) or not np.isfinite(a).all():
            raise AssertionError(f"submit answer {a.shape} is malformed")
    # request i answers what predict gave history i for its first block
    # (other batch padding, so cuBLAS may sum in another order)
    for i, a in enumerate(answers):
        e = rel_err(scaler.transform(a), scaler.transform(out[i, :BLOCK]))
        if not e <= SLICE_TOL:
            raise AssertionError(f"submit answer {i} differs from predict: "
                                 f"{e:.3e} > {SLICE_TOL}")
    if launches != LAUNCHES_PER_FORWARD * n_fwd or n_fwd == 0:
        raise AssertionError(f"{launches} kernel launches for {n_fwd} "
                             f"forwards; want {LAUNCHES_PER_FORWARD} each")
    log("slice", f"predict {batch} x {n_steps} steps -> {out.shape}, "
                 f"{N_SUBMIT} submits -> {[a.shape for a in answers]}; "
                 f"finite; {n_fwd} forwards, {launches} {KERNEL} launches")

    # the same forward on the card and on the CPU plain path
    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), V, F_STATIC + F_BC + F_DYN)).astype(np.float32))
    with torch.inference_mode():
        y = model(x.to(device)).cpu()
        cpu_model = build_flagship(torch.device("cpu"), subdiv, params)
        y_cpu = cpu_model(x)
    x_last = x[:, -1:, :, -F_DYN:]
    e = rel_err((y - x_last).numpy(), (y_cpu - x_last).numpy())
    if not e <= SLICE_TOL:
        raise AssertionError(f"card vs CPU forward {e:.3e} > {SLICE_TOL}")
    log("slice", f"card vs CPU plain-path forward (network output minus "
                 f"x_last): rel err {e:.3e} (tol {SLICE_TOL})")

    xd = x.to(device)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(xd), n_iter=10)
    return {"launches": launches, "forwards": n_fwd,
            "step_ms": 1e3 * t_predict / n_steps,
            "submit_ms": 1e3 * t_submit, "forward_ms": forward_ms,
            "model": model}


def kernel_row(model, device, batch, launches):
    """The kernel at the 10 shapes one forward gives it (level 0, bf16,
    batch 16): per-launch averages."""
    import torch

    from deepsphere_weather_torch.models.geometry import cached_graph_laplacian

    op = model.geometry.cheb_ops[0].bcsr
    _, L = cached_graph_laplacian(
        "healpix", {"subdivisions": SLICE_SUBDIV, "nest": True}, KNN, "knn")
    # conv1 (21->64->128, input side), uconv1 (256->128->64, Clenshaw),
    # uconv1_final (64->2, Clenshaw): matvec widths B*F, two each
    widths = [batch * f for f in (21, 64, 128, 64, 2)]
    rng = np.random.default_rng(SEED + 2)
    acc = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0}
    err = 0.0
    for w in widths:
        x = torch.from_numpy(rng.standard_normal((L.shape[0], w)).astype(
            np.float32)).to(device, torch.bfloat16)
        r = measure(op, L, x, device, f"HEALPix-{SLICE_SUBDIV} bf16 width {w}")
        log("times", f"{KERNEL} HEALPix-{SLICE_SUBDIV} bf16 width {w}: "
                     f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
                     f"cuSPARSE {r['library_ms']:.4f} ms), vs plain version "
                     f"{r['rel_err_plain']:.3e} (bar {BARS['bf16']:g})")
        for k in acc:
            acc[k] += 2 * r[k] / LAUNCHES_PER_FORWARD
        err = max(err, r["max_abs_err"])
    return {"name": KERNEL, "route": "cuda",
            "source": "deepsphere_weather_torch/kernels/bcsr_super_spmm.cu",
            "replaces": "deepsphere_weather_tpu/ops/pallas_spmm.py:493",
            "launches": launches, "max_abs_err": err, "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": acc["library_ms"]}


def phase_profile(model, device, batch, n_fwd=3):
    """Device time by kernel over n_fwd forwards (torch.profiler), and the
    device's busy share of the window's host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), model.input_n_node,
         F_STATIC + F_BC + F_DYN)).astype(np.float32)).to(device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_fwd):
                model(x)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", f"{n_fwd} forwards, batch {batch}: device busy "
                   f"{busy:.3f} ms of {wall_ms:.3f} ms host time "
                   f"({100 * busy / wall_ms:.1f}%, profiler on)")
    for ms, count, key in rows[:15]:
        log("profile", f"{100 * ms / busy:5.1f}%  {ms / n_fwd:8.4f} ms/fwd  "
                       f"{count // n_fwd:4d}/fwd  {key[:90]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for 3 forwards")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card_line = card()
    log("card", card_line)
    phase_build()
    phase_parity(device, (SLICE_SUBDIV, BIG_SUBDIV), MATVEC_WIDTH)
    fig = phase_slice(device, SLICE_SUBDIV, BATCH, N_STEPS)
    row = kernel_row(fig["model"], device, BATCH, fig["launches"])
    log("times", f"slice: {fig['step_ms']:.2f} ms per forecast step (batch "
                 f"{BATCH}, host clock, {N_STEPS} steps), {fig['submit_ms']:.1f} "
                 f"ms for {N_SUBMIT} concurrent submits, forward "
                 f"{fig['forward_ms']:.3f} ms (CUDA events); {KERNEL} "
                 f"{row['ms']:.4f} ms per launch ({card_line})")
    if args.profile:
        phase_profile(fig["model"], device, BATCH)
    log("times", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
