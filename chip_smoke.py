#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the HEALPix-16 bf16 forecast service, the
HEALPix-16 AR6 bf16 training step (and its HEALPix-64 AR2 form) and the
same step node- and data-parallel, on the card and checks them, in phases
printed one per line:

1. card      name and power limit (nvidia-smi)
2. build     both CUDA kernels (and the header they share), compiled side
             by side with nvcc from this checkout (seconds; registers,
             shared memory, spills); each holds a full-range and a
             row-range entry; the registers and spills of both kernels'
             tensor-core instances (bf16 x; none may spill) and the count
             of HGMMA instructions in their SASS (cuobjdump; none may have
             0)
3. parity    the super-row SpMM kernel (K1) and the plain-BCSR one (K3) at
             HEALPix-16 and HEALPix-64 level 0, fp32 and bf16, width 1024,
             against scipy `L @ x` (bars: fp32 < 1e-5, bf16 < 2e-2, max abs
             error / max abs) and against their plain PyTorch versions on
             the card; K3 at each width the main path gives it too, and in
             both regimes of fp32 A against bf16 x (`round_a`; False is
             K4's function) at HEALPix-16 and -64, and on a product whose
             exact output cancels (tests/torch_split_probe.py), where K4's
             hi + lo split must read under 2^-14 of max(|A||x|) and K3's
             A rounded to bf16 above it; the backward of both,
             d/dx sum((Lx)^2) against 2 L^T (L x) (bar 1e-5), for the knn L
             and for a non-symmetric D L (through the transposed super-row
             layout and the transposed plain layout);
             the row ranges alone (K2, and K3's): HEALPix-16 and -64 level
             0, width 1024, split 2 and 4 ways, each shard against the rows
             of the full launch (exactly), its plain version (exactly in
             the fp32-x regimes; at the bf16 bar with bf16 x, where the
             tensor cores sum in another order) and scipy's rows (bars as
             above): K2 in fp32 and bf16, K3 in fp32, bf16 and both
             regimes of fp32 A against bf16 x
4. slice     UNetSpherical, HEALPix-16, knn-20, max pool, increment
             learning, bf16, 7 features x 3 lags -> 2, seeded weights in
             the JAX layout loaded through `weights.py`, behind
             ForecastService (batch 16, block 4): a 20-step forecast of 16
             histories and 5 concurrent submit() requests; finite outputs
             of the right shapes, agreement with the same forward on the
             CPU plain path (3e-2; the CPU takes the card's ReLU and
             max-pool decisions, each that differs within 1e-2 of its
             kink or tie), 10 K1 launches per forward
5. train     the same model trained: AR6 (7 iterations, RNN strategy),
             area-weighted MSE, Adam(1e-3, eps=1e-7), a synthetic batch
             from np.random.default_rng:
             (1) batch 2, the first step's losses and every parameter
                 gradient on the card against the CPU plain path (3e-2,
                 per key; a one-element gradient against the sum of its
                 terms' magnitudes);
             (2) batch 16, 10 steps on one batch: finite losses, the last
                 below the first, exactly 70 forward and 68 backward K1
                 launches per step;
             (3) as (2) with the level-0 operator in plain BCSR
                 (`rows_per_super=0`): only K3, as many launches, first
                 loss within 3e-2 of (2)'s
6. train64   HEALPix-64 AR2 batch 8 bf16 (all three levels block-sparse),
             3 steps: finite, decreasing losses, 66 forward and 64 backward
             K1 launches per step; step time and peak device memory; then
             K1 on each level's operator at each width one step gives it
             (recorded during a step), forward and backward, against its
             plain version and scipy (bf16 bar), covering every shape the
             step launched K1 at
7. node16    the step of (2) on a 1 data x 2 node mesh: 2 spawned ranks
             share the card over `gloo` (NCCL refuses two ranks on one
             device), each holding half the sphere at every level; 3
             steps: per-iteration losses within 3e-2 of (2)'s first
             steps, 70 forward + 68 backward K2 launches and no K1 launch
             per rank per step, 22 gathers per model call, parameters
             identical across ranks, step time (2 ranks sharing one H100:
             not a scaling number); then the fp32 batch-2 step (level 0
             block-sparse fp32): every gradient against the
             single-process card step's, per key, at (1)'s bar
8. mesh16    the same model on 2 data x 2 node (4 ranks), one step: loss
             within 3e-2 of (2)'s first, the launches of node16,
             parameters identical across ranks; then node16's fp32 batch-2
             step on the same mesh: every gradient Adam steps on, reduced
             over both groups, against the single-process card step's
9. node64    the HEALPix-64 step on 1 x 2, 2 steps: losses within 3e-2 of
             train64's, 66 + 64 K2 launches per rank per step, peak memory
             per rank; K2 at every (level, width) one sharded step gives
             it, forward and backward, against its plain version and
             scipy's rows (bf16 bar)
10. times    ms per train step and samples/s (host clock ended by
             torch.cuda.synchronize(), best of 4 windows, K1 and K3 steps
             taken in turns); each kernel per launch (`device_ms`: a CUDA
             graph of launches replayed) at the main path's widths beside
             its bound, its plain version and cuSPARSE, and K3 in K4's
             regime (fp32 A, bf16 x [3072, 1024], `round_a_false` of K3's
             row); K2 and K3's row range on the node16 step's level-0
             shard; the layouts side by side: K1 and K3 (its plain layout
             built from the same Laplacian, held to its plain version and
             scipy) at each (level, width) shape of the HEALPix-64 step

11. protocol16 the port's train -> predict -> verify CLI
             (`cli.train_predict.main`) on the shipped flagship config
             (configs/UNetSpherical/Healpix_400km/MaxPool-Graph_knn.json)
             with numeric_precision bfloat16 and its epochs cut (full width
             and depth; K1 at level 0), over toy HEALPix-16 data (the
             port's generate_toy_data, 1460 six-hour steps, seed 0): the
             device-cache path taken, K1 launched in the training forward
             and backward, validation and the AR20 prediction (and nothing
             else), every logged loss finite, the checkpoint and skill
             files written, the forecast store [n_frt, 21, 3072, 2]
             finite, RMSE larger at lead 20 than at lead 1 for both
             variables; then one --resume epoch. It prints the wall
             seconds of train, predict, rechunk and verify, the driver's
             training samples/s beside the bare step's (at the driver's AR
             depth, and phase train's AR6), AR20 seconds per reference
             time, peak device memory and K1's launches by part. It runs
             last: the config asks for deterministic training
             (torch.use_deterministic_algorithms, reset after it).

The ranks of phases 7-9 are started after the kernels are built, join a
`gloo` process group with a timeout, and the phase waits for them with a
limit; a rank that fails fails its phase. Any failed phase raises, and the
script exits non-zero. The lines before the last are the kernel table as
JSON and the card; the last line is {"ok": true, "device": {...}}. Without
CUDA it exits non-zero at once.
`--profile` adds the device time by kernel of three forwards, of two
train steps with each level-0 kernel (K1, K3) and of two HEALPix-64 steps.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
SLICE_SUBDIV, BIG_SUBDIV, KNN = 16, 64, 20
BATCH, BLOCK, N_STEPS, N_SUBMIT = 16, 4, 20, 5
F_DYN, F_BC, F_STATIC, INPUT_K = 2, 1, 4, (-3, -2, -1)
MATVEC_WIDTH = 1024
BARS = {"fp32": 1e-5, "bf16": 2e-2}
GRAD_BAR = 1e-5
SLICE_TOL = 3e-2
# the card-vs-CPU forward: a decision that differs must sit this close to
# its kink or tie (|x| or the max-pool gap, over the call's largest |x|),
# about a bf16 ulp of that |x| (2^-7 at most). Sound runs on an H100
# read up to 6.8e-3 at four seeds; one listed slot dropped from K1's list,
# 0.13 and more (scripts/torch_chip_readings.py gaps, PERF.md)
GAP_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}   # fp32 non-tensor; bf16 dense
KERNEL, PLAIN_KERNEL = "bcsr_super_spmm", "bcsr_spmm"
ROW_KERNEL, PLAIN_ROW_KERNEL = "bcsr_super_spmm_rows", "bcsr_spmm_rows"
SOURCES = {KERNEL: "deepsphere_weather_torch/kernels/bcsr_super_spmm.cu",
           PLAIN_KERNEL: "deepsphere_weather_torch/kernels/bcsr_spmm.cu",
           ROW_KERNEL: "deepsphere_weather_torch/kernels/bcsr_super_spmm.cu"}
REPLACES = {KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:493",
            PLAIN_KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:340 "
                          "(_spmm_kernel_dma); :327 (_spmm_kernel, "
                          "round_a=False)",
            ROW_KERNEL: "deepsphere_weather_tpu/ops/pallas_spmm.py:402"}
# Block-sparse products per model call, from the channel plan
# (models/unet.py) and cheb_conv's K - 1 = 2 products per convolution:
# level 0 holds 5 convolutions (conv1 x2, uconv1 x2, uconv1_final), level
# 1 four (conv2, uconv2), level 2 two (conv3).
PRODUCTS_PER_LEVEL = (10, 8, 4)
LAUNCHES_PER_FORWARD = PRODUCTS_PER_LEVEL[0]
# The first convolution of AR iteration 0 acts on the raw input, which
# needs no gradient: its two products get no backward.
NO_GRAD_PRODUCTS = 2
# level-0 product widths per sample: conv1 (21 -> 64 -> 128, input side),
# uconv1 (256 -> 128 -> 64, Clenshaw), uconv1_final (64 -> 2, Clenshaw)
WIDTH_FEATURES = (21, 64, 128, 64, 2)
TRAIN_AR, TRAIN_CHECK_BATCH, TRAIN_STEPS = 6, 2, 10
HP64_AR, HP64_BATCH, HP64_STEPS = 2, 8, 3
TIME_WINDOWS, TIME_STEPS = 4, 4
LR, ADAM_EPS = 1e-3, 1e-7
# node- and data-parallel phases: steps, the fp32 check's level-0 threshold
# (so that level 0 stays block-sparse in fp32), the process-group timeout
# and each phase's limit (seconds)
NODE16_STEPS, MESH16_STEPS, NODE64_STEPS = 3, 1, 2
FP32_DENSE_THRESHOLD = 2048
PG_TIMEOUT_S, RANKS_LIMIT_S = 300, 900
# protocol16: the shipped flagship config through the CLI, bf16, epochs cut
# to fit about 90 s of training on an H100; AR20 forecasts
PROTOCOL_CONFIG = "configs/UNetSpherical/Healpix_400km/MaxPool-Graph_knn.json"
PROTOCOL_EPOCHS, PROTOCOL_AR_PREDICT = 12, 20
PROTOCOL_INPUT_K, PROTOCOL_CYCLE = (-18, -12, -6), 6
GATHERS_PER_FORWARD = sum(PRODUCTS_PER_LEVEL)
# seeded ReZero weights are scaled by this for training: at U(0.5, 1.5)
# the random network's rollout grows several-fold per iteration
TRAIN_REZERO_SCALE = 0.1
# torch-only helpers shared with the port's card tests
# (tests/torch_steer.py, tests/torch_grad_terms.py)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))


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


def device_ms(fn, n_iter=20, n_warm=3):
    """Mean device time of fn() over n_iter calls captured in one CUDA
    graph and replayed: no host enqueue between the calls, which would
    outlast a launch of a few microseconds and be timed instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(n_warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / n_iter


def host_ms(fn, n_iter=200):
    """Host time of one call of fn, its enqueue alone: the device keeps
    up with these launches, so the host clock does not wait on it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n_iter


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from deepsphere_weather_torch.kernels.build import _nvcc, load_kernels

    t0 = time.perf_counter()
    for k in load_kernels([KERNEL, PLAIN_KERNEL]):
        log("build", f"{k.name}: {'built' if k.built else 'loaded from cache'}"
                     f" ({k.path.name}), nvcc {k.nvcc_seconds:.1f} s")
        # one line per distinct report (each template instance repeats it)
        for line in dict.fromkeys(k.ptxas_log.splitlines()):
            if "registers" in line or "spill" in line:
                log("build", f"{k.name} ptxas: " + line.strip())
    log("build", f"both kernels in {time.perf_counter() - t0:.1f} s")
    # the bf16-x instances of both kernels must run on the tensor cores,
    # unspilled
    for name, body in ((KERNEL, "bcsr_super_spmm_tc"),
                       (PLAIN_KERNEL, "bcsr_spmm_tc")):
        check_tc_instances(load_kernels([name])[0], body, _nvcc())


def check_tc_instances(k, body, nvcc):
    """The registers and spills (ptxas) and the HGMMA count (cuobjdump
    -sass) of library k's instances of the tensor-core kernel `body`:
    raises if one spills or has no HGMMA instruction."""
    regs, spills, fn = {}, {}, None
    for line in k.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "bytes spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            spills[fn] = int(m[1]) + int(m[2])
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used")[1].split()[0])
        elif "wgmma" in line:     # e.g. ptxas serialising the wgmma
            log("build", f"{k.name} ptxas: " + line.strip())
    tc_fns = [f for f in regs if body in f]
    if k.built:
        log("build", f"{k.name} tensor-core instances ({body}): registers "
                     f"{[regs[f] for f in tc_fns]}, spill bytes "
                     f"{[spills.get(f, 0) for f in tc_fns]}")
        if not tc_fns or any(spills.get(f, 0) for f in tc_fns):
            raise AssertionError(f"{k.name}: a tensor-core instance spills "
                                 f"({spills})")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(k.path)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    tc = {f: n for f, n in counts.items() if body in f}
    log("build", f"{k.name} HGMMA instructions in the SASS of its "
                 f"tensor-core instances: {sorted(tc.values())}; elsewhere "
                 f"{sum(counts.values()) - sum(tc.values())}")
    if not tc or 0 in tc.values():
        raise AssertionError(f"{k.name}: a tensor-core instance has no "
                             f"HGMMA instruction ({tc})")


# ---------------------------------------------------------------------------
# One kernel against its plain version, and its bound
# ---------------------------------------------------------------------------

def _layout(op):
    """(kernel name, A blocks, block-column table, slot list or None) of
    op's forward product."""
    kind, a, idx, nz = op.forward_layout()
    return (KERNEL if kind == "super" else PLAIN_KERNEL), a, idx, nz


def _kernel_fns(name):
    from deepsphere_weather_torch.ops import bcsr

    if name == KERNEL:
        return bcsr.bcsr_super_spmm, bcsr.bcsr_super_spmm_reference
    return bcsr.bcsr_spmm, bcsr.bcsr_spmm_reference


def _bound(a, x, nnz_blocks, x_blocks, out_rows=None):
    """(bytes ms, operations ms) of L @ x at x's own, unpadded shape: the
    nonzero 128x128 blocks of A, the x rows they read (`x_blocks`
    128-row blocks) and the output (`out_rows` rows, x's by default) each
    moved once over HBM; the nonzero block products at the type's peak
    rate. The least time the card could take is the larger of the two."""
    import torch

    n, m = x.shape
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    out_size = 2 if dt == "bf16" else 4
    out_rows = n if out_rows is None else out_rows
    x_rows = min(x_blocks * 128, n)
    nbytes = (nnz_blocks * 128 * 128 * a.element_size()
              + x_rows * m * x.element_size() + out_rows * m * out_size)
    ops = 2.0 * nnz_blocks * 128 * 128 * m
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[dt]


def _block_counts(name, a, idx):
    """(nonzero 128x128 blocks, block slots, distinct block-columns of x
    the nonzero blocks read) of a super-row (`name` KERNEL) or plain
    layout's A blocks and block-column table."""
    if name == KERNEL:
        n_s, R, bs, ubs = a.shape
        blocks = a.view(n_s, R, bs, ubs // bs, bs).transpose(2, 3)
    else:
        blocks = a
    nz = (blocks != 0).flatten(start_dim=blocks.dim() - 2).any(dim=-1)
    # super-row: a slot's column is read if any of its R rows is nonzero
    cols_read = idx[nz.any(dim=1)] if name == KERNEL else idx[nz]
    return int(nz.sum()), nz.numel(), int(cols_read.unique().numel())


def _csr(L, device, dtype):
    import torch

    L = L.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr.astype(np.int64)),
        torch.from_numpy(L.indices.astype(np.int64)),
        torch.from_numpy(L.data), size=L.shape, device=device, dtype=dtype)


def measure(op, L, x, device, label, round_a=True, timed=True,
            plain_timed=True):
    """Kernel vs plain version on the same padded input, held to the bar
    of x's dtype (raises if it breaks it); times (`device_ms`) and bound."""
    import torch

    name, a, idx, nz = _layout(op)
    kernel, plain = _kernel_fns(name)
    kw = {"nz": nz} if name == KERNEL else {"nz": nz, "round_a": round_a}
    n, m = x.shape
    x_pad = torch.nn.functional.pad(x, (0, (-m) % 128, 0, op.rows - n))
    y = kernel(a, idx, x_pad, **kw)
    ref = plain(a, idx, x_pad, **kw)
    bar = BARS["bf16" if x.dtype == torch.bfloat16 else "fp32"]
    err_plain = rel_err(y.float().cpu(), ref.float().cpu())
    if not err_plain < bar:
        raise AssertionError(f"{label}: {name} vs plain version "
                             f"{err_plain:.3e} breaks the {bar:g} bar")
    res = {"max_abs_err": float((y.float() - ref.float()).abs().max()),
           "rel_err_plain": err_plain, "y": y[:n, :m]}
    if not timed:
        return res
    # the library's call for the same function: fp32 A kept against bf16 x
    # (K4's regime) is fp32 CSR against x widened to fp32 (fp32 out)
    lib_dt = (torch.float32 if name != KERNEL and not round_a
              and a.dtype == torch.float32 else x.dtype)
    csr, x_lib = _csr(L, device, lib_dt), x.to(lib_dt)
    nnz, slots, x_blocks = _block_counts(name, a, idx)
    t_bytes, t_ops = _bound(a, x, nnz, x_blocks)
    res.update({
        "blocks_nonzero": f"{nnz}/{slots}", "x_blocks": x_blocks,
        "ms": device_ms(lambda: kernel(a, idx, x_pad, **kw)),
        "host_ms": host_ms(lambda: kernel(a, idx, x_pad, **kw)),
        "plain_ms": (device_ms(lambda: plain(a, idx, x_pad, **kw), n_iter=5)
                     if plain_timed else None),
        "library_ms": device_ms(lambda: torch.sparse.mm(csr, x_lib)),
        "library_dtype": str(lib_dt).replace("torch.", ""),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops})
    return res


def _fmt(res):
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in res.items() if k != "y" and v is not None)


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------

def _laplacian(subdiv):
    from deepsphere_weather_torch.models.geometry import cached_graph_laplacian

    return cached_graph_laplacian(
        "healpix", {"subdivisions": subdiv, "nest": True}, KNN, "knn")[1]


def phase_parity(device, subdivs, width):
    """K1 and K3 forward against scipy and their plain versions."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import BlockSparseOperator

    rng = np.random.default_rng(SEED)
    errs = []
    for subdiv in subdivs:
        t0 = time.perf_counter()
        L = _laplacian(subdiv)
        x_np = rng.standard_normal((L.shape[0], width)).astype(np.float32)
        ref = L @ x_np
        log("parity", f"HEALPix-{subdiv}: {L.shape[0]} nodes, graph + scipy "
                      f"reference {time.perf_counter() - t0:.1f} s")
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = torch.from_numpy(x_np).to(device, dt)
            for rps in (2, 0):
                op = BlockSparseOperator.from_scipy(
                    L, dtype=dt, rows_per_super=rps, device=device)
                kname = _layout(op)[0]
                with torch.no_grad():
                    y = op.matvec(x)
                err = rel_err(y.float().cpu().numpy(), ref)
                res = measure(op, L, x, device, f"HEALPix-{subdiv} {name}")
                log("parity", f"{kname} HEALPix-{subdiv} {name} x[{L.shape[0]}"
                              f", {width}] A {tuple(_layout(op)[1].shape)}: "
                              f"rel err vs scipy {err:.3e} (bar "
                              f"{BARS[name]:g}), " + _fmt(res))
                if not err < BARS[name]:
                    raise AssertionError(
                        f"{kname} HEALPix-{subdiv} {name}: vs scipy "
                        f"{err:.3e} breaks the {BARS[name]:g} bar")
                errs.append(f"{kname} HEALPix-{subdiv} {name} {err:.3e} / "
                            f"{res['max_abs_err']:.3e}")
    log("parity", "rel err vs scipy / max abs err vs plain version: "
                  + "; ".join(errs))


def phase_parity_regimes(device, subdivs, batch):
    """K3 at the main path's widths (bf16, HEALPix-16) against scipy, and
    both regimes of fp32 A against bf16 x at each of `subdivs` (timed at
    the first: round_a=False is K4's function). Returns the widest error
    vs the plain version and K4's row (`measure` at the first subdiv)."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import BlockSparseOperator

    rng = np.random.default_rng(SEED + 4)
    L = _laplacian(subdivs[0])
    op = BlockSparseOperator.from_scipy(L, dtype=torch.bfloat16,
                                        rows_per_super=0, device=device)
    worst, k4 = 0.0, None
    for w in [batch * f for f in WIDTH_FEATURES]:
        x_np = rng.standard_normal((L.shape[0], w)).astype(np.float32)
        x = torch.from_numpy(x_np).to(device, torch.bfloat16)
        res = measure(op, L, x, device, f"width {w}", timed=False)
        err = rel_err(res["y"].float().cpu().numpy(),
                      L @ x.float().cpu().numpy())
        if not err < BARS["bf16"]:
            raise AssertionError(f"{PLAIN_KERNEL} width {w}: vs scipy "
                                 f"{err:.3e} breaks the {BARS['bf16']:g} bar")
        worst = max(worst, res["max_abs_err"])
        log("parity", f"{PLAIN_KERNEL} HEALPix-{subdivs[0]} bf16 width {w}: "
                      f"rel err vs scipy {err:.3e}, " + _fmt(res))
    # fp32 A against bf16 x: round_a=True (K3's regime) rounds A to bf16,
    # round_a=False (K4's) keeps it fp32; scipy holds each to its own A
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        op32 = BlockSparseOperator.from_scipy(L, dtype=torch.float32,
                                              rows_per_super=0, device=device)
        x = torch.from_numpy(rng.standard_normal(
            (L.shape[0], MATVEC_WIDTH)).astype(np.float32)).to(
                device, torch.bfloat16)
        xs = x.float().cpu().numpy()
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
        for round_a, L_ref in ((True, L_bf16), (False, L)):
            timed = subdiv == subdivs[0]
            res = measure(op32, L, x, device, f"round_a={round_a}",
                          round_a=round_a, timed=timed)
            err = rel_err(res["y"].float().cpu().numpy(), L_ref @ xs)
            if not err < BARS["bf16"]:
                raise AssertionError(f"{PLAIN_KERNEL} HEALPix-{subdiv} "
                                     f"round_a={round_a}: vs scipy {err:.3e}")
            worst = max(worst, res["max_abs_err"])
            if timed and not round_a:
                k4 = {k: res[k] for k in ("ms", "host_ms", "plain_ms",
                                          "library_ms", "library_dtype",
                                          "bound_ms", "bound_by",
                                          "max_abs_err")}
            log("parity", f"{PLAIN_KERNEL} HEALPix-{subdiv} fp32 A, bf16 "
                          f"x[{L.shape[0]}, {MATVEC_WIDTH}], round_a="
                          f"{round_a}: rel err vs scipy (A "
                          f"{'rounded to bf16' if round_a else 'fp32'}) "
                          f"{err:.3e} (bar {BARS['bf16']:g}), " + _fmt(res))
        split = split_check(L, device, subdiv)
        if subdiv == subdivs[0]:
            k4["split_reading"] = split
    return worst, k4


def split_check(L, device, subdiv):
    """K4's split told apart from K3's rounding, which the bf16 bar cannot
    do: on `split_probe`'s product (tests/torch_split_probe.py) the exact
    output is about 0, so max |y - A x| / max (|A| |x|) reads what the
    regime did to A. round_a=False (hi + lo) must read under SPLIT_BAR and
    round_a=True (hi alone) above it. Returns both readings."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import (BlockSparseOperator,
                                                   bcsr_spmm)
    from torch_split_probe import SPLIT_BAR, split_probe

    A, x_np, reading = split_probe(L, MATVEC_WIDTH, SEED + 5)
    op = BlockSparseOperator.from_scipy(A, dtype=torch.float32,
                                        rows_per_super=0, device=device)
    _, a, idx, nz = _layout(op)
    x = torch.nn.functional.pad(torch.from_numpy(x_np),
                                (0, 0, 0, op.rows - A.shape[0])).to(
                                    device, torch.bfloat16)
    got = {}
    for key, round_a in (("hi_lo", False), ("hi", True)):
        y = bcsr_spmm(a, idx, x, nz, round_a=round_a)
        got[key] = reading(y.float().cpu().numpy())
    log("parity", f"{PLAIN_KERNEL} HEALPix-{subdiv} split probe (fp32 A, "
                  f"bf16 x[{A.shape[0]}, {MATVEC_WIDTH}], A x = 0): max|y - "
                  f"Ax| / max(|A||x|) round_a=False (hi + lo) "
                  f"{got['hi_lo']:.3e}, round_a=True (hi) {got['hi']:.3e}, "
                  f"bar {SPLIT_BAR:.3e} between them")
    if not got["hi_lo"] < SPLIT_BAR < got["hi"]:
        raise AssertionError(
            f"{PLAIN_KERNEL} HEALPix-{subdiv} split probe: hi + lo "
            f"{got['hi_lo']:.3e} and hi {got['hi']:.3e} do not lie on either "
            f"side of {SPLIT_BAR:.3e}")
    return got


def phase_parity_backward(device, subdiv, width):
    """d/dx sum((Lx)^2) through each layout's autograd.Function against
    2 L^T (L x): the knn L (symmetric: the backward reuses the forward
    arrays) and D L with a random positive diagonal D (through the
    transposed layout)."""
    import torch
    from scipy import sparse

    from deepsphere_weather_torch.ops.bcsr import (
        BlockSparseOperator,
        launch_counts,
    )

    L = _laplacian(subdiv)
    rng = np.random.default_rng(SEED + 5)
    D = sparse.diags(rng.uniform(0.5, 2.0, L.shape[0]).astype(np.float32))
    x_np = rng.standard_normal((L.shape[0], width)).astype(np.float32)
    for label, mat, sym in (("knn L", L, True),
                            ("D L", (D @ L).tocsr(), False)):
        m64 = mat.astype(np.float64)
        want = 2.0 * (m64.T @ (m64 @ x_np.astype(np.float64)))
        for rps in (2, 0):
            op = BlockSparseOperator.from_scipy(
                mat, symmetric=sym, rows_per_super=rps, device=device)
            kname = _layout(op)[0]
            before = dict(launch_counts)
            x = torch.from_numpy(x_np).to(device).requires_grad_()
            y = op.matvec(x)
            if y.grad_fn is None:
                raise AssertionError(f"{kname}: L @ x has no grad_fn")
            (y ** 2).sum().backward()
            torch.cuda.synchronize()
            n_launch = launch_counts[kname] - before[kname]
            if n_launch != 2:
                raise AssertionError(f"{kname} {label}: {n_launch} launches "
                                     "for one forward and one backward")
            err = rel_err(x.grad.cpu().numpy(), want)
            log("parity", f"{kname} backward HEALPix-{subdiv} {label} "
                          f"({'same arrays' if sym else 'transposed ' + op.transpose_layout()[0] + ' layout'}"
                          f"), fp32 x[{L.shape[0]}, {width}]: d/dx sum((Lx)^2)"
                          f" vs 2 L^T (L x) {err:.3e} (bar {GRAD_BAR:g})")
            if not err < GRAD_BAR:
                raise AssertionError(f"{kname} backward {label}: {err:.3e} "
                                     f"breaks the {GRAD_BAR:g} bar")


def phase_parity_rows(device, subdivs, width):
    """K2 alone, and the plain layout's row range (fp32, bf16, and fp32 A
    against bf16 x in both regimes): each node shard's row-range launch,
    for 2 and 4 shards, against the rows of the full launch (exactly), its
    plain version (exactly in the fp32-x regimes, else at the bf16 bar)
    and scipy's rows (the bars)."""
    import torch
    import torch.nn.functional as F

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED + 12)
    # (kernel, A dtype, x dtype, round_a of the plain layout)
    checks = [(ROW_KERNEL, bf16, bf16, None), (ROW_KERNEL, f32, f32, None),
              (PLAIN_ROW_KERNEL, f32, f32, None),
              (PLAIN_ROW_KERNEL, bf16, bf16, None),
              (PLAIN_ROW_KERNEL, f32, bf16, True),
              (PLAIN_ROW_KERNEL, f32, bf16, False)]
    for subdiv in subdivs:
        L = _laplacian(subdiv)
        n = L.shape[0]
        x_np = rng.standard_normal((n, width)).astype(np.float32)
        L_bf16 = L.copy()
        L_bf16.data = torch.from_numpy(L.data).to(bf16).float().numpy()
        for kname, a_dt, x_dt, round_a in checks:
            op = BlockSparseOperator.from_scipy(
                L, dtype=a_dt, rows_per_super=2 if kname == ROW_KERNEL else 0,
                device=device)
            _, a, idx, nz = op.forward_layout()
            x = torch.from_numpy(x_np).to(device, x_dt)
            x_pad = F.pad(x, (0, 0, 0, op.rows - n))
            if kname == ROW_KERNEL:
                full = bcsr.bcsr_super_spmm(a, idx, x_pad, nz)
                rows_fn, plain_fn, kw = (bcsr.bcsr_super_spmm_rows,
                                         bcsr.bcsr_super_spmm_rows_reference,
                                         {"nz": nz})
            else:
                # round_a None: a regime it does not touch
                kw = {"nz": nz, "round_a": round_a is not False}
                full = bcsr.bcsr_spmm(a, idx, x_pad, **kw)
                rows_fn, plain_fn = (bcsr.bcsr_spmm_rows,
                                     bcsr.bcsr_spmm_rows_reference)
            # scipy with A as the product sees it (rounded to bf16 when
            # stored so, or against bf16 x with round_a)
            ref = ((L_bf16 if a_dt == bf16 or round_a else L)
                   @ x.float().cpu().numpy())
            bar = BARS["bf16" if x_dt == bf16 else "fp32"]
            # the bf16-x bodies sum on the tensor cores, in another order
            # than the plain version: held to the bar there, else exact
            exact = x_dt == f32
            label = (f"{kname} HEALPix-{subdiv} {str(a_dt)[6:]} A, "
                     f"{str(x_dt)[6:]} x[{n}, {width}]"
                     + ("" if round_a is None else f", round_a={round_a}"))
            unit = op.rows // a.shape[0]
            worst = {"plain": 0.0, "full": 0.0, "scipy": 0.0}
            for n_node, r in ((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)):
                # rank r's node range and the units (super-rows or row
                # blocks) that cover it
                v0, v1 = r * n // n_node, (r + 1) * n // n_node
                lo, hi = v0 // unit, -(-v1 // unit)
                y = rows_fn(a, idx, x_pad, lo, hi, **kw)
                want = plain_fn(a, idx, x_pad, lo, hi, **kw)
                e_plain = (float((y.float() - want.float()).abs().max())
                           if exact else rel_err(y.float().cpu(),
                                                 want.float().cpu()))
                e_full = float((y.float() - full[lo * unit:hi * unit]
                                .float()).abs().max())
                e_scipy = rel_err(y[v0 - lo * unit:v1 - lo * unit]
                                  .float().cpu().numpy(), ref[v0:v1])
                if (e_plain if exact else not e_plain < bar) or e_full \
                        or not e_scipy < bar:
                    raise AssertionError(
                        f"{label} rows [{v0}, {v1}): vs plain version "
                        f"{e_plain:.3e} ({'must be 0' if exact else 'bar'}),"
                        f" vs full launch {e_full:.3e} (must be 0), vs scipy "
                        f"{e_scipy:.3e} (bar {bar:g})")
                worst = {k: max(worst[k], e) for k, e in zip(
                    worst, (e_plain, e_full, e_scipy))}
            log("parity", f"{label}, 2 and 4 node shards (units of {unit} "
                          f"rows): vs plain version "
                          f"{'max abs error' if exact else 'rel err'} "
                          f"{worst['plain']:.3e}, max abs error vs the full "
                          f"launch's rows {worst['full']:.3e}; rel err vs "
                          f"scipy's rows {worst['scipy']:.3e} (bar {bar:g})")


# ---------------------------------------------------------------------------
# The forecast service (serving main path)
# ---------------------------------------------------------------------------

def tensor_info(n_node):
    n_in = F_STATIC + F_BC + F_DYN
    return {"input_n_feature": n_in, "output_n_feature": F_DYN,
            "input_n_time": len(INPUT_K), "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n_node}},
            "output_shape_info": {"dynamic": {"node": n_node}}}


def build_flagship(device, subdiv, params=None, geometry=None,
                   precision="bfloat16", dense_threshold=None):
    from deepsphere_weather_torch.models import UNetSpherical

    model = UNetSpherical(
        tensor_info(12 * subdiv ** 2), "healpix",
        {"subdivisions": subdiv, "nest": True}, knn=KNN, pool_method="max",
        increment_learning=True, numeric_precision=precision,
        dense_threshold=dense_threshold, geometry=geometry, device=device)
    if params is not None:
        model.load_state_dict(params)
    return model.eval()


def forward_vs_cpu(device, subdiv, params, x, nz=None):
    """The flagship's bf16 forward of x on the card and on the CPU plain
    path. A ReLU or max-pool decision that one bf16 rounding flips changes
    its output by O(1) (the seeded network amplifies it), so the CPU takes
    the card's decisions (`steer`). Returns the relative error of the
    network's output minus x_last (`err`; `err_own` with the CPU's own
    decisions), how far each decision that differed sat from its kink or
    tie (`gaps`) and the count of decisions. `nz` replaces the slot list
    of the card's level-0 operator (a planted fault, for
    scripts/torch_chip_readings.py)."""
    import torch
    from torch_steer import steer

    with torch.inference_mode():
        card_model = build_flagship(device, subdiv, params)
        if nz is not None:
            card_model.geometry.cheb_ops[0].bcsr.nz = nz
        decisions, _ = steer(card_model)
        y = card_model(x.to(device)).cpu()
        cpu_model = build_flagship(torch.device("cpu"), subdiv, params)
        y_own = cpu_model(x)
        _, gaps = steer(cpu_model, decisions)
        y_cpu = cpu_model(x)
    x_last = x[:, -1:, :, -F_DYN:]
    return {"err": rel_err((y - x_last).numpy(), (y_cpu - x_last).numpy()),
            "err_own": rel_err((y - x_last).numpy(),
                               (y_own - x_last).numpy()),
            "gaps": gaps, "decisions": sum(d.numel() for d in decisions)}


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
    launches = dict(launch_counts)
    n_fwd = forwards[0]
    svc.close()

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
    if (launches[KERNEL] != LAUNCHES_PER_FORWARD * n_fwd or n_fwd == 0
            or launches[PLAIN_KERNEL]):
        raise AssertionError(f"{launches} kernel launches for {n_fwd} "
                             f"forwards; want {LAUNCHES_PER_FORWARD} {KERNEL}"
                             " each and nothing else")
    log("slice", f"predict {batch} x {n_steps} steps -> {out.shape}, "
                 f"{N_SUBMIT} submits -> {[a.shape for a in answers]}; "
                 f"finite; {n_fwd} forwards, {launches[KERNEL]} {KERNEL} "
                 "launches")

    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), V, F_STATIC + F_BC + F_DYN)).astype(np.float32))
    r = forward_vs_cpu(device, subdiv, params, x)
    gap = max(r["gaps"], default=0.0)
    if not (r["err"] <= SLICE_TOL and gap <= GAP_TOL):
        raise AssertionError(f"card vs CPU forward {r['err']:.3e} (tol "
                             f"{SLICE_TOL}), worst differing decision "
                             f"{gap:.3e} from its kink or tie (tol {GAP_TOL})")
    log("slice", f"card vs CPU plain-path forward (network output minus "
                 f"x_last), the CPU taking the card's ReLU and max-pool "
                 f"decisions: rel err {r['err']:.3e} (tol {SLICE_TOL}); "
                 f"{len(r['gaps'])} of {r['decisions']} decisions differed "
                 f"from the CPU's own, the worst {gap:.3e} from its kink or "
                 f"tie (tol {GAP_TOL}); with the CPU's own decisions "
                 f"{r['err_own']:.3e}")

    xd = x.to(device)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(xd), n_iter=10)
    return {"launches": launches[KERNEL], "forwards": n_fwd,
            "step_ms": 1e3 * t_predict / n_steps,
            "submit_ms": 1e3 * t_submit, "forward_ms": forward_ms,
            "model": model}


# ---------------------------------------------------------------------------
# The training step (training main path)
# ---------------------------------------------------------------------------

def train_params(model, seed):
    """Seeded weights in the JAX layout, ReZero weights scaled down."""
    from deepsphere_weather_torch.weights import params_from_jax, seeded_params

    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict):
            block["rezero_weight"] *= TRAIN_REZERO_SCALE
    return params_from_jax(tree)


def train_batch(indexer, n_node, batch, device, seed):
    import torch

    rng = np.random.default_rng(seed)
    W = indexer.window_size
    arrs = {"dynamic": rng.standard_normal((batch, W, n_node, F_DYN)),
            "bc": rng.standard_normal((batch, W, n_node, F_BC)),
            "static": rng.standard_normal((n_node, F_STATIC))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrs.items()}


def train_setup(model, ar_iters):
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import AreaWeights

    indexer = ARIndexer.build(list(INPUT_K), [0], 1, ar_iters)
    area_w = AreaWeights(model.geometry.samplings[0],
                         device=next(model.parameters()).device)
    return indexer, area_w, np.ones(ar_iters + 1, np.float32)


def grads_of(model):
    return {k: p.grad.double().cpu() for k, p in model.named_parameters()}


def grads_close(grads, ref, sums, tol, what="card vs CPU"):
    """Every parameter gradient against the reference's, per key: max abs
    error over max abs of the reference's. A one-element gradient (a
    ReZero weight, the increment scale) is one sum over a block's output
    whose terms cancel: it is held against the sum of its terms'
    magnitudes (`sums`, from `term_sums` on the reference model). Returns
    (worst error, key)."""
    worst = (0.0, "")
    for k, g in grads.items():
        r = ref[k].double()
        if r.numel() == 1 and k not in sums:
            raise AssertionError(f"{k}: one element, but no sum of terms")
        scale = sums[k] if r.numel() == 1 else float(r.abs().max())
        e = float((g.double().cpu() - r).abs().max()) / scale
        worst = max(worst, (e, k))
        if not e <= tol:
            raise AssertionError(f"gradient of {k}: {what} {e:.3e} > {tol}")
    return worst


def phase_train_check(device, subdiv, batch):
    """(1) The first step's losses and gradients, card vs CPU plain path."""
    import torch

    from deepsphere_weather_torch.engine import make_ar_loss_fn
    from torch_grad_terms import term_sums

    out = []
    params = None
    for dev in (device, torch.device("cpu")):
        model = build_flagship(dev, subdiv).train()
        params = train_params(model, SEED + 6) if params is None else params
        model.load_state_dict(params)
        sums = term_sums(model)
        indexer, area_w, w = train_setup(model, TRAIN_AR)
        data = train_batch(indexer, model.input_n_node, batch, dev, SEED + 7)
        total, per_iter = make_ar_loss_fn(model, indexer, TRAIN_AR + 1)(
            data, w, area_w)
        total.backward()
        out.append((model, total.item(), per_iter.detach().cpu().numpy(),
                    sums))
    (model, total, per_iter, _), (cpu_model, total_c, per_iter_c, sums) = out
    e_total = rel_err(total, total_c)
    e_iter = rel_err(per_iter, per_iter_c)
    e_grad, worst_key = grads_close(grads_of(model), grads_of(cpu_model),
                                    sums, SLICE_TOL)
    log("train", f"(1) HEALPix-{subdiv} AR{TRAIN_AR} batch {batch}: loss "
                 f"{total:.6g} (CPU {total_c:.6g}), rel err {e_total:.3e}; "
                 f"per-iteration losses {np.round(per_iter, 5).tolist()} rel "
                 f"err {e_iter:.3e}; gradients: worst {e_grad:.3e} "
                 f"({worst_key}); tol {SLICE_TOL}")
    for e, what in ((e_total, "total loss"), (e_iter, "per-iteration losses")):
        if not e <= SLICE_TOL:
            raise AssertionError(f"card vs CPU {what}: {e:.3e} > {SLICE_TOL}")


def run_train(model, ar_iters, batch, n_steps, label):
    """The training main path: n_steps of make_train_step on one fixed
    batch, counts from 0. Returns losses and per-step launches."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    indexer, area_w, w = train_setup(model, ar_iters)
    data = train_batch(indexer, model.input_n_node, batch,
                       next(model.parameters()).device, SEED + 8)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, ar_iters + 1)
    at_forward = []
    hook = model.register_forward_hook(
        lambda *_: at_forward.append(dict(launch_counts)))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, per_iters, per_step = [], [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = dict(launch_counts)
        at_forward.clear()
        total, per_iter = step(data, w, area_w)
        losses.append(total)
        per_iters.append(per_iter)
        fwd = {k: at_forward[-1][k] - before[k] for k in before}
        bwd = {k: launch_counts[k] - at_forward[-1][k] for k in before}
        per_step.append((fwd, bwd))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    hook.remove()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} are not finite and "
                             "decreasing")
    log("train", f"{label}: {n_steps} steps, losses {losses[0]:.6g} -> "
                 f"{losses[-1]:.6g}, {seconds:.2f} s with the first step; "
                 f"launches {launches}")
    return {"losses": losses, "per_step": per_step, "launches": launches,
            "per_iter": torch.stack(per_iters).cpu().numpy(),
            "step": lambda: step(data, w, area_w)}


def check_launches(res, kernel, per_forward, n_calls, label, phase="train"):
    """Every step launched exactly per_forward * n_calls forward and that
    minus NO_GRAD_PRODUCTS backward products on `kernel`, no other
    kernel; returns (forward, backward) launch totals."""
    want_f = per_forward * n_calls
    want_b = want_f - NO_GRAD_PRODUCTS
    for i, (fwd, bwd) in enumerate(res["per_step"]):
        if (fwd[kernel], bwd[kernel]) != (want_f, want_b) or \
                sum(fwd.values()) != want_f or sum(bwd.values()) != want_b:
            raise AssertionError(
                f"{label} step {i}: forward {fwd}, backward {bwd}; want "
                f"{want_f} forward and {want_b} backward {kernel} launches")
    n = len(res["per_step"])
    log(phase, f"{label}: {want_f} forward + {want_b} backward {kernel} "
               f"launches in each of {n} steps, no other kernel")
    return want_f * n, want_b * n


def time_steps(steps, batch, card_line):
    """ms per train step of each of `steps` ({label: step}): windows of
    TIME_STEPS chained steps on the host clock, ended by
    torch.cuda.synchronize(), taken in turns (A B B A ...) so that drift
    on the card or its host falls on every label alike; best of
    TIME_WINDOWS windows each."""
    import torch

    labels = list(steps)
    best = dict.fromkeys(labels, float("inf"))
    for w in range(TIME_WINDOWS):
        for label in (labels if w % 2 == 0 else labels[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIME_STEPS):
                steps[label]()
            torch.cuda.synchronize()
            best[label] = min(best[label],
                              (time.perf_counter() - t0) / TIME_STEPS)
    for label in labels:
        log("times", f"{label}: {1e3 * best[label]:.2f} ms per train step, "
                     f"{batch / best[label]:.2f} samples/s (best of "
                     f"{TIME_WINDOWS} windows of {TIME_STEPS} steps, taken "
                     f"in turns; {card_line})")
    return {label: 1e3 * t for label, t in best.items()}


def phase_train(device, subdiv, card_line):
    """(2) the super-row level-0 operator (K1) and (3) the plain one
    (K3), batch 16, 10 steps each at the same weights."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator, ChebOperator

    model = build_flagship(device, subdiv).train()
    params = train_params(model, SEED + 9)
    model.load_state_dict(params)
    n_calls = TRAIN_AR + 1
    res2 = run_train(model, TRAIN_AR, BATCH, TRAIN_STEPS,
                     f"(2) HEALPix-{subdiv} AR{TRAIN_AR} batch {BATCH} K1")
    f2 = check_launches(res2, KERNEL, LAUNCHES_PER_FORWARD, n_calls, "(2)")

    geom = model.geometry
    op0 = ChebOperator(bcsr=BlockSparseOperator.from_scipy(
        _laplacian(subdiv), dtype=torch.bfloat16, rows_per_super=0,
        device=device))
    model3 = build_flagship(device, subdiv, params, geometry=dataclasses.replace(
        geom, cheb_ops=[op0] + list(geom.cheb_ops[1:]))).train()
    res3 = run_train(model3, TRAIN_AR, BATCH, TRAIN_STEPS,
                     f"(3) HEALPix-{subdiv} AR{TRAIN_AR} batch {BATCH} K3")
    f3 = check_launches(res3, PLAIN_KERNEL, LAUNCHES_PER_FORWARD, n_calls,
                        "(3)")
    e = rel_err(res3["losses"][0], res2["losses"][0])
    log("train", f"(3) vs (2) first-step loss: {res3['losses'][0]:.6g} vs "
                 f"{res2['losses'][0]:.6g}, rel err {e:.3e} (tol {SLICE_TOL})")
    if not e <= SLICE_TOL:
        raise AssertionError(f"(3) vs (2) first-step loss {e:.3e}")
    ms = time_steps({"(2) K1": res2["step"], "(3) K3": res3["step"]}, BATCH,
                    card_line)
    return {"model": model, "steps": {"K1": res2["step"], "K3": res3["step"]},
            "per_iter": res2["per_iter"], "launches": {
        KERNEL: f2, PLAIN_KERNEL: f3}, "ms": {"train16": ms["(2) K1"],
                                              "train16_plain": ms["(3) K3"]}}


def phase_train64(device, subdiv, card_line):
    import torch

    t0 = time.perf_counter()
    model = build_flagship(device, subdiv).train()
    if any(op.bcsr is None for op in model.geometry.cheb_ops):
        raise AssertionError("every HEALPix-64 level must be block-sparse")
    model.load_state_dict(train_params(model, SEED + 10))
    log("train64", f"UNetSpherical HEALPix-{subdiv} levels "
                   f"{model.geometry.n_nodes} (all block-sparse bf16), built "
                   f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = run_train(model, HP64_AR, HP64_BATCH, HP64_STEPS,
                    f"HEALPix-{subdiv} AR{HP64_AR} batch {HP64_BATCH} K1")
    launches = check_launches(res, KERNEL, sum(PRODUCTS_PER_LEVEL),
                              HP64_AR + 1, "train64")
    label = f"HEALPix-{subdiv} AR{HP64_AR} batch {HP64_BATCH}"
    ms = time_steps({label: res["step"]}, HP64_BATCH, card_line)[label]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train64", f"peak device memory {peak:.2f} GiB "
                   "(torch.cuda.max_memory_allocated)")
    products = check_step_products(model, res["step"], subdiv)
    return {"launches": launches, "ms": ms, "peak_gib": peak,
            "per_iter": res["per_iter"], "step": res["step"],
            "products": products}


def step_products(step):
    """Run one train step and record its block-sparse products: the
    (operator, width, dtype) of each `matvec`, and the (A blocks, padded
    width, dtype) of each kernel launch, forward and backward. A launch
    without its slot list (one that would skip no zero block) raises."""
    from deepsphere_weather_torch.ops import bcsr

    matvecs, launches = {}, set()
    matvec, kernel = bcsr.BlockSparseOperator.matvec, bcsr.bcsr_super_spmm

    def record_matvec(op, x):
        matvecs.setdefault((id(op), x.shape[1], x.dtype), op)
        return matvec(op, x)

    def record_launch(a, idx, x, nz=None):
        if nz is None:
            raise AssertionError("a K1 launch of the step had no slot list")
        launches.add((a.data_ptr(), x.shape[1], x.dtype))
        return kernel(a, idx, x, nz)

    bcsr.BlockSparseOperator.matvec = record_matvec
    bcsr.bcsr_super_spmm = record_launch
    try:
        step()
    finally:
        bcsr.BlockSparseOperator.matvec = matvec
        bcsr.bcsr_super_spmm = kernel
    return matvecs, launches


def check_step_products(model, step, subdiv):
    """Every level's K1 at each width one train step gives it, forward
    and backward: against its plain version on the same input (bf16 bar)
    and against scipy with that level's Laplacian; and every shape the
    step launched K1 at is one of those checked. Returns the (level,
    width, dtype, operator) of each product."""
    import torch

    from deepsphere_weather_torch.ops.bcsr import _fit_rows, _layout_rows

    matvecs, launched = step_products(step)
    ops = [c.bcsr for c in model.geometry.cheb_ops]
    device = next(model.parameters()).device
    rng = np.random.default_rng(SEED + 11)
    checked, worst = set(), {"plain": 0.0, "scipy": 0.0}
    products = sorted((next(i for i, o in enumerate(ops) if o is op), width,
                       dt, op) for (_, width, dt), op in matvecs.items())
    for level, width, dt, op in products:
        L = _laplacian(subdiv >> level)
        n, bar = L.shape[0], BARS["bf16" if dt == torch.bfloat16 else "fp32"]
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        g = torch.randn_like(x)
        label = f"HEALPix-{subdiv} level {level} width {width}"
        # forward: the kernel vs its plain version (raises), then vs scipy
        fwd = measure(op, L, x, device, label, timed=False)
        e_fwd = rel_err(fwd["y"].float().cpu(), L @ x.float().cpu().numpy())
        # backward: x.grad of <L x, g> through the operator's
        # autograd.Function, vs the plain version on the transposed
        # layout and vs scipy L^T g
        xg = x.clone().requires_grad_()
        op.matvec(xg).backward(g)
        layout_t = op.transpose_layout()
        kind, a_t, idx_t, nz_t = layout_t
        plain = _kernel_fns(KERNEL if kind == "super" else PLAIN_KERNEL)[1]
        g_pad = torch.nn.functional.pad(g, (0, (-width) % 128, 0, op.rows - n))
        want = plain(a_t, idx_t, _fit_rows(
            g_pad, _layout_rows(layout_t)).contiguous(),
            *(() if nz_t is None else (nz_t,)))[:n, :width]
        e_bwd_plain = rel_err(xg.grad.float().cpu(), want.float().cpu())
        e_bwd = rel_err(xg.grad.float().cpu(),
                        L.T @ g.float().cpu().numpy())
        log("train64", f"K1 {label} {str(dt)[6:]}: forward vs plain version "
                       f"{fwd['rel_err_plain']:.3e}, vs scipy {e_fwd:.3e}; "
                       f"backward vs plain version {e_bwd_plain:.3e}, vs "
                       f"scipy L^T g {e_bwd:.3e} (bar {bar:g})")
        for e, what in ((e_fwd, "forward vs scipy"),
                        (e_bwd_plain, "backward vs plain version"),
                        (e_bwd, "backward vs scipy")):
            if not e < bar:
                raise AssertionError(f"K1 {label}: {what} {e:.3e} breaks "
                                     f"the {bar:g} bar")
        worst["plain"] = max(worst["plain"], fwd["rel_err_plain"],
                             e_bwd_plain)
        worst["scipy"] = max(worst["scipy"], e_fwd, e_bwd)
        a = op.forward_layout()[1]
        checked.add((a.data_ptr(), width + (-width) % 128, dt))
        checked.add((a_t.data_ptr(), width + (-width) % 128, dt))
    if not launched <= checked:
        raise AssertionError(f"the step launched K1 at shapes no check "
                             f"covered: {sorted(launched - checked)}")
    log("train64", f"{len(matvecs)} (level, width) products of the step, "
                   f"forward and backward: worst vs plain version "
                   f"{worst['plain']:.3e}, vs scipy {worst['scipy']:.3e}; "
                   f"they cover all {len(launched)} launch shapes")
    return products


def time_step_products(products, subdiv, device, card_line):
    """The layouts side by side at each (level, width) shape of a train
    step's products (`check_step_products`): K1 on the step's super-row
    operator and K3 on the plain layout of the same level's Laplacian, per
    launch, beside the bound and cuSPARSE. K3 is held to its plain version
    (in `measure`) and to scipy (bf16 bar); the plain versions go untimed.
    Returns (K1 rows, K3 rows)."""
    import torch

    from deepsphere_weather_torch.ops import BlockSparseOperator

    rng = np.random.default_rng(SEED + 15)
    rows = {KERNEL: [], PLAIN_KERNEL: []}
    plain_ops = {}
    for level, width, dt, op in products:
        L = _laplacian(subdiv >> level)
        x = torch.from_numpy(rng.standard_normal((L.shape[0], width)).astype(
            np.float32)).to(device, dt)
        if level not in plain_ops:
            plain_ops[level] = BlockSparseOperator.from_scipy(
                L, dtype=dt, rows_per_super=0, device=device)
        for name, layout_op in ((KERNEL, op), (PLAIN_KERNEL, plain_ops[level])):
            label = f"{name} HEALPix-{subdiv} level {level} width {width}"
            r = measure(layout_op, L, x, device, label, plain_timed=False)
            line = (f"{name} HEALPix-{subdiv} level {level} {str(dt)[6:]} "
                    f"x[{L.shape[0]}, {width}]: {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f} ms by {r['bound_by']}, cuSPARSE "
                    f"{r['library_ms']:.4f} ms), blocks {r['blocks_nonzero']}")
            if name == PLAIN_KERNEL:
                bar = BARS["bf16" if dt == torch.bfloat16 else "fp32"]
                e = rel_err(r["y"].float().cpu(), L @ x.float().cpu().numpy())
                if not e < bar:
                    raise AssertionError(f"{label}: vs scipy {e:.3e} breaks "
                                         f"the {bar:g} bar")
                k1_ms = rows[KERNEL][-1]["ms"]
                line += (f", vs plain version {r['rel_err_plain']:.3e}, vs "
                         f"scipy {e:.3e} (bar {bar:g}); K3 / K1 "
                         f"{r['ms'] / k1_ms:.3f}")
            log("times", f"{line} ({card_line})")
            rows[name].append({"level": level, "width": width, "ms": r["ms"],
                               "bound_ms": r["bound_ms"],
                               "library_ms": r["library_ms"]})
    k1, k3 = (sum(r["ms"] for r in rows[k]) for k in (KERNEL, PLAIN_KERNEL))
    log("times", f"layouts over the HEALPix-{subdiv} step's {len(products)} "
                 f"shapes, one launch each: K1 (super-row) {k1:.4f} ms, K3 "
                 f"(plain) {k3:.4f} ms, K3 / K1 {k3 / k1:.3f} ({card_line})")
    return rows[KERNEL], rows[PLAIN_KERNEL]


# ---------------------------------------------------------------------------
# Node- and data-parallel training (spawned ranks sharing the card)
# ---------------------------------------------------------------------------

def _rank_main(rank, world, out_dir, tasks):
    """One spawned rank: join the `gloo` group (ranks share one card, and
    NCCL refuses two ranks on one device), run each (task, kwargs), and
    pickle the results."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        results = [task(rank, **kw) for task, kw in tasks]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_ranks(world, tasks):
    """The tasks on `world` spawned ranks; [rank][task] results. A rank
    that raises fails the call (the others are stopped); so does a run
    past RANKS_LIMIT_S, after every rank is killed."""
    import torch
    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(world, out_dir, tasks),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANKS_LIMIT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{RANKS_LIMIT_S} s")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _sharded_model(mesh, subdiv, param_seed, precision="bfloat16",
                   dense_threshold=None):
    """The flagship at `subdiv` with rank 0's seeded weights on every rank
    and this rank's node shard of the geometry."""
    from deepsphere_weather_torch.models import shard_geometry
    from deepsphere_weather_torch.ops import ShardedBlockSparseOperator
    from deepsphere_weather_torch.weights import broadcast_params

    model = build_flagship(mesh.device, subdiv, precision=precision,
                           dense_threshold=dense_threshold).train()
    model.load_state_dict(train_params(model, param_seed))
    broadcast_params(model, mesh)
    n = model.input_n_node
    model.geometry = shard_geometry(model.geometry, mesh)
    if not isinstance(model.geometry.cheb_ops[0].bcsr,
                      ShardedBlockSparseOperator):
        raise AssertionError("level 0 must run the row-sharded operator")
    return model, n


def rank_train(rank, device, subdiv, n_data, n_node, ar_iters, batch,
               n_steps, param_seed, check_products=False):
    """One rank of the sharded main path: n_steps of make_train_step(mesh)
    on its shard of the fixed batch of `run_train`, counts from 0. Per
    step: global losses, launches forward and backward (a forward hook
    reads the counters), gathers of each model call, host time; the
    parameters after, peak device memory."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )
    from deepsphere_weather_torch.parallel import (
        collective_counts,
        make_mesh,
        node_range,
        reset_collective_counts,
        shard_batch,
    )

    mesh = make_mesh(n_data=n_data, n_node=n_node, device=device)
    model, n = _sharded_model(mesh, subdiv, param_seed)
    v0, v1 = node_range(n, mesh)
    indexer, area_w, w = train_setup(model, ar_iters)
    data = shard_batch(train_batch(indexer, n, batch, mesh.device, SEED + 8),
                       mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, ar_iters + 1, mesh=mesh)
    at_start, at_end = [], []
    model.register_forward_pre_hook(lambda *_: at_start.append(
        collective_counts["all_gather"]))
    model.register_forward_hook(lambda *_: at_end.append(
        (dict(launch_counts), collective_counts["all_gather"])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0
    reset_launch_counts()
    reset_collective_counts()
    per_iter, per_step, gathers, seconds = [], [], [], []
    for _ in range(n_steps):
        before = dict(launch_counts)
        at_start.clear()
        at_end.clear()
        t0 = time.perf_counter()
        _, losses = step(data, w, area_w)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_iter.append(losses.cpu().numpy())
        fwd = {k: at_end[-1][0][k] - before[k] for k in before}
        bwd = {k: launch_counts[k] - at_end[-1][0][k] for k in before}
        per_step.append((fwd, bwd))
        gathers.append([e - s for s, (_, e) in zip(at_start, at_end)])
    out = {"mesh": (mesh.data_rank, mesh.node_rank), "node_range": (v0, v1),
           "per_iter": np.stack(per_iter), "per_step": per_step,
           "gathers": gathers, "seconds": seconds,
           "launches": dict(launch_counts),
           "collectives": dict(collective_counts),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": torch.cat([p.detach().reshape(-1).cpu()
                                for p in model.parameters()]).numpy()}
    if check_products:
        out["products"] = check_sharded_products(
            model, lambda: step(data, w, area_w), subdiv)
    return out


def rank_grads(rank, device, subdiv, n_data, n_node, batch):
    """The first fp32 step of one rank on an n_data x n_node mesh (level 0
    block-sparse fp32, K2), from `phase_train_check`'s weights and batch:
    the global per-iteration losses make_train_step returns and the
    gradients, reduced over the mesh, that Adam steps on."""
    import torch

    from deepsphere_weather_torch.engine import make_train_step
    from deepsphere_weather_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(n_data=n_data, n_node=n_node, device=device)
    model, n = _sharded_model(mesh, subdiv, SEED + 6, "float32",
                              FP32_DENSE_THRESHOLD)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = shard_batch(train_batch(indexer, n, batch, mesh.device, SEED + 7),
                       mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=ADAM_EPS)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(grads_of(model)))
    _, per_iter = make_train_step(model, indexer, opt, TRAIN_AR + 1,
                                  mesh=mesh)(data, w, area_w)
    return {"mesh": (mesh.data_rank, mesh.node_rank),
            "per_iter": per_iter.cpu().numpy(), "grads": grads}


def single_grads(device, subdiv, batch):
    """`rank_grads`' step in one process: the reference."""
    from deepsphere_weather_torch.engine import make_ar_loss_fn
    from torch_grad_terms import term_sums

    model = build_flagship(device, subdiv, precision="float32",
                           dense_threshold=FP32_DENSE_THRESHOLD).train()
    model.load_state_dict(train_params(model, SEED + 6))
    sums = term_sums(model)
    indexer, area_w, w = train_setup(model, TRAIN_AR)
    data = train_batch(indexer, model.input_n_node, batch, device, SEED + 7)
    total, per_iter = make_ar_loss_fn(model, indexer, TRAIN_AR + 1)(data, w,
                                                                    area_w)
    total.backward()
    return per_iter.detach().cpu().numpy(), grads_of(model), sums


def check_sharded_products(model, step, subdiv):
    """Every level's K2 at each width one sharded step gives it, forward
    and backward: against its plain version on the same input (bf16 bar:
    the tensor cores sum in another order) and against scipy's rows; every
    shape the step launched K2 at is one of those checked, and each launch
    had its slot list. All ranks run the same products, in one order (the
    backward gathers)."""
    import torch
    import torch.nn.functional as F

    from deepsphere_weather_torch.ops import bcsr

    matvecs, launched = {}, set()
    matvec, kernel = (bcsr.ShardedBlockSparseOperator.matvec,
                      bcsr.bcsr_super_spmm_rows)

    def record_matvec(op, x):
        matvecs.setdefault((id(op), x.shape[1], x.dtype), op)
        return matvec(op, x)

    def record_launch(a, idx, x, s0, s1, nz=None):
        if nz is None:
            raise AssertionError("a K2 launch of the step had no slot list")
        launched.add((a.data_ptr(), x.shape[1], x.dtype))
        return kernel(a, idx, x, s0, s1, nz)

    bcsr.ShardedBlockSparseOperator.matvec = record_matvec
    bcsr.bcsr_super_spmm_rows = record_launch
    try:
        step()
    finally:
        bcsr.ShardedBlockSparseOperator.matvec = matvec
        bcsr.bcsr_super_spmm_rows = kernel
    ops = [c.bcsr for c in model.geometry.cheb_ops]
    device = next(model.parameters()).device
    checked, worst, lines = set(), {"plain": 0.0, "scipy": 0.0}, []
    products = sorted((next(i for i, o in enumerate(ops) if o is op), width,
                       str(dt), op) for (_, width, dt), op in matvecs.items())
    for level, width, _, op in products:
        L = _laplacian(subdiv >> level)
        n, v0, v1 = L.shape[0], op.v0, op.v1
        dt = torch.bfloat16          # the flagship's bf16 activations
        rng = np.random.default_rng(SEED + 13 + level * 100003 + width)
        x = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        g = torch.from_numpy(rng.standard_normal((n, width)).astype(
            np.float32)).to(device, dt)
        m_pad = width + (-width) % 128
        errs = {}
        for what, layout, inp in (("forward", op.forward_layout(), x),
                                  ("backward", op.transpose_layout(), g)):
            _, a, idx, nz, r0, full_rows = layout
            inp_fit = F.pad(inp, (0, m_pad - width, 0, full_rows - n))
            y = kernel(a, idx, inp_fit, 0, a.shape[0], nz)
            errs[what + " plain"] = rel_err(y.float().cpu(), bcsr.
                bcsr_super_spmm_rows_reference(a, idx, inp_fit, 0, a.shape[0],
                                               nz).float().cpu())
            checked.add((a.data_ptr(), m_pad, dt))
        # through the operator: its forward rows and x.grad of <L x, g>
        xg = x[v0:v1].clone().requires_grad_()
        y = op.matvec(xg)
        y.backward(g[v0:v1])
        errs["forward scipy"] = rel_err(y.detach().float().cpu().numpy(), (
            L @ x.float().cpu().numpy())[v0:v1])
        errs["backward scipy"] = rel_err(xg.grad.float().cpu().numpy(), (
            L.T @ g.float().cpu().numpy())[v0:v1])
        label = f"HEALPix-{subdiv} level {level} width {width}"
        if not all(e < BARS["bf16"] for e in errs.values()):
            raise AssertionError(f"K2 {label}: {errs}")
        worst["plain"] = max(worst["plain"], errs["forward plain"],
                             errs["backward plain"])
        worst["scipy"] = max(worst["scipy"], errs["forward scipy"],
                             errs["backward scipy"])
        lines.append(f"{label} rows [{v0}, {v1}): " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items()))
    if not launched <= checked:
        raise AssertionError(f"the sharded step launched K2 at shapes no "
                             f"check covered: {sorted(launched - checked)}")
    return {"lines": lines, "worst": worst, "n_products": len(matvecs),
            "n_shapes": len(launched)}


def _check_rank_runs(phase, ranks, ref_per_iter, per_forward, n_calls):
    """The checks of a sharded training run, rank by rank: its
    per-iteration losses against the single-process run's first steps
    (SLICE_TOL), exactly per_forward * n_calls forward and that minus
    NO_GRAD_PRODUCTS backward K2 launches per step and nothing else, one
    gather per Laplacian product of every level in each model call (dense
    levels gather too); and parameters identical
    across ranks. Returns (forward, backward) K2 launches over ranks."""
    total = [0, 0]
    for r in ranks:
        label = f"rank {r['mesh']} nodes {r['node_range']}"
        e = rel_err(r["per_iter"], ref_per_iter[:len(r["per_iter"])])
        if not e <= SLICE_TOL:
            raise AssertionError(f"{phase} {label}: per-iteration losses vs "
                                 f"the single-process steps {e:.3e}")
        f, b = check_launches(r, ROW_KERNEL, per_forward, n_calls, label,
                              phase)
        total[0] += f
        total[1] += b
        if any(gs != [GATHERS_PER_FORWARD] * n_calls for gs in r["gathers"]):
            raise AssertionError(f"{phase} {label}: gathers per model call "
                                 f"{r['gathers']}, want {GATHERS_PER_FORWARD}")
        losses = np.round(r["per_iter"], 5).tolist()
        log(phase, f"{label}: losses per step {losses}, vs the "
                   f"single-process steps {e:.3e} (tol "
                   f"{SLICE_TOL}); {GATHERS_PER_FORWARD} gathers in each of "
                   f"{n_calls} model calls per step; collectives "
                   f"{r['collectives']}; host seconds per step "
                   f"{np.round(r['seconds'], 4).tolist()}; peak device "
                   f"memory {r['peak_gib']:.2f} GiB")
    for r in ranks[1:]:
        if not np.array_equal(r["params"], ranks[0]["params"]):
            raise AssertionError(f"{phase}: rank {r['mesh']}'s parameters "
                                 "differ from rank (0, 0)'s")
    log(phase, f"parameters after the steps identical on all {len(ranks)} "
               f"ranks ({ranks[0]['params'].size} values)")
    return tuple(total)


def _check_grad_ranks(phase, ranks, grad_ref, mesh_label):
    """Each rank's fp32 step (`rank_grads`) against the single-process
    card step's: per-iteration losses and every gradient key (SLICE_TOL,
    `grads_close`)."""
    per_iter, grads, sums = grad_ref
    for r in ranks:
        e_iter = rel_err(r["per_iter"], per_iter)
        e_grad, key = grads_close(r["grads"], grads, sums, SLICE_TOL,
                                  f"{mesh_label} vs one process")
        if not e_iter <= SLICE_TOL:
            raise AssertionError(f"{phase} fp32 rank {r['mesh']}: "
                                 f"per-iteration losses {e_iter:.3e}")
        log(phase, f"fp32 batch {TRAIN_CHECK_BATCH} step (level 0 "
                   f"block-sparse fp32, K2) on {mesh_label}, rank "
                   f"{r['mesh']}, vs one process on the card: per-iteration "
                   f"losses {e_iter:.3e}, reduced gradients worst "
                   f"{e_grad:.3e} ({key}); tol {SLICE_TOL} per key")


def phase_node(device, card_line, train_ref, train64_ref):
    """node16 (with its fp32 gradient check) and node64, on 2 ranks."""
    ranks = run_ranks(2, [
        (rank_train, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 1, "n_node": 2,
                      "ar_iters": TRAIN_AR, "batch": BATCH,
                      "n_steps": NODE16_STEPS, "param_seed": SEED + 9}),
        (rank_grads, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 1, "n_node": 2, "batch": TRAIN_CHECK_BATCH}),
        (rank_train, {"device": str(device), "subdiv": BIG_SUBDIV,
                      "n_data": 1, "n_node": 2,
                      "ar_iters": HP64_AR, "batch": HP64_BATCH,
                      "n_steps": NODE64_STEPS, "param_seed": SEED + 10,
                      "check_products": True})])
    node16 = [r[0] for r in ranks]
    k2 = {"node16": _check_rank_runs("node16", node16, train_ref,
                                     LAUNCHES_PER_FORWARD, TRAIN_AR + 1)}
    ms16 = 1e3 * min(max(r["seconds"][i] for r in node16)
                     for i in range(1, NODE16_STEPS))
    log("node16", f"HEALPix-{SLICE_SUBDIV} AR{TRAIN_AR} batch {BATCH} bf16 "
                  f"on 1 x 2: {ms16:.2f} ms per step (host clock, the "
                  f"slower rank, best step after the first; 2 ranks sharing "
                  f"one H100 over gloo: not a scaling number; {card_line})")
    grad_ref = single_grads(device, SLICE_SUBDIV, TRAIN_CHECK_BATCH)
    _check_grad_ranks("node16", [r[1] for r in ranks], grad_ref,
                      "1 data x 2 node ranks")
    node64 = [r[2] for r in ranks]
    k2["node64"] = _check_rank_runs("node64", node64, train64_ref,
                                    sum(PRODUCTS_PER_LEVEL), HP64_AR + 1)
    for r in node64:
        p = r["products"]
        for line in p["lines"]:
            log("node64", f"K2 {line}")
        log("node64", f"rank {r['mesh']}: {p['n_products']} (level, width) "
                      f"products of a sharded step, forward and backward: "
                      f"worst rel err vs plain version "
                      f"{p['worst']['plain']:.3e}, vs scipy's rows "
                      f"{p['worst']['scipy']:.3e} (bar "
                      f"{BARS['bf16']:g}); they cover all {p['n_shapes']} "
                      f"launch shapes")
    ms64 = 1e3 * max(r["seconds"][-1] for r in node64)
    log("node64", f"HEALPix-{BIG_SUBDIV} AR{HP64_AR} batch {HP64_BATCH} bf16 "
                  f"on 1 x 2: {ms64:.2f} ms for the last step (host clock, "
                  f"the slower rank; 2 ranks sharing one H100 over gloo: not "
                  f"a scaling number); peak device memory per rank "
                  f"{[round(r['peak_gib'], 2) for r in node64]} GiB "
                  f"({card_line})")
    return {"launches": k2, "ms16": ms16, "ms64": ms64,
            "peak64_gib": max(r["peak_gib"] for r in node64),
            "grad_ref": grad_ref}


def phase_mesh(device, card_line, train_ref, grad_ref):
    """mesh16: the HEALPix-16 step on 2 data x 2 node ranks, and the fp32
    gradient check of node16 on the same mesh."""
    ranks = run_ranks(4, [
        (rank_train, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 2, "n_node": 2, "ar_iters": TRAIN_AR,
                      "batch": BATCH, "n_steps": MESH16_STEPS,
                      "param_seed": SEED + 9}),
        (rank_grads, {"device": str(device), "subdiv": SLICE_SUBDIV,
                      "n_data": 2, "n_node": 2, "batch": TRAIN_CHECK_BATCH})])
    launches = _check_rank_runs("mesh16", [r[0] for r in ranks], train_ref,
                                LAUNCHES_PER_FORWARD, TRAIN_AR + 1)
    _check_grad_ranks("mesh16", [r[1] for r in ranks], grad_ref,
                      "2 data x 2 node ranks")
    log("mesh16", f"HEALPix-{SLICE_SUBDIV} AR{TRAIN_AR} batch {BATCH} on 2 "
                  f"data x 2 node ranks: both groups reduce; 4 ranks sharing "
                  f"one H100 over gloo ({card_line})")
    return launches


# ---------------------------------------------------------------------------
# The train -> predict -> verify protocol through the port's CLI
# ---------------------------------------------------------------------------

def _instrument_protocol():
    """Wrap the driver's step factories, the rollout and the stages of
    `cli.train_predict.main` (module attributes they are called through)
    to record, per part, the K1 launches (training forward and backward,
    validation, prediction), which step factories the trainer took, and
    each stage's wall time. Returns (record, undo)."""
    import torch

    import deepsphere_weather_torch.data.zarrstore as zarrstore
    import deepsphere_weather_torch.engine as engine
    import deepsphere_weather_torch.engine.prediction as prediction
    import deepsphere_weather_torch.engine.training as training
    import deepsphere_weather_torch.verif as verif
    from deepsphere_weather_torch.ops.bcsr import launch_counts

    rec = {"cached_steps": 0, "streaming_steps": 0, "train_forward": 0,
           "train_backward": 0, "validation": 0, "predict": 0,
           "seconds": {}, "models": [], "chunk_writes": 0,
           "chunk_write_s": 0.0, "writes_at": {}, "train_steps": 0}
    saved = []

    def k1():
        return launch_counts[KERNEL]

    def patch(module, name, new):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def hook(model):
        if any(m is model for m in rec["models"]):
            return
        rec["models"].append(model)
        at = [0]
        model.register_forward_pre_hook(lambda *_: at.__setitem__(0, k1()))

        def after(*_):
            if torch.is_grad_enabled():
                rec["train_forward"] += k1() - at[0]
        model.register_forward_hook(after)

    def counted(fn, part, kind=None):
        def make(model, *args, **kw):
            hook(model)
            if kind:
                rec[kind] += 1
            made = fn(model, *args, **kw)
            step, rest = (made[0], made[1:]) if isinstance(made, tuple) \
                else (made, None)

            def run(*a, **k):
                c, f = k1(), rec["train_forward"]
                out = step(*a, **k)
                if part == "train":
                    rec["train_steps"] += 1
                    rec["train_backward"] += (k1() - c) - (
                        rec["train_forward"] - f)
                else:
                    rec[part] += k1() - c
                return out
            return (run,) + rest if rest is not None else run
        return make

    def timed(module, name, stage):
        fn = getattr(module, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["seconds"][stage] = time.perf_counter() - t0
            rec["writes_at"][stage] = (rec["chunk_writes"],
                                       rec["chunk_write_s"])
            return out
        patch(module, name, run)

    patch(training, "make_cached_train_step", counted(
        training.make_cached_train_step, "train", "cached_steps"))
    patch(training, "make_train_step", counted(
        training.make_train_step, "train", "streaming_steps"))
    patch(training, "make_cached_validation_fn", counted(
        training.make_cached_validation_fn, "validation"))
    patch(training, "make_validation_fn", counted(
        training.make_validation_fn, "validation"))
    patch(prediction, "make_rollout_block", counted(
        prediction.make_rollout_block, "predict"))
    write_chunk = zarrstore.ZarrArray._write_chunk

    def counted_write(self, idx, data):
        t0 = time.perf_counter()
        write_chunk(self, idx, data)
        rec["chunk_writes"] += 1
        rec["chunk_write_s"] += time.perf_counter() - t0
    patch(zarrstore.ZarrArray, "_write_chunk", counted_write)
    timed(engine, "AutoregressiveTraining", "train")
    timed(engine, "AutoregressivePredictions", "predict")
    timed(engine, "rechunk_forecasts_for_verification", "rechunk")
    timed(verif, "deterministic", "verify")

    def undo():
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)
    return rec, undo


def _bare_step_ms(model, n_ar, batch, n_static, n_bc):
    """ms per bare train step of the trained model at the driver's last AR
    depth and batch, on one device-resident synthetic batch (no loader,
    no window gather): windows of TIME_STEPS steps, best of
    TIME_WINDOWS."""
    import torch

    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import make_train_step

    indexer = ARIndexer.build(list(PROTOCOL_INPUT_K), [0], PROTOCOL_CYCLE,
                              n_ar)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(SEED + 20)
    W, V = indexer.window_size, model.input_n_node
    data = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for k, shape in (
        ("dynamic", (batch, W, V, F_DYN)), ("bc", (batch, W, V, n_bc)),
        ("static", (V, n_static)))}
    opt = torch.optim.Adam(model.parameters(), lr=1e-5, eps=ADAM_EPS)
    step = make_train_step(model, indexer, opt, n_ar + 1)
    w = np.ones(n_ar + 1, np.float32)
    step(data, w)
    best = float("inf")
    for _ in range(TIME_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIME_STEPS):
            step(data, w)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / TIME_STEPS)
    return 1e3 * best


def phase_protocol(device, card_line, bare_ar6_ms):
    """protocol16: the flagship config (bf16, full width and depth)
    trained, forecast AR20 and verified through the port's CLI entry point
    (`cli.train_predict.main`) on toy HEALPix-16 data; then one --resume
    epoch. Returns K1's launches by part."""
    import shutil

    import torch

    from deepsphere_weather_torch.cli.train_predict import main as train_main
    from deepsphere_weather_torch.data import generate_toy_data
    from deepsphere_weather_torch.engine.prediction import ForecastDataset
    from deepsphere_weather_torch.native import bloscio
    from deepsphere_weather_torch.ops.bcsr import (
        launch_counts,
        reset_launch_counts,
    )

    root = tempfile.mkdtemp(prefix="dsw_protocol_")
    try:
        t0 = time.perf_counter()
        generate_toy_data(os.path.join(root, "data"),
                          sampling_kwargs={"subdivisions": SLICE_SUBDIV,
                                           "nest": True}, seed=SEED)
        t_data = time.perf_counter() - t0
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               PROTOCOL_CONFIG)) as f:
            cfg = json.load(f)
        shipped = {k: cfg["training_settings"][k]
                   for k in ("numeric_precision", "epochs")}
        cfg["training_settings"].update(numeric_precision="bfloat16",
                                        epochs=PROTOCOL_EPOCHS)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log("protocol16", f"{PROTOCOL_CONFIG}, cut: numeric_precision "
                          f"{shipped['numeric_precision']} -> bfloat16, "
                          f"epochs {shipped['epochs']} -> {PROTOCOL_EPOCHS}; "
                          "full width and depth, num_workers as shipped; toy "
                          f"HEALPix-{SLICE_SUBDIV} data, 1460 six-hour steps, "
                          f"seed {SEED} ({t_data:.1f} s)")

        rec, undo = _instrument_protocol()
        try:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            exp, gs = train_main(cfg_path, os.path.join(root, "data"),
                                 os.path.join(root, "exp"), force=True,
                                 ar_iterations_prediction=PROTOCOL_AR_PREDICT,
                                 device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(launch_counts)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            undo()
            torch.use_deterministic_algorithms(False)
        parts = {k: rec[k] for k in ("train_forward", "train_backward",
                                     "validation", "predict")}
        # the checks
        if rec["cached_steps"] == 0 or rec["streaming_steps"]:
            raise AssertionError(f"the trainer took the streaming loader "
                                 f"({rec['cached_steps']} device-cache step "
                                 f"factories, {rec['streaming_steps']} "
                                 "streaming)")
        for part, n in parts.items():
            if n <= 0:
                raise AssertionError(f"no {KERNEL} launch in {part}: "
                                     f"{parts}")
        if (launches[KERNEL] != sum(parts.values())
                or sum(launches.values()) != launches[KERNEL]):
            raise AssertionError(f"launches {launches} are not the parts' "
                                 f"{parts}")
        with open(os.path.join(exp, "training_info",
                               "ar_training_info.json")) as f:
            info = json.load(f)
        losses = info["training_total_loss"] + info["validation_total_loss"]
        if not losses or not np.isfinite(losses).all():
            raise AssertionError(f"logged losses not finite: {losses}")
        for rel_path in ("model_weights/model.npz", "training_info/state.json",
                         "model_skills/deterministic_global_skill.npz"):
            if not os.path.exists(os.path.join(exp, rel_path)):
                raise AssertionError(f"{rel_path} missing from {exp}")
        fc = ForecastDataset.open(os.path.join(
            exp, "model_predictions", "forecast_chunked",
            "test_forecasts.zarr"))
        arr = np.stack([fc.variables[n][...] for n in fc.feature_order], -1)
        want = (fc.n_frt, PROTOCOL_AR_PREDICT + 1, 12 * SLICE_SUBDIV ** 2,
                F_DYN)
        if arr.shape != want or not np.isfinite(arr).all():
            raise AssertionError(f"forecast store {arr.shape}, want {want} "
                                 "finite")
        rmse = np.asarray(gs["RMSE"])
        if not (rmse[PROTOCOL_AR_PREDICT] > rmse[1]).all():
            raise AssertionError(f"RMSE does not grow from lead 1 to lead "
                                 f"{PROTOCOL_AR_PREDICT}: {rmse[1]} -> "
                                 f"{rmse[PROTOCOL_AR_PREDICT]}")
        secs = rec["seconds"]
        sps = info["samples_per_sec"]
        driver_sps = float(np.median(sps[1:] if len(sps) > 1 else sps))
        with open(os.path.join(exp, "training_info", "state.json")) as f:
            n_ar = len(json.load(f)["ar_scheduler"]["absolute_weights"]) - 1
        batch = cfg["training_settings"]["training_batch_size"]
        bare_ms = _bare_step_ms(rec["models"][0], n_ar, batch, F_STATIC,
                                F_BC)
        log("protocol16", f"trained {rec['train_steps']} updates (scored "
                          f"every {cfg['training_settings']['scoring_interval']}) "
                          f"over {len(info['epoch_boundaries'])} epochs (AR "
                          f"{n_ar} at the end, growth at updates "
                          f"{info['ar_growth_events']}), losses finite: "
                          f"train {info['training_total_loss'][0]:.5f} -> "
                          f"{info['training_total_loss'][-1]:.5f}, val "
                          f"{info['validation_total_loss'][0]:.5f} -> "
                          f"{info['validation_total_loss'][-1]:.5f}; "
                          f"device-cache path ({rec['cached_steps']} step "
                          "factories, no streaming one)")
        log("protocol16", f"forecast store {arr.shape} finite; RMSE lead 1 "
                          f"{np.round(rmse[1], 4).tolist()} -> lead "
                          f"{PROTOCOL_AR_PREDICT} "
                          f"{np.round(rmse[PROTOCOL_AR_PREDICT], 4).tolist()} "
                          f"({fc.feature_order})")
        log("protocol16", f"wall seconds: data {t_data:.1f}, main "
                          f"{wall:.1f} (train {secs['train']:.1f}, predict "
                          f"{secs['predict']:.1f}, rechunk "
                          f"{secs['rechunk']:.1f}, verify "
                          f"{secs['verify']:.1f}); AR{PROTOCOL_AR_PREDICT} "
                          f"forecast {secs['predict'] / fc.n_frt:.4f} s per "
                          f"reference time ({fc.n_frt}); peak device memory "
                          f"{peak_gib:.2f} GiB ({card_line})")
        (n_p, s_p), (n_r, s_r) = (rec["writes_at"]["predict"],
                                  rec["writes_at"]["rechunk"])
        log("protocol16", f"zarr chunk writes (host, zlib or blosc): predict "
                          f"{n_p} in {s_p:.1f} s on its writer thread, "
                          f"rechunk {n_r - n_p} in {s_r - s_p:.1f} s")
        log("protocol16", f"training samples/s: driver {driver_sps:.2f} "
                          f"(median of {len(sps)} scoring intervals, "
                          f"validation excluded), bare step at AR{n_ar} "
                          f"batch {batch} {1e3 * batch / bare_ms:.2f} "
                          f"({bare_ms:.2f} ms), bare AR{TRAIN_AR} step of "
                          f"phase train {1e3 * BATCH / bare_ar6_ms:.2f} "
                          f"({bare_ar6_ms:.2f} ms) ({card_line})")
        log("protocol16", f"{KERNEL} launches: {parts} = "
                          f"{launches[KERNEL]}, no other kernel")
        with open(os.path.join(exp, "model_skills", "verify_stats.json")) as f:
            log("protocol16", f"verify_stats {json.load(f)}; libblosc "
                              f"{'loads' if bloscio.available() else 'absent'}"
                              " on this machine")

        # one --resume epoch from the checkpoint just written
        cfg["training_settings"]["epochs"] = 1
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(exp, "model_weights", "model.npz"), "rb") as f:
            weights = f.read()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            exp2, gs2 = train_main(cfg_path, os.path.join(root, "data"),
                                   os.path.join(root, "exp"), resume=True,
                                   ar_iterations_prediction=2, device=device,
                                   verbose=False)
        finally:
            torch.use_deterministic_algorithms(False)
        resumed = dict(launch_counts)
        with open(os.path.join(exp2, "training_info",
                               "ar_training_info.json")) as f:
            info2 = json.load(f)
        with open(os.path.join(exp2, "model_weights", "model.npz"), "rb") as f:
            changed = f.read() != weights
        if (len(info2["epoch_boundaries"]) != 1 or not info2["iterations"]
                or not changed or not np.isfinite(np.asarray(gs2["RMSE"])).all()
                or resumed[KERNEL] == 0):
            raise AssertionError(f"--resume did not train one more epoch: "
                                 f"epochs {info2['epoch_boundaries']}, "
                                 f"{len(info2['iterations'])} updates, "
                                 f"weights changed {changed}, launches "
                                 f"{resumed}")
        log("protocol16", f"--resume: loaded the checkpoint, one more epoch "
                          f"(scored to update {info2['iterations'][-1]}, weights "
                          f"changed), AR2 forecast finite, "
                          f"{resumed[KERNEL]} {KERNEL} launches, "
                          f"{time.perf_counter() - t0:.1f} s")
        return {"forward": parts["train_forward"] + parts["validation"]
                + parts["predict"], "backward": parts["train_backward"],
                "parts": parts}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Kernel rows
# ---------------------------------------------------------------------------

def kernel_row(name, op, device, subdiv, batch, launches):
    """A kernel at the 10 shapes one forward gives it (level 0, bf16,
    batch 16): per-launch averages."""
    import torch

    L = _laplacian(subdiv)
    widths = [batch * f for f in WIDTH_FEATURES]
    rng = np.random.default_rng(SEED + 2)
    acc = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    err = 0.0
    for w in widths:
        x = torch.from_numpy(rng.standard_normal((L.shape[0], w)).astype(
            np.float32)).to(device, torch.bfloat16)
        r = measure(op, L, x, device, f"{name} bf16 width {w}")
        log("times", f"{name} HEALPix-{subdiv} bf16 width {w}: "
                     f"{r['ms']:.4f} ms (host enqueue {r['host_ms']:.4f} ms,"
                     f" bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
                     f"cuSPARSE {r['library_ms']:.4f} ms), vs plain version "
                     f"{r['rel_err_plain']:.3e} (bar {BARS['bf16']:g}), "
                     f"blocks {r['blocks_nonzero']}, x blocks read "
                     f"{r['x_blocks']}")
        for k in acc:
            acc[k] += r[k] / len(widths)
        err = max(err, r["max_abs_err"])
    fwd = sum(f for f, _ in launches.values())
    bwd = sum(b for _, b in launches.values())
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": fwd + bwd,
            "launches_forward": fwd, "launches_backward": bwd,
            "launches_by_path": {p: list(v) for p, v in launches.items()},
            "max_abs_err": err, "ms": acc["ms"], "host_ms": acc["host_ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": acc["library_ms"]}


def row_range_times(kind, device, subdiv, batch):
    """A row-range kernel (K2 for kind "super", K3's row range for
    "plain") at the 10 level-0 shapes of one node16 forward (bf16, batch
    16), on rank 0's shard (rows [0, n/2)) against the full x: per-launch
    averages of its time (`device_ms`), its plain version's, cuSPARSE's on
    the CSR row slice against the full x and the bound; the largest max
    abs error vs the plain version (held to the bf16 bar: the tensor
    cores sum in another order)."""
    import torch
    import torch.nn.functional as F

    from deepsphere_weather_torch.ops import BlockSparseOperator, bcsr

    L = _laplacian(subdiv)
    n = L.shape[0]
    v0, v1 = 0, n // 2
    op = BlockSparseOperator.from_scipy(
        L, dtype=torch.bfloat16, rows_per_super=2 if kind == "super" else 0,
        device=device)
    _, a, idx, nz, r0, full_rows = op.row_shard(v0, v1, group=None).fwd
    name = ROW_KERNEL if kind == "super" else PLAIN_ROW_KERNEL
    fn, plain = ((bcsr.bcsr_super_spmm_rows, bcsr.bcsr_super_spmm_rows_reference)
                 if kind == "super" else
                 (bcsr.bcsr_spmm_rows, bcsr.bcsr_spmm_rows_reference))
    kw = {"nz": nz}
    csr = _csr(L[v0:v1], device, torch.bfloat16)
    nnz, slots, x_blocks = _block_counts(
        KERNEL if kind == "super" else PLAIN_KERNEL, a, idx)
    rng = np.random.default_rng(SEED + 14)
    acc = dict.fromkeys(("ms", "host_ms", "plain_ms", "library_ms",
                         "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    widths = [batch * f for f in WIDTH_FEATURES]
    err = 0.0
    for w in widths:
        x = torch.from_numpy(rng.standard_normal((n, w)).astype(
            np.float32)).to(device, torch.bfloat16)
        x_pad = F.pad(x, (0, (-w) % 128, 0, full_rows - n))
        args = (a, idx, x_pad, 0, a.shape[0])
        y, want = fn(*args, **kw), plain(*args, **kw)
        e = float((y.float() - want.float()).abs().max())
        e_rel = rel_err(y.float().cpu(), want.float().cpu())
        if not e_rel < BARS["bf16"]:
            raise AssertionError(f"{name} width {w}: vs plain version max abs "
                                 f"{e:.3e}, rel {e_rel:.3e}")
        err = max(err, e)
        t_bytes, t_ops = _bound(a, x, nnz, x_blocks, out_rows=v1 - v0)
        r = {"ms": device_ms(lambda: fn(*args, **kw)),
             "host_ms": host_ms(lambda: fn(*args, **kw)),
             "plain_ms": device_ms(lambda: plain(*args, **kw), n_iter=5),
             "library_ms": device_ms(lambda: torch.sparse.mm(csr, x)),
             "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
             "ops_ms": t_ops}
        log("times", f"{name} HEALPix-{subdiv} bf16 rows [{v0}, {v1}) "
                     f"of x[{n}, {w}]: {r['ms']:.4f} ms (host enqueue "
                     f"{r['host_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"cuSPARSE {r['library_ms']:.4f} ms), vs plain version "
                     f"max abs {e:.3e} rel {e_rel:.3e}, blocks {nnz}/{slots}, "
                     f"x blocks read {x_blocks}/{full_rows // 128}")
        for k in acc:
            acc[k] += r[k] / len(widths)
    acc["max_abs_err"] = err
    acc["bound_by"] = ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                       else "operations")
    return acc


def kernel_row_rows(device, subdiv, batch, launches):
    """K2's kernel row: `row_range_times` of the super-row layout."""
    r = row_range_times("super", device, subdiv, batch)
    fwd = sum(f for f, _ in launches.values())
    bwd = sum(b for _, b in launches.values())
    return {"name": ROW_KERNEL, "route": "cuda", "source": SOURCES[ROW_KERNEL],
            "replaces": REPLACES[ROW_KERNEL], "launches": fwd + bwd,
            "launches_forward": fwd, "launches_backward": bwd,
            "launches_by_path": {p: list(v) for p, v in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def _profile(fn, n, label):
    """Device time by kernel over n calls of fn (torch.profiler), and the
    device's busy share of the window's host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
                   f"host time ({100 * busy / wall_ms:.1f}%, profiler on)")
    for ms, count, key in rows[:15]:
        log("profile", f"{100 * ms / busy:5.1f}%  {ms / n:8.4f} ms/call  "
                       f"{count // n:4d}/call  {key[:90]}")
    for name in (KERNEL, PLAIN_KERNEL):
        mine = [r for r in rows if name + "_" in r[2]]
        if mine:
            t = sum(r[0] for r in mine)
            log("profile", f"{name}, all instances: {t / n:.4f} ms/call, "
                           f"{sum(r[1] for r in mine) // n}/call, "
                           f"{100 * t / busy:.1f}% of device time")


def phase_profile(model, device, batch, train_steps, step64, n_fwd=3,
                  n_steps=2):
    import torch

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.standard_normal(
        (batch, len(INPUT_K), model.input_n_node,
         F_STATIC + F_BC + F_DYN)).astype(np.float32)).to(device)

    def forward():
        with torch.inference_mode():
            model(x)

    _profile(forward, n_fwd, f"{n_fwd} forwards, batch {batch}")
    for label, step in train_steps.items():
        _profile(step, n_steps, f"{n_steps} AR{TRAIN_AR} train steps, batch "
                                f"{batch}, {label} at level 0")
    _profile(step64, n_steps, f"{n_steps} HEALPix-{BIG_SUBDIV} AR{HP64_AR} "
                              f"train steps, batch {HP64_BATCH}, K1 at every "
                              "level")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for 3 forwards, "
                         "2 train steps with each level-0 kernel and 2 "
                         "HEALPix-64 train steps")
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
    k3_err, k4 = phase_parity_regimes(device, (SLICE_SUBDIV, BIG_SUBDIV),
                                      BATCH)
    phase_parity_backward(device, SLICE_SUBDIV, MATVEC_WIDTH)
    phase_parity_backward(device, BIG_SUBDIV, MATVEC_WIDTH)
    phase_parity_rows(device, (SLICE_SUBDIV, BIG_SUBDIV), MATVEC_WIDTH)
    fig = phase_slice(device, SLICE_SUBDIV, BATCH, N_STEPS)
    phase_train_check(device, SLICE_SUBDIV, TRAIN_CHECK_BATCH)
    tr = phase_train(device, SLICE_SUBDIV, card_line)
    tr64 = phase_train64(device, BIG_SUBDIV, card_line)
    node = phase_node(device, card_line, tr["per_iter"], tr64["per_iter"])
    node["launches"]["mesh16"] = phase_mesh(device, card_line,
                                            tr["per_iter"], node["grad_ref"])

    from deepsphere_weather_torch.ops import BlockSparseOperator

    op3 = BlockSparseOperator.from_scipy(
        _laplacian(SLICE_SUBDIV), dtype=torch.bfloat16, rows_per_super=0,
        device=device)
    rows = [
        kernel_row(KERNEL, fig["model"].geometry.cheb_ops[0].bcsr, device,
                   SLICE_SUBDIV, BATCH, {
                       "serve": (fig["launches"], 0),
                       "train16": tr["launches"][KERNEL],
                       "train64": tr64["launches"]}),
        kernel_row(PLAIN_KERNEL, op3, device, SLICE_SUBDIV, BATCH,
                   {"train16_plain": tr["launches"][PLAIN_KERNEL]}),
        kernel_row_rows(device, SLICE_SUBDIV, BATCH, node["launches"]),
    ]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], k3_err)
    # K4's function: K3's kernel with round_a=False (fp32 A, bf16 x)
    rows[1]["round_a_false"] = k4
    # K3's row range beside K2, on the same shard (parity phase only on
    # the main paths: the geometry builds the super-row layout)
    k3_rows = row_range_times("plain", device, SLICE_SUBDIV, BATCH)
    rows[1]["rows_range"] = {k: k3_rows[k] for k in (
        "ms", "host_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    k1_64, k3_64 = time_step_products(tr64["products"], BIG_SUBDIV, device,
                                      card_line)
    rows[0]["train64_shapes"] = k1_64
    rows[1]["train64_shapes"] = k3_64
    log("times", f"slice: {fig['step_ms']:.2f} ms per forecast step (batch "
                 f"{BATCH}, host clock, {N_STEPS} steps), {fig['submit_ms']:.1f} "
                 f"ms for {N_SUBMIT} concurrent submits, forward "
                 f"{fig['forward_ms']:.3f} ms (CUDA events); {KERNEL} "
                 f"{rows[0]['ms']:.4f} ms, {PLAIN_KERNEL} {rows[1]['ms']:.4f} "
                 f"ms per launch; train step HEALPix-{SLICE_SUBDIV} batch "
                 f"{BATCH}: K1 {tr['ms']['train16']:.2f} ms, K3 "
                 f"{tr['ms']['train16_plain']:.2f} ms; HEALPix-{BIG_SUBDIV} "
                 f"batch {HP64_BATCH}: {tr64['ms']:.2f} ms, "
                 f"{tr64['peak_gib']:.2f} GiB peak; {ROW_KERNEL} "
                 f"{rows[2]['ms']:.4f} ms per launch ({PLAIN_ROW_KERNEL} "
                 f"{k3_rows['ms']:.4f} ms); K4 ({PLAIN_KERNEL}, round_a="
                 f"False) {k4['ms']:.4f} ms; over the HEALPix-{BIG_SUBDIV} "
                 f"step's {len(k1_64)} shapes {KERNEL} "
                 f"{sum(r['ms'] for r in k1_64):.4f} ms, {PLAIN_KERNEL} "
                 f"{sum(r['ms'] for r in k3_64):.4f} ms; on 2 ranks sharing the "
                 f"card (not a scaling number): HEALPix-{SLICE_SUBDIV} "
                 f"{node['ms16']:.2f} ms, HEALPix-{BIG_SUBDIV} "
                 f"{node['ms64']:.2f} ms per step, {node['peak64_gib']:.2f} "
                 f"GiB peak per rank ({card_line})")
    if args.profile:
        phase_profile(tr["model"], device, BATCH, tr["steps"], tr64["step"])
    proto = phase_protocol(device, card_line, tr["ms"]["train16"])
    rows[0]["launches_by_path"]["protocol16"] = [proto["forward"],
                                                 proto["backward"]]
    rows[0]["launches_protocol16"] = proto["parts"]
    rows[0]["launches_forward"] += proto["forward"]
    rows[0]["launches_backward"] += proto["backward"]
    rows[0]["launches"] += proto["forward"] + proto["backward"]
    log("times", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
