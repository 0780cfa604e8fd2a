#!/usr/bin/env python3
"""Card readings of the PyTorch/CUDA port that chip_smoke.py does not take.

Run on one NVIDIA GPU from the root of a checkout; it imports that tree's
chip_smoke.py:

    python3 scripts/torch_chip_readings.py gaps
    python3 scripts/torch_chip_readings.py ab TAG
    python3 scripts/torch_chip_readings.py ell TAG
    python3 scripts/torch_chip_readings.py remat
    python3 scripts/torch_chip_readings.py members TAG
    python3 scripts/torch_chip_readings.py remap
    python3 scripts/torch_chip_readings.py frag [M]
    python3 scripts/torch_chip_readings.py alloc
    python3 scripts/torch_chip_readings.py gather

gaps  The slice phase's card-vs-CPU forward check (HEALPix-16 bf16 flagship,
      batch 16, the CPU taking the card's ReLU and max-pool decisions) at
      four seeds of weights and input, then at seed 0 with planted faults:
      one listed slot of one level-0 row block dropped from the list K1
      walks, the block of the smallest, the median and the largest norm.
      One line per run: the output's relative error, the worst gap of a
      differing decision from its kink or tie, the count of differing
      decisions; for a fault also the one K1 launch's relative error
      against the plain version at x [3072, 1024].
ab    The HEALPix-16 AR6 batch-16 bf16 train step (3 steps, then
      chip_smoke's `time_steps`: best of 4 windows of 4 steps) and the
      served model's forward (CUDA events over 20 forwards) of the tree it
      runs from: one line `AB {json}` tagged TAG. Run it on two trees in
      turns (A, B, B, A) in one call to compare them on one card.
ell   The ELL kernel's readings of the tree it runs from, through that
      tree's chip_smoke.py (so a parent tree reads its own kernel): per
      launch at x[3072, 1024] and x[49152, 1024] (`measure_ell`: against
      its plain version exactly, beside its bound, plain version and
      cuSPARSE), its row ranges at HEALPix-64 (`parity_ell_rows`: checked,
      rank 0's of 2 timed), and the train64f32 step (the shipped fp32
      HEALPix-64 config, AR2 batch 8): 3 steps, their ELL launches, the
      step time (`time_steps`), each (level, width) shape it launches
      (`ell_step_shapes`) and device time by kernel over 2 steps
      (torch.profiler: busy share of the host time, the ELL kernel's
      share, the top rows). One line `ELL {json}` tagged TAG. Run it from
      a parent archive's root and this one's in turns (A, B, B, A).
remat Where the member step's peak device memory is set: chip_smoke's
      remat16 step (2 flagship members, bf16, batch 16; ens16's weights
      and batch) at AR6 and at AR0 (one model call), with and without
      remat, and the single model's AR6 step: each step's own peak (over
      what was allocated before it, after a first step). Then for the
      AR6 member step with and without remat, the allocator's history
      over one step (`torch.cuda.memory._record_memory_history`): the
      largest blocks live at the step's peak, with the Python frames that
      allocated them. One line `REMAT {json}`.
members
      ens16's and remat16's member steps of the tree it runs from (2
      flagship members, bf16, AR6, batch 16; remat16's weights and batch:
      the member step without remat and with), and the single model's
      AR6 step on member 0's weights: each step's own peak (as `remat`
      reads it) and its time (chip_smoke's `time_steps`, the three in
      turns), then device time by kernel over 2 member steps without
      remat (`profile_steps`). One line `MEMBERS {json}` tagged TAG. Run
      it from a parent archive's root and this one's in turns (A, B, B,
      A).
remap The host work of the ingest and geometry layers on the card
      machine's host (no kernel runs): the remap geometry of the shipped
      Healpix_100km/InterpPool-Graph_knn config, each of its pool pairs
      (HEALPix-64 -> 32 -> 16) through the native library
      (`native.geometry.conservative_weights`; its g++ build timed
      before) and its plain numpy version
      (`sphere.remap._conservative_weights_numpy`): seconds and max abs
      difference; the config's whole model geometry (`models.get_model`,
      fp32, on the card) built into an empty disk cache: seconds; then
      the native bulk chunk reader against the per-chunk Python path
      (chip_smoke's `_bulk_vs_chunks`) on protocol16's store (the port's
      `cli.prepare_toy_data` at HEALPix-16, 1460 six-hour steps): equal,
      seconds, bytes. One line `REMAP {json}`.
frag  The largest member stack on the allocator settings the port itself
      asks for. The shipped Healpix_100km MaxPool knn configuration's member
      step (fp32 HEALPix-64, batch 16, AR6 RNN, remat, its lr and
      clipping; chip_smoke's ens64 weights, seeds 1000 + m, and batch) of
      M members (7 by default), one step in each of two fresh processes,
      both of which call `_device.ask_expandable_segments()` first, as the
      port's entry points do: (a) with PYTORCH_CUDA_ALLOC_CONF=
      expandable_segments:False in its environment, the allocator's
      default segments, which the port leaves as the user set them; the
      allocator's history recorded over the step
      (`torch.cuda.memory._record_memory_history`); if the step runs out
      of memory, the error, the allocator's counters and, from
      `torch.cuda.memory._snapshot()` at the failure, its segments (size,
      free bytes, largest free block) and the tensors whose freed blocks
      make up the free bytes, by the port frames that allocated them
      (sizes summed); (b) with no variable: the port asks for expandable
      segments; the step's own peak past its start and its ms. One line
      `FRAG {json}` per process, then one line `FRAG_BOTH {json}`.
alloc What the port's allocator setting costs a step: the shipped
      Healpix_100km MaxPool knn configuration's single train step (fp32
      HEALPix-64, batch 16, AR6 RNN, remat, ens64's weights of member 0
      and batch), in one fresh process on the default segments
      (PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False, which the port
      keeps) and one on the port's own setting, in turns (default, port,
      port, default): 3 steps, then 3 more timed on a warm allocator
      cache (host clock to torch.cuda.synchronize(), the best), then one
      timed right after torch.cuda.empty_cache(), which hands the cached
      memory back (a step after it must map its pages again with
      expandable segments, or allocate them again with the default). One
      line `ALLOC {json}` per process.
gather The block layouts' fp32-x and mixed regimes (`spmm_regime`: the
      gather body; fp32 A rounded to bf16 against bf16 x on the tensor
      cores) per launch at x[3072, 1024] and x[49152, 1024] (HEALPix-16
      and -64 level 0): K1 and K3 with fp32 and bf16-stored A against fp32
      x, K2's and K3's row ranges (rows [0, n/2)), K1 with fp32 A against
      bf16 x; each held to its plain version (chip_smoke's `measure`: the
      fp32 bar 1e-5, bf16 2e-2) and timed (`device_ms`) beside
      torch.sparse.mm on the same matrix and its bound. One line
      `GATHER {json}`.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as c  # noqa: E402


def drop_slot(nz, g, j):
    """nz with the j-th listed slot of row block g (flattened) dropped."""
    out = nz.clone().view(-1, nz.shape[-1])
    n = int(out[g, 0])
    listed = out[g, 1:1 + n].clone()
    out[g, 1:n] = torch.cat([listed[:j], listed[j + 1:]])
    out[g, 0] = n - 1
    return out.view(nz.shape)


def gaps(device):
    from deepsphere_weather_torch.ops import bcsr
    from deepsphere_weather_torch.weights import params_from_jax, seeded_params

    model = c.build_flagship(device, c.SLICE_SUBDIV)
    V = model.input_n_node

    def run(seed, nz=None):
        params = params_from_jax(seeded_params(model, seed))
        x = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(
            (c.BATCH, len(c.INPUT_K), V, c.F_STATIC + c.F_BC + c.F_DYN))
            .astype(np.float32))
        r = c.forward_vs_cpu(device, c.SLICE_SUBDIV, params, x, nz)
        return {"err": r["err"], "err_own": r["err_own"],
                "worst_gap": max(r["gaps"], default=0.0),
                "differed": len(r["gaps"]), "decisions": r["decisions"]}

    for seed in range(4):
        print("GAPS " + json.dumps({"run": "sound", "seed": seed,
                                    **run(seed)}), flush=True)
    op = model.geometry.cheb_ops[0].bcsr
    a, idx, nz = op.svals, op.ucols, op.nz
    n_s, R, bs, ubs = a.shape
    norms = (a.float().view(n_s * R, bs, ubs // bs, bs).pow(2).sum((1, 3))
             .sqrt().cpu())
    flat = nz.view(n_s * R, -1).cpu()
    blocks = sorted((float(norms[g, int(flat[g, 1 + j])]), g, j)
                    for g in range(n_s * R) for j in range(int(flat[g, 0])))
    x = torch.from_numpy(np.random.default_rng(c.SEED).standard_normal(
        (op.rows, c.MATVEC_WIDTH)).astype(np.float32)).to(device,
                                                           torch.bfloat16)
    want = bcsr.bcsr_super_spmm_reference(a, idx, x, nz).float().cpu()
    for which, (norm, g, j) in (("smallest", blocks[0]),
                                ("median", blocks[len(blocks) // 2]),
                                ("largest", blocks[-1])):
        bad = drop_slot(nz, g, j)
        k1 = bcsr.bcsr_super_spmm(a, idx, x, bad).float().cpu()
        print("GAPS " + json.dumps({
            "run": f"fault: {which} block dropped", "row_block": g,
            "slot": int(flat[g, 1 + j]), "block_norm": norm,
            "k1_rel_err": c.rel_err(k1.numpy(), want.numpy()),
            "seed": 0, **run(0, bad)}), flush=True)


def ab(device, tag):
    card = c.card()
    model = c.build_flagship(device, c.SLICE_SUBDIV).train()
    model.load_state_dict(c.train_params(model, c.SEED + 9))
    res = c.run_train(model, c.TRAIN_AR, c.BATCH, 3, "A/B")
    ms = c.time_steps({"step": res["step"]}, c.BATCH, card)["step"]
    fmodel = c.build_flagship(device, c.SLICE_SUBDIV)
    x = torch.randn(c.BATCH, 3, fmodel.input_n_node, 7, device=device)
    with torch.inference_mode():
        fwd = c.time_ms(lambda: fmodel(x), n_iter=20)
    print("AB " + json.dumps({"tree": tag, "step_ms": ms, "forward_ms": fwd,
                              "card": card}), flush=True)


def profile_steps(step, n=2):
    """Device time by kernel over n calls of step (torch.profiler): the
    busy share of the window's host time, the ELL kernel's share of the
    busy time and the top 12 rows."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    ell = sum(r[0] for r in rows if "ell_spmm" in r[2])
    return {"steps": n, "busy_ms_per_step": busy / n,
            "host_ms_per_step": wall / n, "busy_share": busy / wall,
            "ell_ms_per_step": ell / n, "ell_share_of_busy": ell / busy,
            "top": [{"share": ms / busy, "ms_per_step": ms / n,
                     "calls_per_step": count // n, "kernel": key[:100]}
                    for ms, count, key in rows[:12]]}


def ell(device, tag):
    from deepsphere_weather_torch.ops import EllOperator

    card = c.card()
    rng = np.random.default_rng(c.SEED)
    out = {"tree": tag, "card": card}
    for subdiv in (c.SLICE_SUBDIV, c.BIG_SUBDIV):
        L = c._laplacian(subdiv)
        x = torch.from_numpy(rng.standard_normal(
            (L.shape[0], c.MATVEC_WIDTH)).astype(np.float32)).to(device)
        r = c.measure_ell(EllOperator.from_scipy(L, device=device), L, x,
                          device, f"x[{L.shape[0]}, {c.MATVEC_WIDTH}]")
        out[f"x{L.shape[0]}_{c.MATVEC_WIDTH}"] = {
            k: v for k, v in r.items() if k != "y"}
    x_np = rng.standard_normal((L.shape[0], c.MATVEC_WIDTH)).astype(
        np.float32)
    out["rows"] = c.parity_ell_rows(device, L, x_np, c.BIG_SUBDIV, rng)
    cfg = c._grids_config(c.F32_CONFIG)
    model = c.grids_model(device, cfg, "float32").train()
    model.load_state_dict(c.train_params(model, c.SEED + 40))
    label = f"train64f32 {tag}"
    res = c.run_train(model, c.HP64_AR, c.HP64_BATCH, c.HP64_STEPS, label,
                      clip=cfg["training_settings"]["gradient_clipping"],
                      phase="ell")
    out["launches"] = c.check_launches(res, c.ELL_KERNEL,
                                       sum(c.PRODUCTS_PER_LEVEL[:2]),
                                       c.HP64_AR + 1, label, phase="ell")
    out["losses"] = [float(v) for v in res["losses"]]
    out["step_ms"] = c.time_steps({label: res["step"]}, c.HP64_BATCH,
                                  card)[label]
    out["shapes"] = c.ell_step_shapes(model, res["step"],
                                      c._grid_laplacian(cfg, model.geometry),
                                      card)
    out["profile"] = profile_steps(res["step"])
    print("ELL " + json.dumps(out), flush=True)


def _step_peak(step):
    """GiB the allocator held at its peak over one call of step() beyond
    what was allocated before it (after a first call)."""
    step()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _live_at_peak(step, top=8):
    """The largest blocks live when one call of step() peaks: (MiB, the
    innermost frames of the port, torch or the caller that allocated
    it), from the allocator's history replayed in order."""
    step()
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=1_000_000)
    try:
        step()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, peak, at_peak, total = {}, 0, {}, 0
    for trace in snap["device_traces"]:
        for e in trace:
            if e["action"] == "alloc":
                live[e["addr"]] = e
                total += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in live:
                total -= live.pop(e["addr"])["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
    blocks = sorted(at_peak.values(), key=lambda e: -e["size"])[:top]

    def where(e):
        frames = [f"{os.path.basename(f['filename'])}:{f['line']} "
                  f"{f['name']}" for f in e.get("frames", [])
                  if "deepsphere_weather_torch" in f["filename"]
                  or "torch_chip_readings" in f["filename"]]
        return frames[:4]
    return {"peak_gib_over_step": peak / 2 ** 30,
            "top": [{"mib": e["size"] / 2 ** 20, "frames": where(e)}
                    for e in blocks]}


def remat(device):
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack

    model = c.build_flagship(device, c.SLICE_SUBDIV).train()
    members = [c.train_params(model, c.SEED + 30 + m)
               for m in range(c.ENS_MEMBERS)]
    out = {"card": c.card()}
    for ar in (c.TRAIN_AR, 0):
        indexer, area_w, w = c.train_setup(model, ar)
        data = c.train_batch(indexer, model.input_n_node, c.BATCH, device,
                             c.SEED + 32)
        for rm in (False, True):
            stack = MemberStack.from_states(model, members)
            step = make_member_train_step(
                stack, indexer, Adam(stack.parameters(), lr=c.LR,
                                     member_axis=True), ar + 1, remat=rm)
            key = f"members_ar{ar}_{'remat' if rm else 'plain'}"
            out[key] = _step_peak(lambda: step(data, w, area_w))
            if ar == c.TRAIN_AR:
                out[key + "_live"] = _live_at_peak(
                    lambda: step(data, w, area_w))
            del stack, step
        if ar == c.TRAIN_AR:
            model.load_state_dict(members[0])
            single = make_train_step(model, indexer, Adam(
                model.parameters(), lr=c.LR), ar + 1)
            out["single_ar6"] = _step_peak(lambda: single(data, w, area_w))
    print("REMAT " + json.dumps(out), flush=True)


def members(device, tag):
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack

    card = c.card()
    model = c.build_flagship(device, c.SLICE_SUBDIV).train()
    states = [c.train_params(model, c.SEED + 30 + m)
              for m in range(c.ENS_MEMBERS)]
    indexer, area_w, w = c.train_setup(model, c.TRAIN_AR)
    data = c.train_batch(indexer, model.input_n_node, c.BATCH, device,
                         c.SEED + 32)
    steps = {}
    for rm in (False, True):
        stack = MemberStack.from_states(model, states)
        step = make_member_train_step(
            stack, indexer, Adam(stack.parameters(), lr=c.LR,
                                 member_axis=True), c.TRAIN_AR + 1, remat=rm)
        steps["members_remat" if rm else "members"] = (
            lambda step=step: step(data, w, area_w))
    model.load_state_dict(states[0])
    single = make_train_step(model, indexer, Adam(model.parameters(),
                                                  lr=c.LR), c.TRAIN_AR + 1)
    steps["single"] = lambda: single(data, w, area_w)
    out = {"tree": tag, "card": card,
           "peak_gib": {k: _step_peak(v) for k, v in steps.items()},
           "step_ms": c.time_steps(steps, c.BATCH, card),
           "profile": profile_steps(steps["members"])}
    print("MEMBERS " + json.dumps(out), flush=True)


def remap(device):
    import shutil
    import tempfile
    import time

    from deepsphere_weather_torch.cli import prepare_toy_data
    from deepsphere_weather_torch.native import build, geometry
    from deepsphere_weather_torch.sphere import (
        build_sampling,
        coarsen_sampling_kwargs,
    )
    from deepsphere_weather_torch.sphere.remap import (
        _conservative_weights_numpy,
    )

    name = "Healpix_100km/InterpPool-Graph_knn"
    cfg = c._grids_config(name)
    ms = cfg["model_settings"]
    out = {"card": c.card(), "config": name, "pairs": []}
    # the libraries' first build is timed apart from the readings
    t0 = time.perf_counter()
    for lib in ("geometry", "chunkio"):
        build.load_library(lib)
    out["native_build_s"] = time.perf_counter() - t0
    kw = dict(ms["sampling_kwargs"])
    for _ in range(2):
        coarse = coarsen_sampling_kwargs(ms["sampling"], kw, 2)
        src = build_sampling(ms["sampling"], kw)
        dst = build_sampling(ms["sampling"], coarse)
        t0 = time.perf_counter()
        W, _, _ = geometry.conservative_weights(src, dst)
        t1 = time.perf_counter()
        Wp, _, _ = _conservative_weights_numpy(src, dst)
        t2 = time.perf_counter()
        out["pairs"].append({
            "src": kw, "dst": coarse, "n_src": src.n_nodes,
            "n_dst": dst.n_nodes, "native_s": t1 - t0, "plain_s": t2 - t1,
            "max_abs_diff": float(abs(W - Wp).max()), "nnz": int(W.nnz)})
        print("REMAP pair " + json.dumps(out["pairs"][-1]), flush=True)
        kw = coarse
    root = tempfile.mkdtemp(prefix="dsw_remap_")
    saved = os.environ.get("DSW_TPU_CACHE")
    os.environ["DSW_TPU_CACHE"] = os.path.join(root, "cache")
    try:
        t0 = time.perf_counter()
        c.grids_model(device, cfg, "float32")
        torch.cuda.synchronize()
        out["geometry_s_empty_cache"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepare_toy_data.main(os.path.join(root, "data"),
                              subdivisions=c.SLICE_SUBDIV, seed=c.SEED,
                              verbose=False)
        out["prepare_toy_data_s"] = time.perf_counter() - t0
        stores = [os.path.join(root, "data", "Data", *rel) for rel in (
            ("dynamic", "time_chunked", "dynamic.zarr"),
            ("bc", "time_chunked", "bc.zarr"))]
        equal, t_bulk, t_py, n_bytes, n_chunks = c._bulk_vs_chunks(stores)
        out["bulk"] = {"equal": equal, "bulk_s": t_bulk, "python_s": t_py,
                       "bytes": n_bytes, "chunks": n_chunks}
    finally:
        if saved is None:
            os.environ.pop("DSW_TPU_CACHE")
        else:
            os.environ["DSW_TPU_CACHE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    print("REMAP " + json.dumps(out), flush=True)


def _stack_step(device, n_members):
    """One step of chip_smoke's ens64 member step of `n_members` members
    (a callable) and the model."""
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import Adam, make_member_train_step
    from deepsphere_weather_torch.models import MemberStack

    cfg = c._grids_config(c.ENS64_CONFIG)
    ts, ar = cfg["training_settings"], cfg["ar_settings"]
    model = c.grids_model(device, cfg, ts["numeric_precision"]).train()
    indexer = ARIndexer.build(ar["input_k"], ar["output_k"],
                              ar["forecast_cycle"], ar["ar_iterations"])
    data = c.train_batch(indexer, model.input_n_node,
                         ts["training_batch_size"], device, c.SEED + 80)
    _, area_w, w = c.train_setup(model, ar["ar_iterations"])
    stack = MemberStack.from_states(
        model, [c.train_params(model, c.ENS64_SEED + m)
                for m in range(n_members)])
    step = make_member_train_step(
        stack, indexer, Adam(stack.parameters(), lr=ts["learning_rate"],
                             eps=c.ENS_CHECK_EPS,
                             gradient_clipping=ts["gradient_clipping"],
                             member_axis=True),
        ar["ar_iterations"] + 1, ts["ar_training_strategy"], remat=True)
    return lambda: step(data, w, area_w)


def _live(snap, top=10):
    """The snapshot's largest live blocks, by the port frames that
    allocated them."""
    blocks = [b for seg in snap["segments"] for b in seg["blocks"]
              if b["state"] == "active_allocated"]
    blocks.sort(key=lambda b: -b["size"])
    return [{"mib": b["size"] / 2 ** 20, "frames": "; ".join(
        f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
        for f in b.get("frames", [])
        if "deepsphere_weather_torch" in f["filename"])[:400]}
        for b in blocks[:top]]


def _holes(snap):
    """The free bytes of the snapshot's segments, by what last held them:
    for each inactive block, the last recorded allocation that began at
    its address, by the port frames that made it."""
    allocs = {}
    for trace in snap["device_traces"]:
        for e in trace:
            if e["action"] == "alloc":
                allocs[e["addr"]] = e
    by_frames, segments = {}, []
    for seg in snap["segments"]:
        free = [b for b in seg["blocks"] if b["state"] == "inactive"]
        segments.append({
            "mib": seg["total_size"] / 2 ** 20,
            "free_mib": sum(b["size"] for b in free) / 2 ** 20,
            "largest_free_mib": max([b["size"] for b in free], default=0)
            / 2 ** 20})
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "inactive":
                held = allocs.get(addr)
                key = "; ".join(
                    f"{os.path.basename(f['filename'])}:{f['line']} "
                    f"{f['name']}" for f in (held or {}).get("frames", [])
                    if "deepsphere_weather_torch" in f["filename"])[:400]
                entry = by_frames.setdefault(
                    key or ("(no port frame)" if held else "(no record)"),
                    {"mib": 0.0, "blocks": 0, "held_mib": 0.0})
                entry["mib"] += b["size"] / 2 ** 20
                entry["blocks"] += 1
                entry["held_mib"] += (held or {}).get("size", 0) / 2 ** 20
            addr += b["size"]
    segments.sort(key=lambda g: -g["free_mib"])
    return {"segments": len(segments),
            "segment_mib": sum(g["mib"] for g in segments),
            "free_mib": sum(g["free_mib"] for g in segments),
            "largest_segments_by_free": segments[:12],
            "free_by_allocation": sorted(
                ({"frames": k, **v} for k, v in by_frames.items()),
                key=lambda e: -e["mib"])[:12]}


def frag_one(device, mode, n_members):
    import time

    from deepsphere_weather_torch._device import ask_expandable_segments

    out = {"mode": mode, "members": n_members, "card": c.card(),
           "asked": ask_expandable_segments(),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    c.phase_build()
    step = _stack_step(device, n_members)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out["held_gib"] = base / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    at_oom = {}
    if mode == "default":
        torch.cuda.memory._record_memory_history(stacks="python",
                                                 max_entries=2_000_000)

        def observer(dev, alloc, device_allocated, device_free):
            # the allocator's state at the failure, before any unwinding
            at_oom.update(snap=torch.cuda.memory._snapshot(),
                          stats=torch.cuda.memory_stats(),
                          request_gib=alloc / 2 ** 30)
        torch._C._cuda_attach_out_of_memory_observer(observer)
    t0 = time.perf_counter()
    try:
        step()
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["own_peak_gib"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 30
    except torch.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0][:600]
        if at_oom:
            stats = at_oom["stats"]
            out["at_oom"] = {k: stats.get(k, 0) / 2 ** 30 for k in (
                "allocated_bytes.all.current", "reserved_bytes.all.current",
                "inactive_split_bytes.all.current",
                "allocated_bytes.all.peak")}
            out["request_gib"] = at_oom["request_gib"]
            out["num_alloc_retries"] = stats.get("num_alloc_retries", 0)
            out["holes"] = _holes(at_oom["snap"])
            out["largest_live"] = _live(at_oom["snap"])
    finally:
        if mode == "default":
            torch.cuda.memory._record_memory_history(enabled=None)
    out["reserved_peak_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    print("FRAG " + json.dumps(out), flush=True)


def alloc_one(device, mode):
    import time

    from deepsphere_weather_torch._device import ask_expandable_segments
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import Adam, make_train_step

    out = {"mode": mode, "card": c.card(), "asked": ask_expandable_segments(),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    c.phase_build()
    cfg = c._grids_config(c.ENS64_CONFIG)
    ts, ar = cfg["training_settings"], cfg["ar_settings"]
    model = c.grids_model(device, cfg, ts["numeric_precision"]).train()
    model.load_state_dict(c.train_params(model, c.ENS64_SEED))
    indexer = ARIndexer.build(ar["input_k"], ar["output_k"],
                              ar["forecast_cycle"], ar["ar_iterations"])
    data = c.train_batch(indexer, model.input_n_node,
                         ts["training_batch_size"], device, c.SEED + 80)
    _, area_w, w = c.train_setup(model, ar["ar_iterations"])
    step = make_train_step(
        model, indexer, Adam(model.parameters(), lr=ts["learning_rate"],
                             eps=c.ENS_CHECK_EPS,
                             gradient_clipping=ts["gradient_clipping"]),
        ar["ar_iterations"] + 1, ts["ar_training_strategy"], remat=True)

    def timed():
        t0 = time.perf_counter()
        step(data, w, area_w)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)
    for _ in range(3):
        timed()
    out["warm_ms"] = [timed() for _ in range(3)]
    torch.cuda.empty_cache()
    out["after_empty_cache_ms"] = timed()
    print("ALLOC " + json.dumps(out), flush=True)


def alloc():
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as cache:
        for mode in ("default", "port", "port", "default"):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTORCH_CUDA_ALLOC_CONF",
                                "PYTORCH_ALLOC_CONF")}
            env["DSW_TPU_CACHE"] = cache
            if mode == "default":
                env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:False"
            proc = subprocess.run(
                [sys.executable, __file__, "alloc_one", mode], env=env,
                capture_output=True, text=True, timeout=900)
            print("\n".join(ln for ln in proc.stdout.splitlines()
                            if ln.startswith("ALLOC ")) or
                  f"ALLOC {mode} rc {proc.returncode}: "
                  + proc.stderr[-1500:], flush=True)


def frag(n_members):
    import subprocess
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory() as cache:
        for mode in ("default", "port"):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTORCH_CUDA_ALLOC_CONF",
                                "PYTORCH_ALLOC_CONF")}
            env["DSW_TPU_CACHE"] = cache
            if mode == "default":
                env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:False"
            proc = subprocess.run(
                [sys.executable, __file__, "frag_one", mode,
                 str(n_members)], env=env, capture_output=True, text=True,
                timeout=1200)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("FRAG ")]
            print("\n".join(lines), flush=True)
            runs[mode] = {"rc": proc.returncode,
                          "stderr_tail": proc.stderr[-1500:]
                          if proc.returncode else ""}
    print("FRAG_BOTH " + json.dumps(runs), flush=True)


def gather(device):
    from deepsphere_weather_torch.ops import BlockSparseOperator

    subdivs = (c.SLICE_SUBDIV, c.BIG_SUBDIV)
    out = {"card": c.card(), "fp32_a": {}}
    rng = np.random.default_rng(c.SEED)
    for subdiv in subdivs:
        L = c._laplacian(subdiv)
        n = L.shape[0]
        x = torch.from_numpy(rng.standard_normal(
            (n, c.MATVEC_WIDTH)).astype(np.float32)).to(device)
        for rps in (2, 0):
            op = BlockSparseOperator.from_scipy(L, rows_per_super=rps,
                                                device=device)
            r = c.measure(op, L, x, device, f"HEALPix-{subdiv}")
            r.pop("y")
            print(f"{c._layout(op)[0]} HEALPix-{subdiv} fp32 A, fp32 x[{n}, "
                  f"{c.MATVEC_WIDTH}]: vs plain version rel "
                  f"{r['rel_err_plain']:.3e} max abs {r['max_abs_err']:.3e}; "
                  + c._verdict(r), flush=True)
            out["fp32_a"].setdefault(c._layout(op)[0], {})[
                f"x{n}_{c.MATVEC_WIDTH}"] = r
    out["gather"] = c.phase_gather(device, subdivs, c.MATVEC_WIDTH)
    out["mixed"] = c.phase_mixed(device, subdivs, c.MATVEC_WIDTH)
    print("GATHER " + json.dumps(out), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_chip_readings: needs an NVIDIA GPU")
    if sys.argv[1] == "frag":
        frag(int(sys.argv[2]) if len(sys.argv) > 2 else 7)
        sys.exit(0)
    if sys.argv[1] == "alloc":
        alloc()
        sys.exit(0)
    if sys.argv[1] == "alloc_one":
        alloc_one(torch.device("cuda"), sys.argv[2])
        sys.exit(0)
    if sys.argv[1] == "frag_one":
        frag_one(torch.device("cuda"), sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(c.card(), flush=True)
    if sys.argv[1] == "remap":
        remap(dev)
        sys.exit(0)
    c.phase_build()
    if sys.argv[1] == "gaps":
        gaps(dev)
    elif sys.argv[1] == "ell":
        ell(dev, sys.argv[2])
    elif sys.argv[1] == "remat":
        remat(dev)
    elif sys.argv[1] == "members":
        members(dev, sys.argv[2])
    elif sys.argv[1] == "gather":
        gather(dev)
    else:
        ab(dev, sys.argv[2])
