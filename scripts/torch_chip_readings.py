#!/usr/bin/env python3
"""Card readings of the PyTorch/CUDA port that chip_smoke.py does not take.

Run on one NVIDIA GPU from the root of a checkout; it imports that tree's
chip_smoke.py:

    python3 scripts/torch_chip_readings.py gaps
    python3 scripts/torch_chip_readings.py ab TAG
    python3 scripts/torch_chip_readings.py ell TAG
    python3 scripts/torch_chip_readings.py remat

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


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_chip_readings: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(c.card(), flush=True)
    c.phase_build()
    if sys.argv[1] == "gaps":
        gaps(dev)
    elif sys.argv[1] == "ell":
        ell(dev, sys.argv[2])
    elif sys.argv[1] == "remat":
        remat(dev)
    else:
        ab(dev, sys.argv[2])
