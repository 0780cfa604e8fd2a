"""Rank workers of the node- and data-parallel tests (a helper module, not
a test).

`start_ranks` starts `world` processes with torch.multiprocessing (start
method 'spawn'); each joins a `gloo` process group through a FileStore
(timeout 60 s), runs one worker function and pickles its result.
`join_ranks` waits for them with a limit, so a hang fails the test
instead of eating the suite's clock. This module imports torch and the port only, never JAX:
the spawned ranks import it.
"""

import pickle
import time
import warnings
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepsphere_weather_torch.data.ar import ARIndexer
from deepsphere_weather_torch.engine import make_train_step, make_validation_fn
from deepsphere_weather_torch.models import UNetSpherical, shard_geometry
from deepsphere_weather_torch.ops import BlockSparseOperator
from deepsphere_weather_torch.parallel import (
    collective_counts,
    make_mesh,
    node_range,
    reset_collective_counts,
    shard_batch,
)
from deepsphere_weather_torch.weights import broadcast_params

PG_TIMEOUT = timedelta(seconds=60)


def _entry(rank, fn, world, out_dir, args):
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(out_dir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=PG_TIMEOUT)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def start_ranks(fn, world, out_dir, *args):
    """Start fn(rank, world, *args) on `world` spawned gloo ranks; returns
    the handle `join_ranks` takes."""
    ctx = mp.start_processes(_entry, args=(fn, world, str(out_dir), args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, fn.__name__, world, Path(out_dir), time.monotonic()


def join_ranks(handle, timeout=120.0):
    """The results of a `start_ranks` run, in rank order. A rank that
    raises, or a run longer than `timeout` seconds from its start, fails
    (every rank is stopped)."""
    ctx, name, world, out_dir, t0 = handle
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > timeout:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"{world} ranks of {name} did not end within "
                               f"{timeout:g} s")
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def gradient_worker(rank, world, cases):
    """Each case (mat, symmetric, rows_per_super, x): this rank's rows of
    L @ x and of the gradient of sum((L x)^2), through the row-sharded
    operator on a 1 x world node mesh."""
    mesh = make_mesh(n_data=1, n_node=world, device="cpu")
    out = []
    for mat, symmetric, rows_per_super, x in cases:
        op = BlockSparseOperator.from_scipy(
            mat, symmetric=symmetric, rows_per_super=rows_per_super,
            device="cpu")
        v0, v1 = node_range(mat.shape[0], mesh)
        shard = op.row_shard(v0, v1, mesh.node_group)
        x_local = torch.from_numpy(x[v0:v1]).requires_grad_()
        y = shard.matvec(x_local)
        (y ** 2).sum().backward()
        out.append({"y": y.detach().numpy(), "grad": x_local.grad.numpy(),
                    "kind": shard.forward_layout()[0],
                    "units": shard.forward_layout()[1].shape[0]})
    return out


def train_worker(rank, world, cfg):
    """One train step of the HEALPix-8 UNetSpherical on an n_data x n_node
    mesh, for each precision in cfg['runs'], from cfg's weights and
    batch: the global losses, the gradients Adam steps on (reduced over
    the mesh), the parameters after the step, the validation loss before
    it and the gathers of one forward. On a 4-rank world it also builds a
    mesh that leaves a rank idle."""
    mesh = make_mesh(n_data=cfg["n_data"], n_node=cfg["n_node"],
                     device="cpu")
    out = {"rank": mesh.rank, "data_rank": mesh.data_rank,
           "node_rank": mesh.node_rank}
    indexer = ARIndexer.build(*cfg["ar"])
    n = cfg["n"]
    for dt, params in cfg["runs"].items():
        model = UNetSpherical(
            cfg["info"], "healpix", cfg["sampling"], knn=cfg["knn"],
            pool_method="max", increment_learning=True,
            numeric_precision=dt, dense_threshold=n - 1, device="cpu")
        model.load_state_dict(params)
        if rank:       # rank 0's weights must reach every rank
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        broadcast_params(model, mesh)
        model.geometry = shard_geometry(model.geometry, mesh)
        local = shard_batch(cfg["batch"], mesh)
        area_w = torch.from_numpy(cfg["area_w"])
        x = torch.zeros((local["dynamic"].shape[0], len(cfg["ar"][0]),
                         local["dynamic"].shape[2], cfg["n_in"]))
        reset_collective_counts()
        with torch.no_grad():
            model(x)
        gathers = collective_counts["all_gather"]
        n_scan = indexer.ar_iterations + 1
        val_total, _ = make_validation_fn(model, indexer, n_scan, mesh=mesh)(
            local, cfg["w"], area_w)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-7)
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()}))
        step = make_train_step(model, indexer, opt, n_scan, "RNN", mesh=mesh)
        total, per_iter = step(local, cfg["w"], area_w)
        out[dt] = {"total": float(total), "per_iter": per_iter.numpy(),
                   "val_total": float(val_total), "gathers": gathers,
                   "grads": grads,
                   "params": {k: v.detach().numpy().copy()
                              for k, v in model.state_dict().items()}}
    if world == 4:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            idle = make_mesh(n_node=3, device="cpu")
        out["idle_warning"] = any("idle" in str(w.message) for w in caught)
        out["idle_mesh"] = None if idle is None else (idle.n_data, idle.n_node)
    return out
