"""Rank workers of the node- and data-parallel tests (a helper module, not
a test).

`start_ranks` starts `world` processes with torch.multiprocessing (start
method 'spawn'); each joins a `gloo` process group through a FileStore
(timeout 60 s), runs one worker function and pickles its result.
`join_ranks` waits for them with a limit, so a hang fails the test
instead of eating the suite's clock. Each rank runs torch on one
intra-op thread (`torch_threads.one_thread`). This module imports torch
and the port only, never JAX: the spawned ranks import it.
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
from torch_threads import one_thread

PG_TIMEOUT = timedelta(seconds=60)


def _entry(rank, fn, world, out_dir, args):
    one_thread()
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


def tasks_worker(rank, world, tasks):
    """Each (worker, cfg) of `tasks` in turn on the same ranks: one spawn
    for several meshes (a mesh smaller than the world leaves the other
    ranks idle: their worker returns None)."""
    return [fn(rank, world, cfg) for fn, cfg in tasks]


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


def _perturb_off_rank0(module, rank):
    """Other ranks' parameters moved off rank 0's: `broadcast_params` must
    bring rank 0's back."""
    if rank:
        with torch.no_grad():
            for p in module.parameters():
                p.add_(1.0)


def _grad_recorder(opt, module, out):
    """Record the gradients each optimizer step steps on (after every
    reduction), keyed by parameter name, one dict per step."""
    def record(*_):
        out.append({k: p.grad.numpy().copy()
                    for k, p in module.named_parameters()})
    opt.register_step_pre_hook(record)


def _counting(monkeypatch_targets):
    """Wrap module functions to count their calls: {(module, name):
    [count]}; returns the restore function and the counts."""
    counts, saved = {}, []
    for mod, name in monkeypatch_targets:
        fn = getattr(mod, name)
        box = counts.setdefault(name, [0])

        def wrapped(*a, _fn=fn, _box=box, **k):
            _box[0] += 1
            return _fn(*a, **k)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, restore


def member_worker(rank, world, cfg):
    """Two member-parallel train steps of a stack of M HEALPix-4
    UNetSphericals (level 0 block-sparse) on an n_data x n_node x n_member
    mesh (with cfg['remat'], each AR iteration recomputed in the
    backward), for each precision in cfg['runs']: this rank's members, every
    member's losses, the gradients each step stepped on (this rank's
    members) and its members' parameters after the steps. On a node mesh,
    K5 over K2 at level 0: the vmapped row-shard product (forward and
    backward) against the loop over members, with its gathers and
    row-range calls counted. With cfg['rollout'] (a 1 x 1 x n_member
    mesh), the member-sharded `ensemble_rollout_predictions`."""
    from deepsphere_weather_torch.engine import Adam, make_member_train_step
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.ops import bcsr as bcsr_mod
    from deepsphere_weather_torch.parallel import member_range

    mesh = make_mesh(n_data=cfg["n_data"], n_node=cfg["n_node"],
                     n_member=cfg["n_member"], device="cpu")
    if mesh is None:
        return None
    out = {"rank": mesh.rank, "pos": (mesh.data_rank, mesh.node_rank,
                                      mesh.member_rank)}
    indexer = ARIndexer.build(*cfg["ar"])
    n, n_scan = cfg["n"], indexer.ar_iterations + 1
    M = len(cfg["members"])
    m0, m1 = member_range(M, mesh)
    out["members"] = (m0, m1)
    area_w = torch.from_numpy(cfg["area_w"])
    for dt in cfg["runs"]:
        model = UNetSpherical(
            cfg["info"], "healpix", cfg["sampling"], knn=cfg["knn"],
            pool_method="max", increment_learning=True,
            numeric_precision=dt, dense_threshold=n - 1, device="cpu")
        stack = MemberStack.from_states(model, cfg["members"])
        _perturb_off_rank0(stack, rank)
        broadcast_params(stack, mesh)
        local = stack.select(m0, m1)
        model.geometry = shard_geometry(model.geometry, mesh)
        batch = shard_batch(cfg["batch"], mesh)
        opt = Adam(local.parameters(), cfg["lr"], member_axis=True,
                   eps=cfg["eps"])
        grads = []
        _grad_recorder(opt, local, grads)
        step = make_member_train_step(local, indexer, opt, n_scan,
                                      mesh=mesh,
                                      remat=cfg.get("remat", False))
        losses = []
        for _ in range(2):
            total, per_iter = step(batch, cfg["w"], area_w)
            losses.append((total.numpy(), per_iter.numpy()))
        out[dt] = {"losses": losses, "grads": grads,
                   "params": {k: v.detach().numpy().copy()
                              for k, v in local.state_dict().items()}}
    if mesh.n_node > 1:
        out["k5_over_k2"] = _k5_over_k2(model, mesh, bcsr_mod)
    if cfg.get("rollout"):
        out["rollout"] = _rollout(cfg["rollout"], mesh)
    return out


def _k5_over_k2(model, mesh, bcsr_mod):
    """Level 0's row-sharded operator: the vmapped product of 4 members'
    x and its vjp, against the loop over members (exact), with the
    gathers and row-range calls of each."""
    op = model.geometry.cheb_ops[0].bcsr
    n_local = op.v1 - op.v0
    rng = torch.Generator().manual_seed(5 + mesh.node_rank)
    x = torch.randn((4, n_local, 96), generator=rng)
    g = torch.randn((4, n_local, 96), generator=rng)

    def vjp(xm, gm):
        y, back = torch.func.vjp(op.matvec, xm)
        return y, back(gm)[0]

    res = {}
    for name, fn in (("vmap", lambda: torch.func.vmap(vjp)(x, g)),
                     ("loop", lambda: [torch.stack(t) for t in zip(
                         *[vjp(x[k], g[k]) for k in range(4)])])):
        counts, restore = _counting([(bcsr_mod, "bcsr_super_spmm_rows")])
        reset_collective_counts()
        try:
            y, gx = fn()
        finally:
            restore()
        res[name] = {"y": y.numpy(), "gx": gx.numpy(),
                     "launches": counts["bcsr_super_spmm_rows"][0],
                     "gathers": collective_counts["all_gather"]}
    return res


def _rollout(rcfg, mesh):
    """`ensemble_rollout_predictions` of the stacked members on the
    member mesh (scaled space)."""
    from deepsphere_weather_torch.data import (GlobalStandardScaler,
                                               SphericalDataset,
                                               StaticDataset)
    from deepsphere_weather_torch.prob import ensemble_rollout_predictions

    root = Path(rcfg["root"])
    dyn = SphericalDataset.open(root / rcfg["dyn"])
    bc = SphericalDataset.open(root / rcfg["bc"])
    static = StaticDataset.open(root / rcfg["static"])
    model = UNetSpherical(rcfg["info"], "healpix", rcfg["sampling"],
                          knn=rcfg["knn"], pool_method="max",
                          increment_learning=True,
                          dense_threshold=rcfg["n"] - 1, device="cpu")
    stacked = {k: torch.from_numpy(v) for k, v in rcfg["stacked"].items()}
    reset_collective_counts()
    preds = ensemble_rollout_predictions(
        model, stacked, data_dynamic=dyn, data_bc=bc, data_static=static,
        scaler=GlobalStandardScaler().fit_dataset(dyn), inverse_scale=False,
        indexer=ARIndexer.build(*rcfg["ar"]), n_steps=rcfg["n_steps"],
        t0s=rcfg["t0s"], batch_size=rcfg["batch_size"], mesh=mesh)
    return {"preds": preds, "gathers": collective_counts["all_gather"]}


def _mesh_step(model, mesh, cfg, steps, with_norm_state=False):
    """`steps` train steps of `model` (whole geometry, rank 0's weights
    reach every rank) on its node shard of cfg's batch: the global losses
    of each, the gradients each stepped on, the parameters and the
    running statistics after them."""
    indexer = ARIndexer.build(*cfg["ar"])
    broadcast_params(model, mesh)
    model.geometry = shard_geometry(model.geometry, mesh)
    local = shard_batch(cfg["batch"], mesh)
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], eps=cfg["eps"])
    grads = []
    _grad_recorder(opt, model, grads)
    step = make_train_step(model, indexer, opt, indexer.ar_iterations + 1,
                           "RNN", mesh=mesh, with_norm_state=with_norm_state)
    losses, stats = [], []
    for _ in range(steps):
        total, per_iter = step(local, cfg["w"],
                               torch.from_numpy(cfg["area_w"]))
        losses.append((float(total), per_iter.numpy()))
        stats.append({k: v.numpy().copy()
                      for k, v in model.norm_state().items()})
    return {"losses": losses, "grads": grads, "norm_state": stats,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def bn_worker(rank, world, cfg):
    """Two `with_norm_state` train steps of the HEALPix-4 BatchNorm
    UNetSpherical on an n_data x n_node mesh (`_mesh_step`)."""
    mesh = make_mesh(n_data=cfg["n_data"], n_node=cfg["n_node"],
                     device="cpu")
    if mesh is None:
        return None
    model = UNetSpherical(
        cfg["info"], "healpix", cfg["sampling"], knn=cfg["knn"],
        pool_method="max", increment_learning=True, batch_norm=True,
        dense_threshold=cfg["n"] - 1, device="cpu")
    model.load_state_dict(cfg["params"])
    _perturb_off_rank0(model, rank)
    return _mesh_step(model, mesh, cfg, 2, with_norm_state=True)


def grid_worker(rank, world, cfg):
    """One train step of each case's UNetSpherical (cfg['cases']: the
    model settings and its weights) on a 1 x world node mesh; with the
    gathers of one forward."""
    from deepsphere_weather_torch.models import get_model

    mesh = make_mesh(n_data=1, n_node=world, device="cpu")
    out = []
    for case in cfg["cases"]:
        model = get_model("UNetSpherical", case["info"], device="cpu",
                          **case["settings"])
        model.load_state_dict(case["params"])
        _perturb_off_rank0(model, rank)
        res = _mesh_step(model, mesh, dict(cfg, batch=case["batch"],
                                           area_w=case["area_w"]), 1)
        res["ranges"] = model.geometry.node_ranges
        res["pools"] = [type(p).__name__ for p in model.geometry.pools
                        + model.geometry.unpools]
        out.append(res)
    return out


def member_driver_worker(rank, world, cfg):
    """`AutoregressiveTraining` of a member stack on an n_data x n_node x
    n_member mesh, twice (the model's geometry whole: the driver trains
    on the rank's node shard of it and puts it back): from the initial
    members with
    checkpoints under cfg['exp_fresh'], and resumed from the checkpoint
    under cfg['resume_from'] (written by another layout) into
    cfg['exp_resumed'], each on the training period [0, end) of
    cfg['train_ends']. The training records of both and the whole stack
    the first returns."""
    from deepsphere_weather_torch.data import (GlobalStandardScaler,
                                               SphericalDataset,
                                               StaticDataset)
    from deepsphere_weather_torch.engine import (Adam,
                                                 AutoregressiveTraining,
                                                 ARScheduler, EarlyStopping)
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.utils import Checkpointer

    mesh = make_mesh(n_data=cfg["n_data"], n_node=cfg["n_node"],
                     n_member=cfg["n_member"], device="cpu")
    root = Path(cfg["root"])
    dyn = SphericalDataset.open(root / cfg["dyn"])
    bc = SphericalDataset.open(root / cfg["bc"])
    static = StaticDataset.open(root / cfg["static"])
    fresh_end, resumed_end = cfg["train_ends"]
    data = dict(training_data_dynamic=dyn.subset(0, fresh_end),
                validation_data_dynamic=dyn.subset(80, 120),
                training_data_bc=bc.subset(0, fresh_end),
                validation_data_bc=bc.subset(80, 120), data_static=static,
                scaler=GlobalStandardScaler().fit_dataset(dyn),
                area_weights=torch.from_numpy(cfg["area_w"]))
    model = UNetSpherical(cfg["info"], "healpix", cfg["sampling"],
                          knn=cfg["knn"], pool_method="max",
                          increment_learning=True,
                          dense_threshold=cfg["n"] - 1, device="cpu")
    out = {"pos": (mesh.data_rank, mesh.node_rank, mesh.member_rank)}

    stack = MemberStack.from_states(model, cfg["members"])
    _, opt, info = AutoregressiveTraining(
        stack, mesh=mesh, exp_dir=cfg["exp_fresh"],
        ar_scheduler=ARScheduler(**cfg["scheduler"]),
        early_stopping=EarlyStopping(**cfg["stopping"]), **data,
        **cfg["drive"])
    out["whole_geometry"] = model.geometry.node_ranges is None
    out["fresh"] = {"info": info.to_dict(),
                    "params": {k: v.detach().numpy().copy()
                               for k, v in stack.state_dict().items()},
                    "lr": opt.param_groups[0]["lr"]}

    stack = MemberStack(model, len(cfg["members"]))
    opt = Adam(stack.parameters(), cfg["drive"]["learning_rate"],
               member_axis=True)
    ck = Checkpointer(cfg["resume_from"])
    ck.load_model(stack)
    state = ck.load_training_state(opt, stack)
    data.update(training_data_dynamic=dyn.subset(0, resumed_end),
                training_data_bc=bc.subset(0, resumed_end))
    _, _, info = AutoregressiveTraining(
        stack, optimizer=opt, mesh=mesh, exp_dir=cfg["exp_resumed"],
        ar_scheduler=ARScheduler.from_state_dict(state["ar_scheduler"]),
        early_stopping=EarlyStopping(patience=100), **data,
        **cfg["drive"])
    out["resumed"] = {"info": info.to_dict()}
    return out


def bn_member_worker(rank, world, cfg):
    """Two `with_norm_state` member steps of a stack of BatchNorm
    HEALPix-4 UNetSphericals on an n_data x n_node x n_member mesh: every
    member's losses and this rank's members' running statistics after
    each step."""
    from deepsphere_weather_torch.engine import Adam, make_member_train_step
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.parallel import member_range

    mesh = make_mesh(n_data=cfg["n_data"], n_node=cfg["n_node"],
                     n_member=cfg["n_member"], device="cpu")
    if mesh is None:
        return None
    model = UNetSpherical(
        cfg["info"], "healpix", cfg["sampling"], knn=cfg["knn"],
        pool_method="max", increment_learning=True, batch_norm=True,
        dense_threshold=cfg["n"] - 1, device="cpu")
    stack = MemberStack.from_states(model, cfg["members"])
    m0, m1 = member_range(len(cfg["members"]), mesh)
    local = stack.select(m0, m1)
    model.geometry = shard_geometry(model.geometry, mesh)
    indexer = ARIndexer.build(*cfg["ar"])
    opt = Adam(local.parameters(), cfg["lr"], member_axis=True,
               eps=cfg["eps"])
    step = make_member_train_step(local, indexer, opt,
                                  indexer.ar_iterations + 1, mesh=mesh,
                                  with_norm_state=True)
    batch = shard_batch(cfg["batch"], mesh)
    out = {"members": (m0, m1), "losses": [], "norm_state": []}
    for _ in range(2):
        total, per_iter = step(batch, cfg["w"],
                               torch.from_numpy(cfg["area_w"]))
        out["losses"].append(per_iter.numpy())
        out["norm_state"].append({k: v.numpy().copy()
                                  for k, v in local.norm_state().items()})
    return out
