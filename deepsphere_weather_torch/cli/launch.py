"""Start a CLI on the ranks its config asks for.

The JAX CLIs run a config's `n_data_parallel` x `n_node_parallel` mesh on
one host's devices inside one process. Here each rank is a process in a
`torch.distributed` group; `launch` gives `cli.train_predict` and
`cli.finetune_swag` that group:

- a process group already exists (a rank this module started, or a
  caller that set one up): the CLI runs in it (`launch` returns
  `IN_GROUP`);
- torchrun's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`): the
  process joins that group (`env://`), runs the CLI as its rank and
  leaves the group;
- neither, and the config needs N > 1 ranks: N processes are started
  with `torch.multiprocessing` (start method 'spawn'), joined through a
  file store in a temporary directory; `launch` returns rank 0's result.

Backend: `nccl` when every rank has a card of its own (device 'cuda' and
at least N cards; rank r on cuda:r, torchrun's on cuda:LOCAL_RANK),
`gloo` when the ranks share one card or run on the CPU. The choice and
the rank-to-device map are printed on one line before any rank starts. A
failed init fails the run: no other backend is tried. Every rank's
process group has a `PG_TIMEOUT_S` timeout, so a collective whose peer
hangs raises; a rank that raises or dies makes `launch` raise (the
other ranks are stopped), so the CLI exits nonzero instead of hanging.

Only rank 0 writes: the CLIs make the experiment directories, the
config copies, the predictions, the skills and the SWAG stores there
(checkpoints are the trainer's rank 0's already), and the other ranks
return after training. Their output lines are rank 0's too.
"""

from __future__ import annotations

import importlib
import os
import pickle
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

__all__ = ["IN_GROUP", "PG_TIMEOUT_S", "launch", "mesh_world", "rank",
           "rank_barrier", "plan"]

PG_TIMEOUT_S = 600
IN_GROUP = object()
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def mesh_world(training_settings: Dict) -> int:
    """The ranks of a config's data x node mesh."""
    return (max(int(training_settings.get("n_data_parallel", 1)), 1)
            * max(int(training_settings.get("n_node_parallel", 1)), 1))


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_barrier() -> None:
    """Wait for every rank of the default group (nothing outside one)."""
    if dist.is_initialized():
        dist.barrier()


def plan(device, world: int) -> Tuple[str, List[str]]:
    """(backend, device of each rank) for `world` ranks asking for
    `device`."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= world):
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", [str(dev)] * world


def _announce(backend, devices, how):
    print(f"launch: {len(devices)} ranks ({how}), backend {backend}, "
          f"devices {dict(enumerate(devices))}", flush=True)


def _target(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _run_rank(target: str, kwargs: Dict, device: str, r: int):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kwargs = dict(kwargs, device=device,
                  verbose=bool(kwargs.get("verbose", True)) and r == 0)
    return _target(target)(**kwargs)


def _rank_main(r, target, kwargs, backend, devices, out_dir):
    """One spawned rank: join the group through the file store, run the
    CLI, leave the group; rank 0 pickles its result."""
    world = len(devices)
    store = dist.FileStore(str(Path(out_dir) / "store"), world)
    dist.init_process_group(backend, store=store, rank=r, world_size=world,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        result = _run_rank(target, kwargs, devices[r], r)
    finally:
        dist.destroy_process_group()
    if r == 0:
        try:
            blob = pickle.dumps(result)
        except Exception:   # open stores and threads do not pickle
            blob = pickle.dumps(None)
        (Path(out_dir) / "result.pkl").write_bytes(blob)


def launch(target: str, world: int, kwargs: Dict):
    """Run `target` ("module:function", a CLI's `main`) with `kwargs` on
    `world` ranks (module docstring); returns `IN_GROUP` when the caller
    is to run it itself, else rank 0's result (None if it does not
    pickle)."""
    device = kwargs.get("device", "cuda")
    if dist.is_initialized() or (world <= 1 and not all(
            k in os.environ for k in _ENV)):
        return IN_GROUP
    if all(k in os.environ for k in _ENV):
        n = int(os.environ["WORLD_SIZE"])
        if n != world:
            raise RuntimeError(f"the config's mesh needs {world} ranks; "
                               f"torchrun started {n}")
        r = int(os.environ["RANK"])
        backend, devices = plan(device, n)
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", r))
            devices = [f"cuda:{local}"] * n
        if r == 0:
            _announce(backend, devices if backend == "gloo"
                      else ["cuda:LOCAL_RANK"] * n, "torchrun")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timedelta(seconds=PG_TIMEOUT_S))
        try:
            return _run_rank(target, kwargs, devices[r], r)
        finally:
            dist.destroy_process_group()

    import torch.multiprocessing as mp

    backend, devices = plan(device, world)
    _announce(backend, devices, "spawned")
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(target, kwargs, backend, devices, out_dir),
            nprocs=world, join=False, start_method="spawn")
        # raises as soon as a rank raises or dies, after stopping the rest
        while not ctx.join(timeout=1.0):
            pass
        return pickle.loads((Path(out_dir) / "result.pkl").read_bytes())
