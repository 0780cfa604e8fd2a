"""The port's entry points ask the CUDA caching allocator for expandable
segments before their first allocation (`_device.ask_expandable_segments`)
and keep what the user set.

With the allocator's default segments a large member stack fragments the
card (the 7-member step of the shipped Healpix_100km MaxPool knn config
failed with 16.39 GiB reserved but unallocated; PERF.md). Each case runs
every entry point in a fresh interpreter under one allocator environment:
the allocator's settings are reset to what the environment gives, the
entry point is called, and the settings are read at its first device
touch (`resolve_device`, or the spawned rank's process group), where a
sentinel stops it. No JAX here: the entry points are the port's alone.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_torch._device import ask_expandable_segments  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "UNetSpherical" / "Healpix_400km" / \
    "MaxPool-Graph_knn.json"

# run in a subprocess: every entry point, each stopped at its first device
# touch, with the allocator's settings read there
PROBE = r"""
import json, sys
import torch
import torch.distributed as dist
from deepsphere_weather_torch import _device
from deepsphere_weather_torch.cli import experiments, finetune_swag, launch
from deepsphere_weather_torch.cli import train_predict

cfg, tmp, env_conf = sys.argv[1], sys.argv[2], sys.argv[3]
settings = torch._C._accelerator_getAllocatorSettings


class Stop(Exception):
    pass


def stop(*args, **kwargs):
    seen.append(settings())
    raise Stop


_device.resolve_device = stop
dist.FileStore = stop
calls = {
    "train_predict.main": lambda: train_predict.main(
        cfg, tmp, tmp + "/exp", device="cpu"),
    "finetune_swag.main": lambda: finetune_swag.main(tmp, tmp,
                                                      device="cpu"),
    "experiments.run_deep_ensemble(member_parallel=True)": lambda:
        experiments.run_deep_ensemble(cfg, tmp, tmp + "/ens", n_members=7,
                                      member_parallel=True, device="cpu"),
    "experiments.run_sweep": lambda: experiments.run_sweep(
        cfg, tmp, tmp + "/sweep", {"knn": [8]}, device="cpu"),
    "experiments.run_reproducibility_experiment": lambda:
        experiments.run_reproducibility_experiment(cfg, tmp, tmp + "/rep",
                                                   device="cpu"),
    "experiments.run_x_year_simulations": lambda:
        experiments.run_x_year_simulations(tmp, tmp, dt_hours=6,
                                           device="cpu"),
    "launch rank": lambda: launch._rank_main(
        1, "m:f", {}, "gloo", ["cpu", "cpu"], tmp),
}
out = {}
for name, call in calls.items():
    torch._C._accelerator_setAllocatorSettings(env_conf)
    before = settings()
    seen = []
    try:
        call()
    except Stop:
        pass
    out[name] = {"before": before, "at_first_touch": seen}
print(json.dumps(out))
"""


def _probe(tmp_path, env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF")}
    full.update(env, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    conf = env.get("PYTORCH_ALLOC_CONF") or env.get(
        "PYTORCH_CUDA_ALLOC_CONF", "")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, str(CONFIG), str(tmp_path), conf],
        env=full, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env,want", [
    ({}, "expandable_segments:True"),
    # the user's value stands
    ({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"},
     "expandable_segments:False"),
    ({"PYTORCH_ALLOC_CONF": "expandable_segments:False"},
     "expandable_segments:False"),
    # the user's other options are kept beside the setting
    ({"PYTORCH_ALLOC_CONF": "max_split_size_mb:64"},
     "max_split_size_mb:64,expandable_segments:True"),
], ids=["unset", "cuda_conf_false", "alloc_conf_false", "other_option"])
def test_entry_points_ask_before_their_first_allocation(tmp_path, env, want):
    got = _probe(tmp_path, env)
    assert len(got) == 7
    before = env.get("PYTORCH_ALLOC_CONF") or env.get(
        "PYTORCH_CUDA_ALLOC_CONF", "")
    for name, r in got.items():
        assert r["before"] == before, name
        assert r["at_first_touch"] == [want], name


def test_ask_keeps_a_backend_the_user_chose(monkeypatch):
    # cudaMallocAsync keeps no segments: nothing is asked
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "backend:cudaMallocAsync")
    monkeypatch.delenv("PYTORCH_ALLOC_CONF", raising=False)
    assert ask_expandable_segments() is False
