"""A copy of the benchmark's root with small stand-in cells, for the CPU
tests: the shipped configurations at HEALPix-8 (768 / 192 / 48 nodes;
levels 0-1 on the port's sparse operators through `dense_threshold`),
batch 2, each with the limits of the cell it stands in for."""

import copy
import json
import shutil
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
SERIES = {"steps": 160, "dynamic": 2, "bc": 1, "static": 4,
          "log_amplitude_sd": 0.5}


def make_root(tmp: Path) -> Path:
    """tmp/root: BENCHMARK.json, and portbench/ with the stand-in cells
    `tiny_<precision>.<traffic>` added as files and entries."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for prec in ("fp32", "bf16"):
        src = f"hp100km_knn_{prec}"
        cfg = json.loads((pb / "configs" / f"{src}.json").read_text())
        cfg["model_settings"]["sampling_kwargs"]["subdivisions"] = 8
        cfg["model_settings"]["dense_threshold"] = 100
        (pb / "configs" / f"tiny_{prec}.json").write_text(json.dumps(cfg))
        entry = copy.deepcopy({c["name"]: c for c in bench["configs"]}[src])
        entry.update(name=f"tiny_{prec}",
                     file=f"portbench/configs/tiny_{prec}.json")
        bench["configs"].append(entry)
        for kind in ("train", "forecast"):
            traffic = json.loads((pb / "traffic" / f"{kind}.json")
                                 .read_text())
            traffic.update(batch=2, series=SERIES)
            (pb / "traffic" / f"tiny_{kind}.json").write_text(
                json.dumps(traffic))
            cell = f"tiny_{prec}.{kind}"
            shutil.copy(pb / "limits" / f"{src}.{kind}.json",
                        pb / "limits" / f"{cell}.json")
            bench["workloads"].append(
                {"name": cell, "config": f"tiny_{prec}",
                 "traffic": f"tiny_{kind}", "chips": 1, "why": "stand-in"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if f"{src}.{kind}" in m.get("workloads", []):
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def fault_unchanged(work):
    """The training step returns the parameters it was given."""
    step = work.step

    def unchanged(*args):
        keep = [p.detach().clone() for p in work.model.parameters()]
        out = step(*args)
        with torch.no_grad():
            for p, k in zip(work.model.parameters(), keep):
                p.copy_(k)
        return out
    work.step = unchanged


def fault_half_batch(work):
    """The training step leaves out half of the batch: its loss is the
    mean over the rest."""
    step = work.step

    def half(data, widx, *rest):
        return step(data, widx[:widx.shape[0] // 2], *rest)
    work.step = half


def fault_altered_lead(work):
    """Each forecast reports its tenth lead in place of its eleventh."""
    rollout = work.rollout

    def altered(*args):
        h, m, preds = rollout(*args)
        preds = preds.clone()
        preds[:, 10] = preds[:, 9]
        return h, m, preds
    work.rollout = altered
