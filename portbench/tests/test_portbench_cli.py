"""The command line: no result without a card or without the port; no
JAX, and nothing of the JAX package, in what the harness and the
reference import."""

import ast
import os
import shutil
import subprocess
import sys

import torch

from standin import REPO

PB = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "deepsphere_weather_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(names):
    return {n.split(".")[0] for n in names}


def test_sources_import_no_jax():
    for path in PB.rglob("*.py"):
        assert not _top(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").rglob("*.py"):
        assert "deepsphere_weather_torch" not in _top(_imports(path)), path


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return
    r = _run(["portbench/run.py", "--workload", "hp100km_knn_fp32.train",
              "--seed", "1", "--seconds", "1", "--trace", "0"], REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    r = _run(["portbench/run.py", "--workload", "hp100km_knn_fp32.train",
              "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    """The whole of a stand-in run in a fresh process, then its modules."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(PB / 'tests')!r})\n"
        "from standin import make_root\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "r = harness.run_cell(root, 'tiny_fp32.forecast', 5, 0.2, True, "
        "device='cpu')\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = _run(["-c", code], REPO,
             {"DSW_TPU_CACHE": str(tmp_path / "geometry")})
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "deepsphere_weather_torch" in loaded
