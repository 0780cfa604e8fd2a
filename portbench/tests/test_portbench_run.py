"""The harness driven on the CPU at the stand-in size: a cell added as
files alone is found and runs correct; the timed path broken underneath
makes `correct` false; the control reads above a limit."""

import hashlib
import json
import math

import pytest
import torch

import standin
from standin import REPO, make_root
from portbench import checks, harness

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_root(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(n)


def _digest(p):
    return hashlib.sha256(p.read_bytes()).hexdigest()


def test_new_cells_are_new_files_and_entries(root):
    """Every file of the benchmark is the same in the copy; the stand-in
    cells brought files and BENCHMARK.json entries only."""
    for p in (REPO / "portbench").rglob("*"):
        rel = p.relative_to(REPO)
        if p.is_file() and not {".cache", "out", "__pycache__"} & set(
                rel.parts):
            assert _digest(root / rel) == _digest(p), rel
    old = json.loads((REPO / "BENCHMARK.json").read_text())
    new = json.loads((root / "BENCHMARK.json").read_text())
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in new[section]]
        for e in old[section]:
            assert e["name"] in names


@pytest.mark.parametrize("cell", ["tiny_fp32.train", "tiny_bf16.forecast"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, cell, trace):
    r = harness.run_cell(root, cell, SEED, 0.5, trace, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    ld = harness.load_cell(root, cell)
    want = ld["per_layer" if trace else "end_to_end"]
    names = set(r["metrics"])
    if trace:
        # no device operations on the CPU: only the host-side readers read
        assert names <= {m["name"] for m in want}
        assert r["device"]["window_s"] > 0
    else:
        assert names == {m["name"] for m in want}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(ld["limits"])


@pytest.mark.parametrize("cell,fault", [
    ("tiny_fp32.train", standin.fault_unchanged),
    ("tiny_fp32.train", standin.fault_half_batch),
    ("tiny_bf16.train", standin.fault_unchanged),
    ("tiny_bf16.train", standin.fault_half_batch),
    ("tiny_fp32.forecast", standin.fault_altered_lead),
    ("tiny_bf16.forecast", standin.fault_altered_lead),
])
def test_fault_makes_correct_false(root, cell, fault):
    r = harness.run_cell(root, cell, SEED, 0.5, False, device="cpu",
                         fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny_fp32.train", "tiny_bf16.train",
                                  "tiny_fp32.forecast",
                                  "tiny_bf16.forecast"])
def test_control_fails_a_limit(root, cell):
    """The reference in the program's place, one precision below the
    configuration's, fails at least one of the cell's limits."""
    ld = harness.load_cell(root, cell)
    work = harness.setup_program(root, ld, SEED, torch.device("cpu"))
    setup = work.setup_units(int(ld["traffic"]["check_units"]))
    if work.checks_window:
        work.run_unit()
        work.run_unit()
    prog = work.program_readings(setup, SEED)
    work.free()
    make_net = harness.reference_net(work,
                                     harness.reference_geometry(work, root))
    harness.prepare_reference_mode()
    ref = work.reference_readings(setup, make_net)
    assert checks.passed(checks.judge(work.compare(prog, ref), ld["limits"]))
    ctl = work.reference_readings(setup, make_net,
                                  ld["config"]["control_precision"])
    judged = checks.judge(work.compare(ctl, ref), ld["limits"])
    assert not checks.passed(judged), judged
    assert all(c["value"] is None or math.isfinite(c["value"])
               for c in judged.values())


NOWCAST = '''"""Traffic kind "nowcast": forecasts of the next step alone."""

from portbench.kinds import forecast


class Workload(forecast.Workload):
    def __init__(self, cfg, traffic, seed, device, ref):
        super().__init__(cfg, dict(traffic, leads=1), seed, device, ref)
'''

AVG_POOL = '''"""Average pooling of a nested sampling."""

import torch


def pool(x, p, lvl):
    B, V, C = x.shape
    return x.reshape(B, V // 4, 4, C).mean(dim=2), None


def unpool(x, idx, p, lvl):
    return torch.repeat_interleave(x, 4, dim=1)
'''


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A copy to which a traffic kind, a pool and the cell that uses them
    came as files and entries only: `tiny_avg.nowcast`, one-step
    forecasts of the HEALPix-8 stand-in with average pooling."""
    root = make_root(tmp_path_factory.mktemp("grown"))
    pb = root / "portbench"
    (pb / "kinds" / "nowcast.py").write_text(NOWCAST)
    (pb / "reference" / "pools" / "avg.py").write_text(AVG_POOL)
    cfg = json.loads((pb / "configs" / "tiny_fp32.json").read_text())
    cfg["model_settings"]["pool_method"] = "Avg"
    (pb / "configs" / "tiny_avg.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "tiny_forecast.json").read_text())
    traffic["kind"] = "nowcast"
    (pb / "traffic" / "tiny_nowcast.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny_avg.nowcast.json").write_text(
        (pb / "limits" / "tiny_fp32.forecast.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = "tiny_avg.nowcast"
    bench["configs"].append(dict(bench["configs"][0], name="tiny_avg",
                                 file="portbench/configs/tiny_avg.json"))
    bench["workloads"].append({"name": cell, "config": "tiny_avg",
                               "traffic": "tiny_nowcast", "chips": 1,
                               "why": "stand-in"})
    bench["end_to_end"].append(
        {"name": "nowcast_leads_per_s", "unit": "leads/s", "better": "higher",
         "bound": 0.02, "source": "host_clock", "workloads": [cell]})
    for name in ("host_ms", "device_idle"):
        bench["per_layer"].append(
            {"name": f"{name}.nowcast", "unit": "ms", "better": "lower",
             "source": "program_span", "layer": "prediction",
             "moves": "nowcast_leads_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_new_kind_and_pool_are_files_and_entries(grown, trace):
    r = harness.run_cell(grown, "tiny_avg.nowcast", SEED, 0.3, trace,
                         device="cpu")
    assert r["correct"], r["checks"]
    if trace:
        assert "host_ms.nowcast" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"setup_s", "peak_mem_gib",
                                     "nowcast_leads_per_s"}


@pytest.mark.parametrize("where,name,key,value", [
    ("reference/arch", "UNetStub", "architecture_name", "UNetStub"),
    ("reference/pools", "stub", "pool_method", "Stub"),
    ("reference/graphs", "healpix_stub", "graph_type", "stub"),
])
def test_reference_parts_found_by_name(grown, where, name, key, value):
    """A configuration's architecture, pool and graph are the files named
    after it."""
    (grown / "portbench" / where / f"{name}.py").write_text("STUB = 1\n")
    cfg = json.loads((grown / "portbench" / "configs" / "tiny_avg.json")
                     .read_text())
    cfg["model_settings"][key] = value
    parts = harness.reference_parts(grown, cfg)
    found = {"reference/arch": parts.arch, "reference/pools": parts.pool,
             "reference/graphs": parts.graph}[where]
    assert getattr(found, "STUB", None) == 1


@pytest.mark.cuda
def test_card_run(root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = harness.run_cell(root, "tiny_fp32.train", SEED, 1.0, True,
                         device="cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
