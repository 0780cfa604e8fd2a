"""The port's trace spans (`utils/tracing.py`) and where they sit.

- `span` emits a `cpu_op` event under each of the eight `dsw.` names (the
  category pins the private record-function class it wraps: a torch that
  exports it otherwise fails here);
- with no profiler active it records nothing and costs under
  `SPAN_OFF_US` a span;
- a HEALPix-8 cached train step (AR2: 3 model calls) and a rollout block
  under `torch.profiler`: every `aten::` op of the unit lies under a
  `dsw.` span, and the spans come as often as the layers run (one model
  call an AR iteration or a lead, one `dsw.cheb_conv` a graph
  convolution of each call);
- a member step (`vmap` over two members) runs with spans on, one
  `dsw.model` for all members of an iteration;
- the exported serving program holds no profiler node;
- the step's losses and parameters and the rollout's outputs are bitwise
  the same with the profiler on and off.
"""

import contextlib
import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    make_cached_member_train_step,
    make_cached_train_step,
    make_optimizer,
    make_rollout_block,
)
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.models.layers import ConvBlock  # noqa: E402
from deepsphere_weather_torch.serve import export_rollout  # noqa: E402
from deepsphere_weather_torch.utils.tracing import span  # noqa: E402

NAMES = ["dsw.train.step", "dsw.train.gather", "dsw.train.loss",
         "dsw.train.backward", "dsw.train.optimizer", "dsw.rollout",
         "dsw.model", "dsw.cheb_conv"]
SPAN_OFF_US = 2.0
SUBDIV, KNN = 8, 8
N = 12 * SUBDIV ** 2
F_DYN, F_BC, F_STATIC = 2, 1, 1
INPUT_K, OUTPUT_K, N_AR = [-2, -1], [0], 2
T, B, LEADS = 12, 2, 3
SETTINGS = {"learning_rate": 1e-3, "gradient_clipping": 1.0}
PACKAGE = Path(__file__).resolve().parents[1] / "deepsphere_weather_torch"


def _model(seed=0):
    info = {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": len(INPUT_K),
            "output_n_time": len(OUTPUT_K),
            "input_shape_info": {"dynamic": {"node": N}},
            "output_shape_info": {"dynamic": {"node": N}}}
    # levels 0 and 1 on the sparse operators (node-major), level 2 dense
    return UNetSpherical(info, "healpix", {"subdivisions": SUBDIV,
                                           "nest": True},
                         knn=KNN, pool_method="max", increment_learning=True,
                         dense_threshold=100, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    data = {"dynamic": rng.standard_normal((T, N, F_DYN)),
            "bc": rng.standard_normal((T, N, F_BC)),
            "static": rng.standard_normal((N, F_STATIC))}
    data = {k: torch.from_numpy(v.astype(np.float32)) for k, v in data.items()}
    indexer = ARIndexer.build(INPUT_K, OUTPUT_K, 1, N_AR)
    widx = torch.from_numpy(np.array([t + indexer.rel_offsets
                                      for t in (3, 6)]))
    w = torch.full((N_AR + 1,), 1.0 / (N_AR + 1))
    return data, indexer, widx, w


def _convs(model) -> int:
    """Graph convolutions of one forward: each graph ConvBlock runs once."""
    return sum(isinstance(m, ConvBlock) and m.conv_type == "graph"
               for m in model.modules())


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _counts(events):
    out = {}
    for e in events:
        if e["name"].startswith("dsw."):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _outside_spans(events):
    """aten:: ops lying under no dsw. span of their thread."""
    spans = [(e["pid"], e["tid"], float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e["name"].startswith("dsw.")]
    out = []
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if not any(p == e["pid"] and t == e["tid"] and s <= a and b <= f
                       for p, t, s, f in spans):
                out.append(e["name"])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_span_is_a_cpu_op(name, tmp_path):
    assert not name.startswith("deepsphere_weather_torch::spmm")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(name):
            torch.ones(3).add_(1.0)
    events = _events(prof, tmp_path)
    got = [e for e in events if e["name"] == name]
    assert [e["cat"] for e in got] == ["cpu_op"]
    inner = [e for e in events if e["name"] == "aten::add_"]
    assert inner and got[0]["ts"] <= inner[0]["ts"]


def test_span_off_records_nothing_and_is_cheap(tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(1000):
        with span("dsw.model"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).add_(1.0)
    assert _counts(_events(prof, tmp_path)) == {}
    n, best = 20000, float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with span("dsw.model"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best * 1e6 < SPAN_OFF_US, best


def test_only_the_helper_uses_the_record_function_class():
    users = [p.relative_to(PACKAGE).as_posix()
             for p in PACKAGE.rglob("*.py")
             if "_RecordFunctionFast" in p.read_text()]
    assert users == ["utils/tracing.py"]
    assert not [p for p in PACKAGE.rglob("*.py")
                if "record_function" in p.read_text()]


def test_cached_train_step_spans(model, inputs, tmp_path):
    data, indexer, widx, w = inputs
    m = copy.deepcopy(model)
    opt = make_optimizer(m.parameters(), SETTINGS)
    step = make_cached_train_step(m, indexer, opt, N_AR + 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        total, _ = step(data, widx, w)
    events = _events(prof, tmp_path)
    assert torch.isfinite(total)
    assert _outside_spans(events) == []
    calls = N_AR + 1
    assert _counts(events) == {
        "dsw.train.step": 1, "dsw.train.gather": 1, "dsw.train.loss": 1,
        "dsw.train.backward": 1, "dsw.train.optimizer": 1,
        "dsw.model": calls, "dsw.cheb_conv": calls * _convs(m)}


def test_rollout_spans(model, inputs, tmp_path):
    data, indexer, _, _ = inputs
    rollout, H = make_rollout_block(model, indexer, LEADS)
    hist = data["dynamic"][:H][None].repeat(B, 1, 1, 1)
    bc = data["bc"][None, None, :len(INPUT_K)].expand(
        B, LEADS, len(INPUT_K), N, F_BC)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            _, _, preds = rollout(hist, None, bc, data["static"])
    events = _events(prof, tmp_path)
    assert preds.shape == (B, LEADS, len(OUTPUT_K), N, F_DYN)
    assert _outside_spans(events) == []
    assert _counts(events) == {"dsw.rollout": 1, "dsw.model": LEADS,
                               "dsw.cheb_conv": LEADS * _convs(model)}


def test_member_step_under_vmap_runs_with_spans(model, inputs, tmp_path):
    data, indexer, widx, w = inputs
    stack = MemberStack(copy.deepcopy(model), n_members=2)
    opt = make_optimizer(stack.parameters(), SETTINGS, member_axis=True)
    step = make_cached_member_train_step(stack, indexer, opt, N_AR + 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        total, per_iter = step(data, widx, w)
    events = _events(prof, tmp_path)
    assert total.shape == (2,) and torch.isfinite(total).all()
    assert per_iter.shape == (2, N_AR + 1)
    counts = _counts(events)
    assert counts["dsw.train.step"] == counts["dsw.train.backward"] == 1
    assert counts["dsw.model"] == N_AR + 1


def test_exported_program_holds_no_profiler_node(model):
    art = export_rollout(copy.deepcopy(model), input_k=INPUT_K,
                         output_k=OUTPUT_K, forecast_cycle=1, batch_size=1,
                         block_size=2, static=np.zeros((N, F_STATIC),
                                                       np.float32),
                         n_bc_features=F_BC)
    targets = [str(n.target) for n in art.program.graph.nodes
               if n.op == "call_function"]
    assert targets
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]


def test_outputs_bitwise_equal_with_profiler_on_and_off(model, inputs):
    data, indexer, widx, w = inputs
    results = []
    for on in (False, True):
        m = copy.deepcopy(model)
        opt = make_optimizer(m.parameters(), SETTINGS)
        step = make_cached_train_step(m, indexer, opt, N_AR + 1)
        rollout, H = make_rollout_block(m, indexer, LEADS)
        hist = data["dynamic"][:H][None].repeat(B, 1, 1, 1)
        bc = data["bc"][None, None, :len(INPUT_K)].expand(
            B, LEADS, len(INPUT_K), N, F_BC)
        with (profile(activities=[ProfilerActivity.CPU]) if on
              else contextlib.nullcontext()):
            total, per_iter = step(data, widx, w)
            with torch.inference_mode():
                h, _, preds = rollout(hist, None, bc, data["static"])
        results.append([total, per_iter, h, preds]
                       + [p.detach().clone() for p in m.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)
