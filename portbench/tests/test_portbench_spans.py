"""The program-span readers (`portbench/spans.py`, `metrics/backward_ms`,
`cheb_other_ms`, `outside_model_ms`, `host_syncs`).

- A synthetic trace of two threads: the main thread runs a forward under
  `dsw.model` / `dsw.cheb_conv` with ops of known sequence numbers, then
  `dsw.train.backward` and the optimizer; autograd's device thread runs
  `evaluate_function: ...Backward0` ops with those numbers (and a remat
  recompute under spans of its own); a third thread holds a stray forward
  op with one of the numbers. Each reader against hand arithmetic, and
  None on the same trace without its `dsw.` spans (a program without
  them).
- The port's CPU stand-in step, traced, with a device operation made for
  each leaf op: `gemm_ms`, `laplacian_roofline`, `device_idle` and the
  idle gaps' lengths read the same with and without the `dsw.` spans, and
  every operation the step's spans hold is tied, the backward's through
  its sequence numbers.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from standin import REPO, make_root
from portbench import harness, spans
from portbench.devtrace import Trace
from portbench.workload import traced_stretch

SEED = 2**31 + 4099
MAIN, DEV, OTHER = 11, 22, 33


class _Doc:
    """A Chrome trace built op by op: CPU ops, and device operations each
    launched from the op given (runtime event with its correlation and
    the op's External id)."""

    def __init__(self):
        self.events = [{"ph": "X", "cat": "user_annotation",
                        "name": "portbench.stretch", "pid": 1, "tid": MAIN,
                        "ts": 0.0, "dur": 2000.0, "args": {}}]
        self.xid = 100
        self.corr = 5000
        self.dev_t = 0.0

    def op(self, name, tid, ts, dur, seq=None, fwd_tid=None):
        self.xid += 1
        args = {"External id": self.xid}
        if seq is not None:
            args["Sequence number"] = seq
            args["Fwd thread id"] = fwd_tid if fwd_tid is not None else 0
        e = {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid,
             "ts": float(ts), "dur": float(dur), "args": args}
        self.events.append(e)
        return e

    def launch(self, op, dur, cat="kernel", name="k"):
        self.corr += 1
        at = op["ts"] + 0.5
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "pid": 1,
                            "tid": op["tid"], "ts": at, "dur": 0.1,
                            "args": {"correlation": self.corr,
                                     "External id": op["args"]["External id"]}})
        self.dev_t = max(self.dev_t, at) + 1.0
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                            "tid": 7, "ts": self.dev_t, "dur": float(dur),
                            "args": {"correlation": self.corr,
                                     "External id": op["args"]["External id"]}})
        self.dev_t += dur

    def trace(self, tmp_path, keep_spans=True):
        events = [e for e in self.events
                  if keep_spans or not e["name"].startswith("dsw.")]
        path = tmp_path / ("spans.json" if keep_spans else "bare.json")
        path.write_text(json.dumps({"traceEvents": events}))
        return Trace(path)


def _step_doc() -> _Doc:
    """One training step; kernel durations in us (see the sums below)."""
    d = _Doc()
    d.op("dsw.train.step", MAIN, 10, 900)
    d.op("dsw.train.loss", MAIN, 20, 380)
    d.op("dsw.model", MAIN, 30, 270)
    d.op("dsw.cheb_conv", MAIN, 40, 160)
    d.launch(d.op("aten::mm", MAIN, 50, 10, seq=10), 20)            # K1
    d.launch(d.op("aten::mul", MAIN, 70, 10, seq=11), 5)            # K2
    d.launch(d.op("deepsphere_weather_torch::spmm_ell", MAIN, 90, 10),
             8)                                                     # K3
    d.launch(d.op("aten::add", MAIN, 210, 10, seq=12), 3)           # K4
    d.launch(d.op("aten::sub", MAIN, 310, 10, seq=13), 2)           # K5
    d.op("dsw.train.backward", MAIN, 400, 400)
    d.launch(d.op("aten::ones_like", MAIN, 405, 5), 1)              # K6
    d.op("autograd::engine::evaluate_function: SubBackward0", DEV, 420,
         10, seq=13, fwd_tid=1)
    d.launch(d.op("aten::neg", DEV, 421, 4), 2)                     # K8
    d.op("autograd::engine::evaluate_function: AddBackward0", DEV, 440,
         10, seq=12, fwd_tid=1)
    d.launch(d.op("aten::add", DEV, 441, 4), 3)                     # K9
    d.op("autograd::engine::evaluate_function: MulBackward0", DEV, 460,
         10, seq=11, fwd_tid=1)
    d.launch(d.op("aten::mul", DEV, 461, 4), 6)                     # K10
    d.op("autograd::engine::evaluate_function: MmBackward0", DEV, 480,
         20, seq=10, fwd_tid=1)
    d.launch(d.op("aten::mm", DEV, 481, 9), 30)                     # K11
    d.op("autograd::engine::evaluate_function: SelectBackward0", DEV, 505,
         15, seq=11, fwd_tid=1)
    d.launch(d.op("aten::zeros", DEV, 506, 4), 7)                   # K12
    d.op("autograd::engine::evaluate_function: "
         "torch::autograd::AccumulateGrad", DEV, 530, 10)
    d.launch(d.op("aten::add_", DEV, 531, 4), 1)                    # K13
    # a remat recompute: the model's spans opened inside the backward
    d.op("autograd::engine::evaluate_function: MulBackward0", DEV, 550, 50,
         seq=15, fwd_tid=1)
    d.op("dsw.model", DEV, 555, 40)
    d.op("dsw.cheb_conv", DEV, 556, 34)
    d.launch(d.op("aten::mul", DEV, 560, 5, seq=0), 5)              # K15
    # a node whose forward op the trace lacks
    d.op("autograd::engine::evaluate_function: ViewBackward0", DEV, 610,
         10, seq=99, fwd_tid=1)
    d.launch(d.op("aten::copy_", DEV, 611, 4), 4)                   # K16
    d.op("dsw.train.optimizer", MAIN, 810, 40)
    d.launch(d.op("aten::_foreach_add_", MAIN, 815, 5), 4)          # K7
    d.launch(d.op("aten::item", MAIN, 830, 10), 1, cat="gpu_memcpy",
             name="Memcpy DtoH (Device -> Pageable)")
    # a stray forward op with a sequence number of the main thread's
    d.op("aten::mul", OTHER, 75, 3, seq=11)
    # the harness's copy, outside the program's spans
    d.launch(d.op("aten::copy_", MAIN, 950, 10), 9, cat="gpu_memcpy",
             name="Memcpy DtoH (Device -> Pageable)")
    return d


def _reading(trace, kind="train", per_time=1):
    return SimpleNamespace(kind=kind, trace=trace, stretch_units=1,
                           per_time=per_time)


def _read(metric, r, kind="train"):
    return harness.find_reader(REPO, f"{metric}.{kind}")(r)


def test_readers_against_hand_arithmetic(tmp_path):
    r = _reading(_step_doc().trace(tmp_path))
    # K6 + K8 + K9 + K10 + K11 + K12 + K13 + K15 + K16
    assert _read("backward_ms", r) == pytest.approx(
        1e-3 * (1 + 2 + 3 + 6 + 30 + 7 + 1 + 5 + 4))
    # K2 + K10 + K12 + K15: not K1, K11 (aten::mm) nor K3 (::spmm_ell)
    assert _read("cheb_other_ms", r) == pytest.approx(1e-3 * (5 + 6 + 7 + 5))
    # K5, K6, K7, the step's copy, K8 (the loss's backward), K13 and K16
    # (no forward op)
    assert _read("outside_model_ms", r) == pytest.approx(
        1e-3 * (2 + 1 + 4 + 1 + 2 + 1 + 4))
    assert _read("host_syncs", r) == 1


def test_ties_name_the_forward_span(tmp_path):
    trace = _step_doc().trace(tmp_path)
    by_corr = {d["args"]["correlation"]: t for d, t in spans.ties(trace)}
    ties = [by_corr[c] for c in sorted(by_corr)]
    # K1 K2 K3 K4 K5 K6 K8 K9 K10 K11 K12 K13 K15 K16 K7 copy copy
    assert ties[1].spans == ("dsw.train.step", "dsw.train.loss",
                             "dsw.model", "dsw.cheb_conv")
    assert not ties[1].backward
    assert ties[8] == spans.Tie(ties[1].spans, True, True)        # K10
    assert ties[7].spans == ("dsw.train.step", "dsw.train.loss",
                             "dsw.model")                         # K9
    assert ties[11] == spans.Tie((), True, None)                  # K13
    assert ties[12] == spans.Tie(("dsw.model", "dsw.cheb_conv"), True,
                                 None)                            # K15
    assert ties[13] == spans.Tie((), True, False)                 # K16
    assert ties[5].under("dsw.train.backward")                    # K6
    assert not ties[16].tied                                      # copy
    s = spans.summary(trace)
    # of K8-K12 and K16 (those tied through a node), all but K16
    assert s["backward_reached_share"] == pytest.approx(48 / 52)


def test_forecast_readers(tmp_path):
    d = _Doc()
    d.op("dsw.rollout", MAIN, 10, 500)
    for i in range(2):
        t = 20 + 200 * i
        d.launch(d.op("aten::cat", MAIN, t, 5), 2)
        d.op("dsw.model", MAIN, t + 10, 150)
        d.op("dsw.cheb_conv", MAIN, t + 20, 100)
        d.launch(d.op("aten::addmm", MAIN, t + 30, 10), 10)
        d.launch(d.op("aten::permute_copy", MAIN, t + 50, 10), 3)
    d.launch(d.op("aten::copy_", MAIN, 600, 10), 9, cat="gpu_memcpy",
             name="Memcpy DtoH (Device -> Pageable)")
    r = _reading(d.trace(tmp_path), "forecast", per_time=4)
    assert _read("cheb_other_ms", r, "forecast") == pytest.approx(
        1e-3 * 2 * 3 / 4)
    assert _read("outside_model_ms", r, "forecast") == pytest.approx(
        1e-3 * 2 * 2 / 4)
    assert _read("host_syncs", r, "forecast") == 0


@pytest.mark.parametrize("metric,kind", [
    ("backward_ms", "train"), ("cheb_other_ms", "train"),
    ("outside_model_ms", "train"), ("host_syncs", "train"),
    ("cheb_other_ms", "forecast"), ("outside_model_ms", "forecast"),
    ("host_syncs", "forecast")])
def test_no_spans_no_reading(metric, kind, tmp_path):
    r = _reading(_step_doc().trace(tmp_path, keep_spans=False), kind)
    assert _read(metric, r, kind) is None
    assert _read(metric, SimpleNamespace(kind=kind, trace=None), kind) is None


# -- the stand-in's own trace --------------------------------------------

def _with_device(doc):
    """The trace with a launch and a device operation for every leaf CPU
    op (one holding no other op on its thread), in launch order, 1-7 us
    each, a gap of 20 us after every fifth."""
    events = doc["traceEvents"]
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "cpu_op"
                  and not e["name"].startswith("dsw.")),
                 key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    leaves = [a for a, b in zip(ops, ops[1:] + [None])
              if b is None or b["tid"] != a["tid"]
              or b["ts"] >= a["ts"] + a["dur"]]
    dev_t, corr = 0.0, 900000
    for i, op in enumerate(sorted(leaves, key=lambda e: e["ts"])):
        corr += 1
        at = op["ts"] + 0.5 * op["dur"]
        xid = op["args"]["External id"]
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": op["pid"],
                       "tid": op["tid"], "ts": at, "dur": 0.01,
                       "args": {"correlation": corr, "External id": xid}})
        dev_t = max(dev_t, at) + (20.0 if i % 5 == 4 else 0.5)
        dur = 1.0 + i % 7
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i % 3}",
                       "pid": 0, "tid": 7, "ts": dev_t, "dur": dur,
                       "args": {"correlation": corr, "External id": xid}})
        dev_t += dur
    return doc


@pytest.fixture(scope="module")
def standin_traces(tmp_path_factory):
    """(with spans, without) of the fp32 stand-in's traced step."""
    tmp = tmp_path_factory.mktemp("standin")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        root = make_root(tmp)
        ld = harness.load_cell(root, "tiny_fp32.train")
        work = harness.setup_program(root, ld, SEED, torch.device("cpu"))
        work.setup_units(1)
        st = traced_stretch(work, 1, tmp / "out", "tiny")
    finally:
        torch.set_num_threads(n)
    doc = _with_device(json.loads(st["path"].read_text()))
    bare = dict(doc, traceEvents=[e for e in doc["traceEvents"]
                                  if not e.get("name", "").startswith("dsw.")])
    out = []
    for name, d in (("spans.json", doc), ("bare.json", bare)):
        (tmp / name).write_text(json.dumps(d))
        out.append(Trace(tmp / name))
    return out


def _existing_readings(trace):
    calls = trace.op_count(lambda n: n.startswith(spans.SPMM))
    r = SimpleNamespace(kind="train", trace=trace, stretch_units=1,
                        per_time=1, levels=3,
                        laplacian_products=lambda lv: (
                            calls if list(lv) == [0] else -1),
                        laplacian_least_s=lambda lv: 1e-6)
    return {m: _read(m, r) for m in ("gemm_ms", "laplacian_roofline",
                                     "device_idle")}


def test_existing_readings_unmoved_by_spans(standin_traces):
    with_spans, bare = standin_traces
    got, want = _existing_readings(with_spans), _existing_readings(bare)
    assert got == want
    assert all(v is not None and v > 0 for v in got.values()), got
    assert ([g for _, g in with_spans.idle_gaps()]
            == [g for _, g in bare.idle_gaps()])
    assert with_spans.busy_intervals() == bare.busy_intervals()


def test_standin_step_tied(standin_traces):
    with_spans, bare = standin_traces
    s = spans.summary(with_spans)
    # the stretch is the step: every operation but the harness's is tied
    assert s["tied_share"] > 0.99, s["untied_s"]
    assert s["backward_reached_share"] == 1.0
    assert s["by_span_s"]["dsw.cheb_conv"] > 0
    assert spans.ties(bare) is None
