"""Device operations of a traced stretch tied to the program's spans.

The port marks its layers with spans, CPU ops named `dsw.*` in the trace
(`deepsphere_weather_torch/utils/tracing.py`). Each device operation is
tied to them from the CPU op that launched it: the op whose `External
id` the operation carries (the innermost op open at its launch, which the
profiler links through the launch's correlation id), and the ops open
around that op on its thread.

- Forward, or a remat recompute (a `dsw.` span opened inside the
  backward): the `dsw.` spans open around the launch on its thread.
- Backward (launched under an `autograd::engine::evaluate_function:` op):
  the spans open around the forward op that made the autograd node. That
  op carries the node's `Sequence number` on the forward thread, which the
  backward op names by the profiler's own number (`Fwd thread id`); each
  such number is taken for the trace thread that holds most of its
  sequence numbers. Of a forward thread's ops with one sequence number,
  the last to start made the node (the others only read the counter).

Every operation the backward launched, and every one launched under
`dsw.train.backward`, is also under `dsw.train.backward`. A trace without
`dsw.` spans (a program without them) ties nothing, and the readers in
`metrics/` that use these ties return None on it.

    python3 -m portbench.spans portbench/out/<cell>.trace.json

prints the shares of the stretch's device time tied, by span, and of the
backward's reached by the sequence numbers.
"""

from __future__ import annotations

import json
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PREFIX = "dsw."
BACKWARD = "dsw.train.backward"
MODEL = "dsw.model"
EVALUATE = "autograd::engine::evaluate_function:"
GEMM = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"}
SPMM = "deepsphere_weather_torch::spmm"


@dataclass(frozen=True)
class Tie:
    """Where a device operation belongs: the `dsw.` spans of its work
    (outer to inner; for the backward, those of its forward op), whether
    the backward launched it, and, where the tie goes through an autograd
    node's sequence number, whether it reached the forward op (None where
    it does not: the forward, a recompute, a leaf's accumulation)."""

    spans: Tuple[str, ...]
    backward: bool
    reached: Optional[bool]

    def under(self, name: str) -> bool:
        return name in self.spans or (self.backward and name == BACKWARD)

    @property
    def tied(self) -> bool:
        return bool(self.spans) or self.backward


def _args(e) -> dict:
    return e.get("args") or {}


class _Ops:
    """Each CPU op of the trace with the `dsw.` spans open around it on its
    thread, the innermost evaluate_function op around it and the count of
    spans open when that one began; the forward ops by thread and
    sequence number; and the profiler's thread numbers mapped to the
    trace's threads."""

    def __init__(self, ops: List[dict]):
        self.by_xid: Dict[int, dict] = {}
        self.info: Dict[int, Tuple[Tuple[str, ...], Optional[dict], int]] = {}
        self.forward: Dict[Tuple, dict] = {}
        by_thread = defaultdict(list)
        for e in ops:
            by_thread[(e["pid"], e["tid"])].append(e)
            xid = _args(e).get("External id")
            if xid is not None:
                self.by_xid[xid] = e
        for thread, evs in by_thread.items():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
            open_ops: List[Tuple[float, dict]] = []
            for e in evs:
                ts = float(e["ts"])
                while open_ops and open_ops[-1][0] <= ts:
                    open_ops.pop()
                chain, ev, n_at = (self.info[id(open_ops[-1][1])]
                                   if open_ops else ((), None, 0))
                name = e["name"]
                if name.startswith(PREFIX):
                    chain = chain + (name,)
                elif name.startswith(EVALUATE):
                    ev, n_at = e, len(chain)
                self.info[id(e)] = (chain, ev, n_at)
                open_ops.append((ts + float(e["dur"]), e))
                a = _args(e)
                if (a.get("Sequence number", -1) >= 0
                        and not a.get("Fwd thread id")):
                    # ops start in order: the last one made the node
                    self.forward[(thread, a["Sequence number"])] = e
        votes: Dict[int, Counter] = defaultdict(Counter)
        threads = list(by_thread)
        for e in ops:
            a = _args(e)
            if e["name"].startswith(EVALUATE) and "Sequence number" in a:
                for t in threads:
                    if (t, a["Sequence number"]) in self.forward:
                        votes[a.get("Fwd thread id")][t] += 1
        self.thread = {f: c.most_common(1)[0][0] for f, c in votes.items()}

    def tie(self, device_op: dict) -> Optional[Tie]:
        op = self.by_xid.get(_args(device_op).get("External id"))
        if op is None:
            return None
        chain, ev, n_at = self.info[id(op)]
        if ev is None:
            return Tie(chain, BACKWARD in chain, None)
        a = _args(ev)
        if len(chain) > n_at:                        # a remat recompute
            return Tie(chain, True, None)
        if "Sequence number" not in a:               # AccumulateGrad
            return Tie(chain, True, None)
        fwd = self.forward.get((self.thread.get(a.get("Fwd thread id")),
                                a.get("Sequence number")))
        if fwd is None:
            return Tie(chain, True, False)
        return Tie(self.info[id(fwd)][0], True, True)


def ties(trace) -> Optional[List[Tuple[dict, Optional[Tie]]]]:
    """(device operation, its tie or None) for each device operation of
    the stretch, in the trace's order; None when the trace holds no
    `dsw.` span or no device operation."""
    if not trace.device or not any(e["name"].startswith(PREFIX)
                                   for e in trace.ops):
        return None
    ops = _Ops(trace.ops)
    return [(d, ops.tie(d)) for d in trace.device]


def ms_per_time(r, kind: str, keep) -> Optional[float]:
    """Device ms a step or a lead of the stretch's operations whose tie
    `keep(device_op, tie)` accepts (None without ties)."""
    if r.kind != kind or r.trace is None:
        return None
    tied = ties(r.trace)
    if tied is None:
        return None
    s = sum(float(d["dur"]) for d, t in tied if t is not None and keep(d, t))
    return 1e-3 * s / (r.stretch_units * r.per_time)


def summary(trace) -> Dict:
    """The stretch's device seconds, the shares tied to a `dsw.` span and
    under each span, and of the backward's (launched under an
    evaluate_function op or `dsw.train.backward`) the share the sequence
    numbers reached, of the part that has a forward op to reach."""
    tied = ties(trace) or []
    total = trace.seconds_of(trace.device)
    by_span: Dict[str, float] = defaultdict(float)
    untied: Dict[str, float] = defaultdict(float)
    tied_s = bwd = base = reached = 0.0
    for d, t in tied:
        s = float(d["dur"]) * 1e-6
        if t is None or not t.tied:
            untied[d["name"][:80]] += s
            continue
        tied_s += s
        for name in set(t.spans) | ({BACKWARD} if t.backward else set()):
            by_span[name] += s
        if t.backward:
            bwd += s
        if t.backward and t.reached is not None:
            base += s
            reached += s * t.reached
    return {
        "device_s": total,
        "tied_share": tied_s / total if total else None,
        "by_span_s": dict(sorted(by_span.items())),
        "backward_s": bwd,
        "backward_reached_share": reached / base if base else None,
        "untied_s": dict(sorted(untied.items(), key=lambda kv: -kv[1])[:10]),
    }


def main(argv=None) -> int:
    from portbench.devtrace import Trace

    for path in (argv if argv is not None else sys.argv[1:]):
        print(json.dumps({"trace": path, **summary(Trace(path))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
