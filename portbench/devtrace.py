"""Reading a torch.profiler Chrome trace of the profiled stretch.

Device operations are the events of the categories in `DEVICE_CATS`.
Each kernel is tied to the host call that launched it by its
`correlation` id (the CUDA runtime or driver call: cuBLAS launches
through the driver), and that call to every CPU op
open around it on its thread: the op that launched it and the ops above
that one. So "kernels under aten::mm" are those launched while an
`aten::mm` was open, whichever op launched them; no kernel name is
matched. The stretch is the `portbench.stretch` range, which begins and
ends with a device synchronisation.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "portbench.stretch"


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The stretch's device operations and the host ops around them."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        stretch = [e for e in spans if e.get("name") == STRETCH
                   and e.get("cat") in ("user_annotation", "cpu_op")]
        if not stretch:
            raise ValueError(f"no '{STRETCH}' range in {path}")
        s = stretch[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.main_tid = (s["pid"], s["tid"])
        self.device = [e for e in spans if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) <= self.t1]
        self.ops = [e for e in spans if e.get("cat") == "cpu_op"]
        runtime = [e for e in spans
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self._stacks = self._launch_stacks(runtime)

    def _launch_stacks(self, runtime) -> Dict[int, Tuple[str, ...]]:
        """correlation id -> names of the CPU ops open around its launch."""
        by_thread = defaultdict(list)
        for e in self.ops:
            by_thread[(e["pid"], e["tid"])].append(
                (float(e["ts"]), 0, -float(e["dur"]), e))
        for e in runtime:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_thread[(e["pid"], e["tid"])].append(
                    (float(e["ts"]), 1, 0.0, e))
        stacks = {}
        for items in by_thread.values():
            items.sort(key=lambda t: (t[0], t[1], t[2]))
            open_ops: List[Tuple[float, str]] = []
            for ts, is_launch, _, e in items:
                while open_ops and open_ops[-1][0] < ts:
                    open_ops.pop()
                if is_launch:
                    stacks[e["args"]["correlation"]] = tuple(
                        n for _, n in open_ops)
                else:
                    open_ops.append((ts + float(e["dur"]), e["name"]))
        return stacks

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[List[float]]:
        return _merge((max(float(e["ts"]), self.t0),
                       min(float(e["ts"]) + float(e["dur"]), self.t1))
                      for e in self.device)

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def under(self, match) -> List[dict]:
        """Device operations launched while an op that `match(name)`
        accepts was open."""
        out = []
        for e in self.device:
            stack = self._stacks.get(e.get("args", {}).get("correlation"), ())
            if any(match(n) for n in stack):
                out.append(e)
        return out

    def unattributed(self) -> List[dict]:
        """Device operations tied to no CPU op (their launch unseen)."""
        return [e for e in self.device
                if not self._stacks.get(e.get("args", {}).get("correlation"))]

    @staticmethod
    def seconds_of(events: Sequence[dict]) -> float:
        return sum(float(e["dur"]) for e in events) * 1e-6

    def op_count(self, match) -> int:
        """CPU ops in the stretch that `match(name)` accepts."""
        return sum(1 for e in self.ops if self.t0 <= float(e["ts"]) <= self.t1
                   and match(e["name"]))

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e["name"][:160]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest idle stretches of the device, each named by the
        innermost host op open on the launching thread at its midpoint
        ('host (no op)' when none was)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        main = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in self.ops
                      if (e["pid"], e["tid"]) == self.main_tid)
        starts = [m[0] for m in main]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            name = "host (no op)"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                s, e, nm = main[i]
                if e >= mid and nm != STRETCH:
                    name = nm
                    break
                if mid - s > 60e6:
                    break
            out.append([name, (b - a) * 1e-6])
        return out

