"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readers and the comparison with the reference.

Everything a cell needs is found by name under the benchmark's root:
`BENCHMARK.json`; the configuration's file; `portbench/traffic/<traffic>
.json` and the module of its kind, `portbench/kinds/<kind>.py`;
`portbench/limits/<cell>.json`; the reference's architecture, pool and
graph, `portbench/reference/arch/<architecture_name>.py`, `pools/
<pool_method>.py` (lower case) and `graphs/<sampling>_<graph_type>.py`;
and for each per-layer metric `portbench/metrics/<metric>.py`, or, for a
name `<metric>.<kind>`, `portbench/metrics/<metric>.py` read for that
kind. `run_cell` takes the device it is given: the command line
(`run.py`) refuses to run without a card, the CPU tests drive the rest of
a run through it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from . import checks, counts
from .devtrace import Trace
from .reference.model import csr_pair
from .workload import run_window, traced_stretch

# units profiled by a traced run
TRACE_UNITS = 1
GIB = float(1 << 30)
PRECISION = {"float32": "fp32", "bfloat16": "bf16"}


def load_cell(root: Path, cell_name: str) -> Dict:
    """The cell's entries and files, found by name under `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[cell_name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return cell_name in m.get("workloads", [cell_name])
    return {
        "cell": cell,
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads(
            (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
            .read_text()),
        "limits": json.loads(
            (root / "portbench" / "limits" / f"{cell_name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def find(root: Path, where: str, name: str):
    """The module `portbench/<where>/<name>.py` under `root`."""
    path = root / "portbench" / where / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(root)} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + "_".join(Path(where).parts + (name,)).replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_reader(root: Path, metric: str) -> Callable:
    """read(reading) of a per-layer metric: its own file, or the file of
    the name before its first dot, read for the kind after it."""
    if (root / "portbench" / "metrics" / f"{metric}.py").is_file():
        return find(root, "metrics", metric).read
    base, _, kind = metric.partition(".")
    read = find(root, "metrics", base).read
    return lambda r: read(r, kind)


def reference_parts(root: Path, cfg: Dict) -> SimpleNamespace:
    """The reference's architecture, pool and graph of a configuration."""
    ms = cfg["model_settings"]
    return SimpleNamespace(
        arch=find(root, "reference/arch", ms["architecture_name"]),
        pool=find(root, "reference/pools", str(ms["pool_method"]).lower()),
        graph=find(root, "reference/graphs",
                   f"{ms['sampling']}_{ms['graph_type']}"))


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the window's counts and spans and
    the traced stretch."""

    kind: str
    per_unit: Dict[str, int]          # {'samples': B} or {'leads': B leads}
    per_time: int                     # a per-layer time is given per this
                                      # many of them: a step, a lead
    units: int                        # units in the measured window
    seconds: float                    # the window's length
    spans: List[float]                # host seconds of each unit's call
    unit_flops: float                 # model operations of one unit
    peak_flops: float                 # the configuration's peak
    trace: Optional[Trace]
    stretch_units: int
    levels: int                       # the architecture's levels
    # levels -> the Laplacian's least seconds a unit, and its products a
    # unit, at those levels
    laplacian_least_s: Callable[[List[int]], float]
    laplacian_products: Callable[[List[int]], int]


def model_counts(ld: Dict, work, laps) -> Dict:
    """Operations of a unit and the Laplacian's least time a unit at given
    levels (`counts`)."""
    nodes = [L.shape[0] for L in laps]
    nnz = [L.nnz for L in laps]
    prec = PRECISION[ld["config"]["training_settings"].get(
        "numeric_precision", "float32")]
    convs, projs = work.ref.arch.layers(work.in_ch, work.out_ch)
    fwd = counts.forward_flops(convs, projs, work.batch, work.K, nodes,
                               nnz)["total"]
    flops, products = work.unit_counts(
        fwd, counts.laplacian_products(convs, work.batch, work.K))

    def least(levels: List[int]) -> float:
        return sum(counts.laplacian_least_s(nodes[lvl], nnz[lvl], width,
                                            prec, prec)
                   for lvl, width in products if lvl in levels)

    def n_products(levels: List[int]) -> int:
        return sum(lvl in levels for lvl, _ in products)
    return {"unit_flops": flops, "least": least, "products": n_products}


def reference_net(work, laps) -> Callable:
    """make_net(prec): the reference's model over `laps`, in `prec`."""
    pairs = [csr_pair(L, work.device) for L in laps]
    arch, pool = work.ref.arch, work.ref.pool
    return lambda prec="fp32": arch.Net(pairs, work.K, work.n_dyn, pool,
                                        prec)


def prepare_reference_mode():
    """The reference's numerics: full fp32 products (no TF32) and no
    deterministic-algorithm errors for its sparse products."""
    torch.use_deterministic_algorithms(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def reference_geometry(work, root: Path) -> List:
    return work.ref.graph.levels(work.ms, work.ref.arch.LEVELS,
                                 root / "portbench" / ".cache" / "reference")


def setup_program(root: Path, ld: Dict, seed: int, device):
    """The port's own set-up steps, in its CLI's order, then the
    workload's."""
    from deepsphere_weather_torch._device import ask_expandable_segments
    from deepsphere_weather_torch.utils import set_deterministic_training

    ts = ld["config"]["training_settings"]
    ask_expandable_segments()
    set_deterministic_training(bool(ts.get("deterministic_training", False)),
                               seed=int(ts.get("seed_model_weights", 0)))
    kind = find(root, "kinds", ld["traffic"]["kind"])
    return kind.Workload(ld["config"], ld["traffic"], seed, device,
                         reference_parts(root, ld["config"]))


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", start: Optional[float] = None,
             fault: Optional[Callable] = None) -> Dict:
    """One run; returns the result line's object. `fault(work)`, where
    given, is called on the program before its set-up steps (the CPU
    tests plant faults through it)."""
    start = time.perf_counter() if start is None else start
    ld = load_cell(root, cell_name)
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = ld["traffic"]["kind"]
    t_start = time.perf_counter()
    work = setup_program(root, ld, seed, device)
    t_built = time.perf_counter()
    if fault is not None:
        fault(work)
    n_check = int(ld["traffic"]["check_units"])
    setup = work.setup_units(n_check)
    print(f"setup: process start to set-up {t_start - start:.3f} s, inputs "
          f"and program built {t_built - t_start:.3f} s (the port's model "
          f"{work.build_s:.3f} s), {n_check} checked {work.unit}(s) "
          f"{time.perf_counter() - t_built:.3f} s", file=sys.stderr)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - start
    win = run_window(work, seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    stretch = (traced_stretch(work, TRACE_UNITS,
                              root / "portbench" / "out", cell_name)
               if trace else None)
    failed = work.failed()
    prog = work.program_readings(setup, seed)
    work.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    laps = reference_geometry(work, root)
    mc = model_counts(ld, work, laps)
    if trace:
        reading = Reading(
            kind=kind, per_unit=work.per_unit, per_time=work.per_time,
            units=win["units"],
            seconds=win["seconds"], spans=win["spans"],
            unit_flops=mc["unit_flops"],
            peak_flops=float(ld["config"]["peak_flops"]),
            trace=Trace(stretch["path"]), stretch_units=stretch["units"],
            levels=work.ref.arch.LEVELS,
            laplacian_least_s=mc["least"], laplacian_products=mc["products"])
        lost = reading.trace.unattributed()
        print(f"trace: {len(reading.trace.device)} device operations, "
              f"{reading.trace.seconds_of(reading.trace.device):.6f} s; "
              f"tied to no CPU op {len(lost)}, "
              f"{reading.trace.seconds_of(lost):.6f} s", file=sys.stderr)
        metrics = {}
        for m in ld["per_layer"]:
            v = find_reader(root, m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # the rate of the kind's own work: train_samples_per_s,
        # forecast_leads_per_s
        (what, per_unit), = work.per_unit.items()
        e2e = {"setup_s": setup_s, "peak_mem_gib": window_peak / GIB,
               f"{kind}_{what}_per_s": win["units"] * per_unit
               / win["seconds"]}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in ld["end_to_end"]}

    prepare_reference_mode()
    ref = work.reference_readings(setup, reference_net(work, laps))
    numbers = work.compare(prog, ref)
    judged = checks.judge(numbers, ld["limits"])
    result = {
        "correct": checks.passed(judged) and failed == 0,
        "attempted": win["units"],
        "failed": failed,
        "metrics": metrics,
        "device": device_info(device, max(setup_peak, window_peak)
                              if cuda else 0),
    }
    if trace:
        t = reading.trace
        result["device"].update({"busy_s": t.busy_seconds(),
                                 "window_s": t.seconds})
        result["breakdown"] = {"device_ops": t.top_device_ops(),
                               "idle_gaps": t.idle_gaps()}
    result["checks"] = judged
    return result


def device_info(device, peak_bytes: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}
