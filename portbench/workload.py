"""The general generator: inputs from the seed, the port driven through its
entry points, the work counted.

A traffic file (`traffic/<name>.json`) names its `kind` and parameters;
the kind is a module of its own, `kinds/<kind>.py`, whose `Workload`
subclasses the one here and says what a unit of work is, how the
reference follows it and how the two are compared.

Every kind draws the model's weights (the architecture's `draw`) with
ReZero weights of `rezero` (the published initialisation has 0, which
leaves every Chebyshev branch out of the output and every branch weight
without a first gradient), and keeps `series["steps"]` times of the
dynamic fields and boundary conditions, and the static fields, on the
device (`draw_series`). Weights and series are drawn from the seed on the
device, each in one call; the host's choices (windows, reference times)
from a numpy generator of the same seed.

The first `check_units` units run in set-up: they build and warm every
shape.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch


def model_channels(cfg: Dict, series: Dict) -> tuple:
    """(input channels, output channels, dynamic features) of the model."""
    n_in = len(cfg["ar_settings"]["input_k"])
    n_feat = series["static"] + series["bc"] + series["dynamic"]
    return n_in * n_feat, series["dynamic"], series["dynamic"]


def draw_series(series: Dict, nodes: int, gen: torch.Generator, device
                ) -> Dict[str, torch.Tensor]:
    """The resident series: {'dynamic': [T, V, Fd], 'bc': [T, V, Fb],
    'static': [V, Fs]}, standard normal (scaled space), the dynamic fields
    of each time scaled by exp(s z_t - s^2 / 2), s = `log_amplitude_sd`:
    their variance changes from time to time as weather regimes do, with
    mean 1. One draw."""
    T, fd, fb, fs = (series["steps"], series["dynamic"], series["bc"],
                     series["static"])
    n_dyn, n_bc = T * nodes * fd, T * nodes * fb
    z = torch.randn(n_dyn + n_bc + nodes * fs + T, generator=gen,
                    device=device)
    sd = float(series["log_amplitude_sd"])
    amp = torch.exp(sd * z[-T:] - 0.5 * sd * sd)
    dyn = z[:n_dyn].view(T, nodes, fd)
    dyn.mul_(amp[:, None, None])             # in place: z is the one copy
    bc = z[n_dyn:n_dyn + n_bc].view(T, nodes, fb)
    static = z[n_dyn + n_bc:-T].view(nodes, fs)
    return {"dynamic": dyn, "bc": bc, "static": static}


class Workload:
    """What every kind shares: the configuration, the drawn inputs and the
    port's model built through `models.get_model`. `ref` holds the
    reference's modules found by name (`arch`, `pool`, `graph`).

    A kind adds: `unit` (its name), `per_unit` ({what: count}, which
    names the cell's rate `<kind>_<what>_per_s`) and `per_time` (the
    count a per-layer time is given per); `run_unit()`;
    `setup_units(n)`; `failed()`; `unit_counts(forward_flops, products)`;
    `program_readings(setup, seed)`, `reference_readings(setup, make_net,
    prec)`, `compare(prog, ref)` and `fault_readings(...)` for the
    comparison; `checks_window` (whether what is compared is made in the
    window or in set-up)."""

    checks_window = False

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, ref):
        from deepsphere_weather_torch.data import ARIndexer

        self.seed = int(seed)
        self.ref = ref
        self.device = torch.device(device)
        self.ms, self.ts = cfg["model_settings"], cfg["training_settings"]
        self.ar = cfg["ar_settings"]
        self.series = traffic["series"]
        self.nodes = 12 * self.ms["sampling_kwargs"]["subdivisions"] ** 2
        self.in_ch, self.out_ch, self.n_dyn = model_channels(cfg, self.series)
        self.K = self.ms["kernel_size_conv"]
        self.batch = traffic["batch"]
        self.rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = ref.arch.draw(
            ref.arch.param_shapes(self.in_ch, self.out_ch, self.K, ref.pool,
                                  self.nodes),
            gen, self.device, float(traffic["rezero"]), ref.pool)
        self.data = draw_series(self.series, self.nodes, gen, self.device)
        self.sync()
        t = time.perf_counter()
        self.ar_iterations = self.ar["ar_iterations"]
        self.indexer = ARIndexer.build(
            self.ar["input_k"], self.ar["output_k"],
            self.ar["forecast_cycle"], self.ar_iterations,
            self.ar["stack_most_recent_prediction"])
        self.model = self._build_model()
        self.sync()
        self.build_s = time.perf_counter() - t

    def _build_model(self):
        from types import SimpleNamespace

        from deepsphere_weather_torch.data import get_ar_model_tensor_info
        from deepsphere_weather_torch.models import get_model

        s = self.series

        def feats(n):
            return SimpleNamespace(n_feature=n, n_node=self.nodes,
                                   feature_order=[f"f{i}" for i in range(n)])
        info = get_ar_model_tensor_info(
            self.ar, feats(s["dynamic"]), data_static=feats(s["static"]),
            data_bc=feats(s["bc"]))
        kw = {k: v for k, v in self.ms.items() if k != "architecture_name"}
        kw["pool_method"] = str(kw["pool_method"]).lower()
        kw["numeric_precision"] = self.ts.get("numeric_precision", "float32")
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.ts["seed_model_weights"]))
        model = get_model(self.ms["architecture_name"], info,
                          device=self.device, generator=gen, **kw)
        own = {k: tuple(v.shape) for k, v in model.named_parameters()}
        drawn = {k: tuple(v.shape) for k, v in self.params.items()}
        if own != drawn:
            raise RuntimeError(f"the port's parameters {own} are not the "
                               f"architecture's {drawn}")
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(self.params[k])
        return model

    def free(self):
        """Drop the program's state (the drawn inputs stay)."""
        self.model = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_window(work: Workload, seconds: float) -> Dict:
    """Units back to back until `seconds` have passed on the host clock,
    then the device drained: {'units', 'seconds', 'spans'} (spans: each
    unit's call to return, host seconds)."""
    spans = []
    work.sync()
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        work.run_unit()
        spans.append(time.perf_counter() - t)
        if time.perf_counter() - start >= seconds:
            break
    work.sync()
    return {"units": len(spans), "seconds": time.perf_counter() - start,
            "spans": spans}


def traced_stretch(work: Workload, units: int, out_dir, label: str
                   ) -> Dict:
    """`units` more units under torch.profiler (CPU and CUDA activities),
    between two synchronisations inside the range 'portbench.stretch';
    the Chrome trace goes to out_dir/<label>.trace.json, over the last
    one of that label. Returns {'units', 'path'}."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if work.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        work.sync()
        with record_function("portbench.stretch"):
            for _ in range(units):
                work.run_unit()
            work.sync()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{label}.trace.json"
    prof.export_chrome_trace(str(path))
    return {"units": units, "path": path}
