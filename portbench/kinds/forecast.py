"""Traffic kind "forecast": `make_rollout_block` under
`torch.inference_mode()`. Each forecast predicts `leads` steps from
`batch` seeded reference times of the resident series, with the boundary
conditions of every lead, and is copied to the host before the next
starts.

What is compared (`checks.lead_gap`, `checks.lead_median_gap`): a seeded
sample of the forecasts the window made, every lead, against the
reference's rollouts from the same reference times.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import checks, workload
from portbench.reference.model import rollout

# forecasts of the window compared with the reference
SAMPLE = 2


class Workload(workload.Workload):
    unit = "forecast"
    checks_window = True

    def __init__(self, cfg, traffic, seed, device, ref):
        super().__init__(cfg, traffic, seed, device, ref)
        from deepsphere_weather_torch.engine import make_rollout_block

        self.leads = traffic["leads"]
        self.rollout, self.H = make_rollout_block(self.model, self.indexer,
                                                  self.leads)
        fc = self.ar["forecast_cycle"]
        self.min_k = min(self.ar["input_k"])
        lo = -self.min_k
        hi = self.series["steps"] - (self.leads - 1) * fc
        self.t0_range = (lo, hi)
        self.in_k = torch.as_tensor(self.ar["input_k"], device=self.device)
        self.lead_off = torch.arange(self.leads, device=self.device) * fc
        self.hist_off = torch.arange(self.min_k, 0, device=self.device)
        self.t0s: List[np.ndarray] = []
        self.outputs: List[np.ndarray] = []
        self.per_unit = {"leads": self.batch * self.leads}
        self.per_time = self.batch * self.leads  # per-layer times a lead
        self.n_setup = 0

    def run_unit(self):
        t0 = self.rng.choice(np.arange(*self.t0_range), self.batch,
                             replace=False)
        self.t0s.append(t0)
        t0d = torch.as_tensor(t0, device=self.device)
        dyn = self.data["dynamic"]
        with torch.inference_mode():
            hist = torch.zeros((self.batch, self.H) + dyn.shape[1:],
                               device=self.device)
            hist[:, :-self.min_k] = dyn[t0d[:, None] + self.hist_off]
            bc = self.data["bc"][t0d[:, None, None] + self.lead_off[:, None]
                                 + self.in_k]
            _, _, preds = self.rollout(hist, None, bc, self.data["static"])
            self.outputs.append(preds[:, :, 0].cpu().numpy())

    def setup_units(self, n: int) -> Dict:
        for _ in range(n):
            self.run_unit()
        self.sync()
        self.n_setup = n
        return {}

    def failed(self) -> int:
        return int(sum(not np.isfinite(o).all() for o in self.outputs))

    def unit_counts(self, forward_flops: float, products: List):
        """A forecast's operations and Laplacian products: a forward a
        lead."""
        return forward_flops * self.leads, products * self.leads

    def program_readings(self, setup: Dict, seed: int) -> Dict:
        """A seeded sample of the forecasts made after set-up; their
        indices go into `setup['sample']`."""
        n = len(self.outputs) - self.n_setup
        rng = np.random.default_rng([int(seed), 1])
        pick = rng.choice(n, min(SAMPLE, n), replace=False)
        setup["sample"] = sorted(self.n_setup + int(i) for i in pick)
        return {"preds": [torch.as_tensor(self.outputs[i], device=self.device)
                          for i in setup["sample"]]}

    def reference_readings(self, setup: Dict, make_net, prec: str = "fp32"
                           ) -> Dict:
        net, data = make_net(prec), self.data
        return {"preds": [rollout(net, self.params, data["dynamic"],
                                  data["bc"], data["static"], self.t0s[i],
                                  self.leads, self.ar["input_k"],
                                  self.ar["forecast_cycle"])
                          for i in setup["sample"]]}

    @staticmethod
    def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
        pairs = list(zip(prog["preds"], ref["preds"]))
        return {"lead_gap": max(checks.lead_gap(p, r) for p, r in pairs),
                "lead_median_gap": max(checks.lead_median_gap(p, r)
                                       for p, r in pairs)}

    def fault_readings(self, setup, make_net, prog, ref) -> Dict:
        """Each sampled forecast's eleventh lead replaced by its tenth."""
        bad = [p.clone() for p in prog["preds"]]
        for b in bad:
            b[:, 10] = b[:, 9]
        return {"fault_repeated_lead": self.compare({"preds": bad}, ref)}

    def free(self):
        self.rollout = None
        super().free()
