"""The port's profiling harness (`utils/profiling.py`) against the JAX
package's.

- `summarize_model`: the same lines (block, parameter count, tensor count
  or shape) and total as JAX's summary of the same UNetSpherical config
  (HEALPix-4, knn 8), with and without BatchNorm;
- `profile_step` (plain and pipelined, with a `torch.profiler` Chrome
  trace) and `profile_model`: the JAX functions' keys, positive times;
- `scalability_sweep` at HEALPix-4 and -8 (knn 8; a 3-level UNet needs
  HEALPix-4 at least), on the CPU: the JAX
  sweep's keys and node counts, entry by entry, positive times.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.utils import profiling as jprofiling  # noqa: E402

from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.utils import profiling  # noqa: E402

V = 192
SAMPLINGS = [{"sampling": "healpix",
              "sampling_kwargs": {"subdivisions": s, "nest": True}}
             for s in (4, 8)]


def _info():
    return {"input_n_feature": 5, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def _counts(summary):
    """{block: (count, tensors or shape)} and the total of a summary."""
    lines = summary.split("\n")
    out = {}
    for line in lines[1:-1]:
        name, n, rest = line.split(None, 2)
        out[name] = (int(n.replace(",", "")), rest)
    return lines[0], out, lines[-1]


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_summarize_model_matches_jax(batch_norm):
    kw = dict(knn=8, pool_method="max", increment_learning=True,
              batch_norm=batch_norm)
    model = UNetSpherical(_info(), "healpix", {"subdivisions": 4,
                                               "nest": True},
                          device="cpu", **kw)
    jmodel = JUNetSpherical(_info(), "healpix", {"subdivisions": 4,
                                                 "nest": True}, **kw)
    got = _counts(profiling.summarize_model(model))
    want = _counts(jprofiling.summarize_model(
        jmodel, jmodel.init(jax.random.key(0))))
    assert got == want
    assert "TOTAL" in got[2]


def test_profile_step_returns_the_jax_keys(tmp_path):
    model = UNetSpherical(_info(), "healpix", {"subdivisions": 4,
                                               "nest": True}, knn=8,
                          pool_method="max", device="cpu")
    x = torch.randn(2, 3, V, 5)

    def fwd(x):
        with torch.no_grad():
            return model(x)

    jfn = jax.jit(lambda x: x * 2.0)
    jx = jax.numpy.ones(4)
    for kw in ({}, {"pipelined": True}):
        got = profiling.profile_step(fwd, x, n=3, **kw)
        want = jprofiling.profile_step(jfn, jx, n=3, **kw)
        assert sorted(got) == sorted(want)
        assert got["median_s"] > 0 and got["n"] == 3
    got = profiling.profile_step(fwd, x, n=3, trace_dir=tmp_path / "tr")
    assert sorted(got) == sorted(jprofiling.profile_step(jfn, jx, n=3))
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    out = profiling.profile_model(model, batch_size=2, n=3)
    assert out["batch_size"] == 2 and out["median_s"] > 0


def test_scalability_sweep_matches_jax_keys(tmp_path):
    got = profiling.scalability_sweep(SAMPLINGS, knn_list=(8,),
                                      out_json=tmp_path / "sweep.json",
                                      device="cpu")
    want = jprofiling.scalability_sweep(SAMPLINGS, knn_list=(8,))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("sampling", "sampling_kwargs", "n_nodes", "knn",
                  "batch_size"):
            assert g[k] == w[k], k
        assert g["forward_ms"] > 0 and g["forward_backward_ms"] > 0
    assert json.loads((tmp_path / "sweep.json").read_text()) == json.loads(
        json.dumps(got))
    assert [g["n_nodes"] for g in got] == [192, 768]
    assert np.all([g["knn"] == 8 for g in got])
