"""Serving from artifacts: the port's export, artifacts on disk, service,
HTTP server and CLIs vs the JAX package.

One toy experiment (HEALPix-4, 192 nodes, knn 8, fp32, boundary
conditions and static features) is trained by the port's CLI, with
level 0 block-sparse (a low `dense_threshold`), so that the registered
SpMM op sits in every exported graph; a second member is the same
experiment with its weights moved by seeded noise. Both packages export, serve and predict
from these directories (the JAX package reads the port's checkpoints).

- Artifacts (with BC, without BC, 2 members) load in a fresh process
  whose geometry builder raises, and their outputs equal the JAX
  package's `exported.call` within 1e-5 (max abs error / max abs, scaled
  units); the meta keys are the JAX ones (`torch_version` for
  `jax_version`); the ensemble equals each member's own rollout within
  1e-5.
- `ForecastService.from_dir` (padding, split, micro-batching, the member
  axis, `summarize`, validation messages) equals the JAX service within
  1e-5; the HTTP endpoints answer what `svc.predict` does within 2e-4
  (the JAX test's bar: the micro-batched path pads another batch).
- `noise_block` and `perturbation`, `cli.predict` (with and without
  `bc_generator="toa"`) equal the JAX package within 1e-5.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.cli.export_model import main as jexport_main  # noqa: E402
from deepsphere_weather_tpu.cli.predict import main as jpredict_main  # noqa: E402
from deepsphere_weather_tpu.data import (  # noqa: E402
    SphericalDataset as JSphericalDataset,
    StaticDataset as JStaticDataset,
    generate_toy_data as jgenerate_toy_data,
    load_scaler as jload_scaler,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.data.toy import perturbation_basis  # noqa: E402
from deepsphere_weather_tpu.engine import (  # noqa: E402
    AutoregressivePredictions as JAutoregressivePredictions,
)
from deepsphere_weather_tpu.engine.prediction import (  # noqa: E402
    ForecastDataset as JForecastDataset,
)
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_rollout_block as jmake_rollout_block,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.serve import (  # noqa: E402
    ForecastService as JForecastService,
    export_rollout as jexport_rollout,
    load_artifact as jload_artifact,
    save_artifact as jsave_artifact,
)
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402

import deepsphere_weather_torch.models as models_mod  # noqa: E402
from deepsphere_weather_torch.cli.export_model import main as export_main  # noqa: E402
from deepsphere_weather_torch.cli.predict import main as predict_main  # noqa: E402
from deepsphere_weather_torch.cli.serve import serve  # noqa: E402
from deepsphere_weather_torch.cli.train_predict import main as train_main  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    SphericalDataset,
    StaticDataset,
    load_scaler,
)
from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import AutoregressivePredictions  # noqa: E402
from deepsphere_weather_torch.engine.prediction import ForecastDataset  # noqa: E402
from deepsphere_weather_torch.engine.step import make_rollout_block  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.serve import (  # noqa: E402
    ForecastService,
    export_rollout,
    save_artifact,
)
from deepsphere_weather_torch.utils import Checkpointer  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seeded_params,
)

REPO = Path(__file__).resolve().parent.parent
SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, F_DYN = 192, 8, 2
AR = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 1}
BATCH, BLOCK, N_STEPS = 2, 3, 5
TOL, HTTP_TOL = 1e-5, 2e-4
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
DENSE_THRESHOLD = 100         # level 0 (192 nodes) block-sparse
CONFIG = {
    "model_settings": {"sampling_name": "Healpix_toy", "sampling": "healpix",
                       "sampling_kwargs": SAMPLING, "knn": KNN,
                       "architecture_name": "UNetSpherical",
                       "increment_learning": True, "pool_method": "Max"},
    "training_settings": {"epochs": 1, "learning_rate": 0.002,
                          "training_batch_size": 16, "scoring_interval": 5},
    "ar_settings": {**AR, "ar_iterations": 1},
    "dataloader_settings": {"num_workers": 0},
}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def port_setup():
    """The port's `get_model` building level 0 block-sparse, for every
    CLI run of this module."""
    get_model = models_mod.get_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models_mod, "get_model", lambda *a, **k: get_model(
            *a, dense_threshold=DENSE_THRESHOLD, **k))
        yield


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """The toy data, the port-trained experiment, a second member (the
    same experiment, its weights moved by seeded noise) and the model of
    each."""
    root = tmp_path_factory.mktemp("artifact")
    data = root / "data"
    jgenerate_toy_data(data, sampling_kwargs=SAMPLING, n_timesteps=120,
                       seed=5)
    (root / "config.json").write_text(json.dumps(CONFIG))
    exp_dir, _ = train_main(root / "config.json", data, root / "exp",
                            force=True, ar_iterations_prediction=1,
                            device="cpu", verbose=False)
    member2 = root / "exp2" / exp_dir.name
    shutil.copytree(exp_dir, member2)
    info = json.loads((exp_dir / "tensor_info.json").read_text())
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          dense_threshold=DENSE_THRESHOLD, device="cpu")
    assert model.geometry.cheb_ops[0].bcsr is not None
    # member 2: the trained weights moved by 5% of each tensor's spread
    # (seeded weights make a rollout that grows several-fold per step)
    Checkpointer(exp_dir).load_model(model)
    rng = np.random.default_rng(31)
    with torch.no_grad():
        for p in model.parameters():
            p += 0.05 * (p.std() if p.numel() > 1 else p.abs()) * \
                torch.from_numpy(rng.standard_normal(p.shape).astype(
                    np.float32))
    Checkpointer(member2).save_model(model)
    models = []
    for d in (exp_dir, member2):
        m = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          dense_threshold=DENSE_THRESHOLD,
                          geometry=model.geometry, device="cpu")
        Checkpointer(d).load_model(m)
        models.append(m.eval())
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True)
    return {"root": root, "data": data, "dirs": (exp_dir, member2),
            "info": info, "models": models, "jmodel": jmodel,
            "jparams": [jax.tree_util.tree_map(
                jnp.asarray, params_to_jax(m.state_dict())) for m in models]}


def _no_bc_pair(root):
    """A seeded model without BC or static features, in both packages,
    exported and saved as artifacts."""
    info = {"input_n_feature": F_DYN, "output_n_feature": F_DYN,
            "input_n_time": 3, "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          dense_threshold=DENSE_THRESHOLD, device="cpu")
    tree = seeded_params(model, 32)
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True)
    kw = dict(**AR, batch_size=BATCH, block_size=BLOCK, timestep_hours=6.0)
    save_artifact(root / "port_no_bc", export_rollout(
        model, params_from_jax(tree), **kw))
    jsave_artifact(root / "jax_no_bc", jexport_rollout(
        jmodel, jax.tree_util.tree_map(jnp.asarray, tree), **kw))


# the fresh process: no geometry may be built while it loads and runs
LOADER = """
import sys
import numpy as np
import deepsphere_weather_torch.models.geometry as geometry
import deepsphere_weather_torch.models.unet as unet
import deepsphere_weather_torch.sphere as sphere

def refuse(*a, **k):
    raise AssertionError("loading an artifact built geometry")

for mod, name in ((geometry, "build_model_geometry"),
                  (geometry, "cached_graph_laplacian"),
                  (unet, "build_model_geometry"), (sphere, "build_graph")):
    setattr(mod, name, refuse)
from deepsphere_weather_torch.serve import load_artifact

inputs = dict(np.load(sys.argv[1]))
out = {}
for kind in ("bc", "no_bc", "ensemble"):
    rollout, scaler, _ = load_artifact(sys.argv[2] + "/port_" + kind)
    args = [inputs[kind + "_hist"]]
    if kind + "_bc" in inputs:
        args.append(inputs[kind + "_bc"])
    h, preds = rollout.call(*args)
    out[kind + "_h"], out[kind + "_preds"] = h.numpy(), preds.numpy()
    out[kind + "_meta"] = np.array(str(sorted(rollout.meta)))
    out[kind + "_scaler"] = np.array(scaler is not None)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def artifacts(exp):
    """Both packages' artifacts (with BC, without BC, 2 members), the
    port's loaded and run in a fresh process on seeded inputs, the JAX
    package's in this one."""
    root, data, dirs = exp["root"], exp["data"], exp["dirs"]
    kw = dict(batch_size=BATCH, block_size=BLOCK, verbose=False)
    export_main(dirs[0], data, out=root / "port_bc", device="cpu", **kw)
    export_main(dirs[0], data, out=root / "port_ensemble", device="cpu",
                member_dirs=list(dirs), **kw)
    jexport_main(dirs[0], data, out=root / "jax_bc", **kw)
    jexport_main(dirs[0], data, out=root / "jax_ensemble",
                 member_dirs=list(dirs), **kw)
    _no_bc_pair(root)

    rng = np.random.default_rng(40)
    hist = rng.standard_normal((BATCH, 4, V, F_DYN)).astype(np.float32)
    bc = rng.standard_normal((BATCH, BLOCK, 3, V, 1)).astype(np.float32)
    inputs = {"bc_hist": hist, "bc_bc": bc, "no_bc_hist": hist,
              "ensemble_hist": np.stack([hist, hist[::-1]]),
              "ensemble_bc": bc}
    np.savez(root / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, str(root / "inputs.npz"), str(root),
         str(root / "outputs.npz")], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(root / "outputs.npz")), inputs


@pytest.mark.parametrize("kind", ["bc", "no_bc", "ensemble"])
def test_artifact_loads_fresh_and_matches_jax(exp, artifacts, kind):
    out, inputs = artifacts
    jrollout, _, _ = jload_artifact(exp["root"] / f"jax_{kind}")
    args = [inputs[f"{kind}_hist"]] + (
        [inputs[f"{kind}_bc"]] if f"{kind}_bc" in inputs else [])
    h, preds = jrollout.call(*[jnp.asarray(a) for a in args])
    n_out = (2, BATCH) if kind == "ensemble" else (BATCH,)
    assert out[f"{kind}_preds"].shape == n_out + (BLOCK, 1, V, F_DYN)
    assert rel(out[f"{kind}_preds"], preds) <= TOL
    assert rel(out[f"{kind}_h"], h) <= TOL
    assert bool(out[f"{kind}_scaler"]) == (kind != "no_bc")


@pytest.mark.parametrize("kind", ["bc", "ensemble"])
def test_meta_matches_jax(exp, artifacts, kind):
    meta = json.loads((exp["root"] / f"port_{kind}" / "meta.json").read_text())
    jmeta = json.loads((exp["root"] / f"jax_{kind}" / "meta.json").read_text())
    assert set(meta) - {"torch_version"} == set(jmeta) - {"jax_version"}
    assert meta["torch_version"] == torch.__version__
    assert meta["platforms"] == ["cpu"]
    for k in set(jmeta) - {"jax_version", "platforms"}:
        assert meta[k] == jmeta[k], k
    files = {p.name for p in (exp["root"] / f"port_{kind}").iterdir()}
    jfiles = {p.name for p in (exp["root"] / f"jax_{kind}").iterdir()}
    assert files - {"rollout.pt2"} == jfiles - {"rollout.jaxexport"}
    assert "rollout.pt2" in files and "scaler_dynamic.npz" in files


def test_ensemble_equals_member_rollouts(exp, artifacts):
    out, inputs = artifacts
    static = torch.from_numpy(StaticDataset.open(
        exp["data"] / STATIC).read_stacked())
    for i, model in enumerate(exp["models"]):
        rollout, _ = make_rollout_block(
            model, ARIndexer.build(AR["input_k"], AR["output_k"], 1, 1),
            BLOCK)
        with torch.no_grad():
            h, _, preds = rollout(
                torch.from_numpy(inputs["ensemble_hist"][i]), None,
                torch.from_numpy(inputs["ensemble_bc"]), static)
        assert rel(out["ensemble_preds"][i], preds.numpy()) <= TOL, i
        assert rel(out["ensemble_h"][i], h.numpy()) <= TOL, i


@pytest.fixture(scope="module")
def services(exp, artifacts):
    root = exp["root"]
    return {kind: (ForecastService.from_dir(root / f"port_{kind}"),
                   JForecastService.from_dir(root / f"jax_{kind}"))
            for kind in ("bc", "no_bc", "ensemble")}


def _requests(exp, n, n_steps, seed):
    """Physical-unit histories from the toy store and BC fields."""
    dyn = SphericalDataset.open(exp["data"] / DYN)
    rng = np.random.default_rng(seed)
    t0 = rng.integers(3, dyn.n_time - 3, size=n)
    hist = np.stack([dyn.read_stacked(np.arange(t - 3, t + 1)) for t in t0])
    bc = np.stack([SphericalDataset.open(exp["data"] / BC).read_stacked(
        np.arange(t, t + n_steps * 3) % dyn.n_time).reshape(
            n_steps, 3, V, 1) for t in t0])
    return hist.astype(np.float32), bc.astype(np.float32)


def _scaled(svc, x):
    return svc.scaler.transform(x) if svc.scaler is not None else x


@pytest.mark.parametrize("kind", ["bc", "no_bc", "ensemble"])
@pytest.mark.parametrize("n", [1, 3], ids=["padded", "split"])
def test_service_from_dir_matches_jax(exp, services, kind, n):
    svc, jsvc = services[kind]
    hist, bc = _requests(exp, n, N_STEPS, seed=n)
    bc = None if kind == "no_bc" else bc
    out = svc.predict(hist, N_STEPS, bc)
    ref = np.asarray(jsvc.predict(hist, N_STEPS, bc))
    members = (2,) if kind == "ensemble" else ()
    assert svc.n_members == jsvc.n_members == (2 if members else 0)
    assert out.shape == members + (n, N_STEPS, 1, V, F_DYN)
    assert rel(_scaled(svc, out), _scaled(svc, ref)) <= TOL
    # unbatched input: the batch axis squeezed, the member axis kept
    one = svc.predict(hist[0], 2, None if bc is None else bc[0, :2])
    assert one.shape == members + (2, 1, V, F_DYN)
    np.testing.assert_array_equal(svc.leadtimes(2), jsvc.leadtimes(2))
    if members:
        scaled = _scaled(svc, out)
        s = svc.summarize(scaled)
        js = JForecastService.summarize(_scaled(svc, ref))
        for k in ("mean", "median", "spread"):
            assert np.isfinite(s[k]).all() and s[k].shape == scaled.shape[1:]
            # against the members' magnitude (the spread is a difference)
            assert np.abs(s[k] - js[k]).max() <= TOL * np.abs(scaled).max()


@pytest.mark.parametrize("kind", ["bc", "ensemble"])
def test_submit_matches_jax(exp, services, kind):
    svc, jsvc = services[kind]
    hist, bc = _requests(exp, 3, N_STEPS, seed=7)
    lengths = (2, 4, 5)
    futs = [svc.submit(hist[i], n, bc[i, :n]) for i, n in enumerate(lengths)]
    for i, (n, fut) in enumerate(zip(lengths, futs)):
        out = fut.result(timeout=120)
        ref = np.asarray(jsvc.predict(hist[i], n, bc[i, :n]))
        assert out.shape == ref.shape
        assert rel(_scaled(svc, out), _scaled(svc, ref)) <= TOL


def test_service_validation_messages_match_jax(exp, services):
    hist, bc = _requests(exp, 2, 2, seed=9)
    cases = [("bc", (hist[:, :3], 2, bc)), ("bc", (hist, 0, bc)),
             ("bc", (hist, 2, None)), ("bc", (hist, 2, bc[:, :1])),
             ("no_bc", (hist, 2, bc))]
    for kind, args in cases:
        msgs = []
        for svc in services[kind]:
            with pytest.raises(ValueError) as e:
                svc.predict(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs


def _post(url, payload):
    buf = io.BytesIO()
    np.savez(buf, **payload)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def test_http_endpoints(exp, artifacts):
    server, svc = serve(exp["root"] / "port_bc", port=0, block=False)
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(base + "/v1/meta", timeout=60) as r:
            assert json.loads(r.read()) == svc.meta
        hist, bc = _requests(exp, 3, N_STEPS, seed=11)
        got = _post(base + f"/v1/predict?n_steps={N_STEPS}",
                    {"history": hist, "bc": bc})
        want = svc.predict(hist, N_STEPS, bc)
        assert rel(_scaled(svc, got["forecast"]), _scaled(svc, want)) <= TOL
        np.testing.assert_array_equal(got["leadtimes"],
                                      svc.leadtimes(N_STEPS))
        one = _post(base + "/v1/predict?n_steps=3",        # micro-batched
                    {"history": hist[0], "bc": bc[0, :3]})
        assert rel(_scaled(svc, one["forecast"]),
                   _scaled(svc, want[0, :3])) <= HTTP_TOL
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/predict?n_steps=2", {"history": hist[:, :2]})
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_export_model_swag_samples_raises(exp):
    # an experiment without a SWAG posterior has nothing to sample
    # (tests/test_torch_swag.py exports one that has)
    with pytest.raises(FileNotFoundError, match="model_swag.npz"):
        export_main(exp["dirs"][0], exp["data"], swag_samples=2,
                    device="cpu", verbose=False)
    with pytest.raises(ValueError, match="not both"):
        export_main(exp["dirs"][0], exp["data"], swag_samples=2,
                    member_dirs=list(exp["dirs"]), device="cpu",
                    verbose=False)


def test_noise_block_matches_jax(exp):
    model, jmodel = exp["models"][0], exp["jmodel"]
    indexer = ARIndexer.build(AR["input_k"], AR["output_k"], 1, 1)
    rollout, H = make_rollout_block(model, indexer, BLOCK)
    jrollout, _ = jmake_rollout_block(
        jmodel, JARIndexer.build(AR["input_k"], AR["output_k"], 1, 1), BLOCK)
    rng = np.random.default_rng(50)
    hist = rng.standard_normal((BATCH, H, V, F_DYN)).astype(np.float32)
    static = StaticDataset.open(exp["data"] / STATIC).read_stacked()
    noise = 0.3 * rng.standard_normal(
        (BATCH, BLOCK, 1, V, F_DYN)).astype(np.float32)
    bc = rng.standard_normal((BATCH, BLOCK, 3, V, 1)).astype(np.float32)
    args = (torch.from_numpy(hist), None, torch.from_numpy(bc),
            torch.from_numpy(static))
    with torch.no_grad():
        h, _, preds = rollout(*args, torch.from_numpy(noise))
        _, _, clean = rollout(*args)
    jh, _, jpreds = jrollout(exp["jparams"][0], jnp.asarray(hist), None,
                             jnp.asarray(bc), jnp.asarray(static),
                             jmodel.geometry_pytree(), jnp.asarray(noise))
    assert preds.shape == (BATCH, BLOCK, 1, V, F_DYN)
    assert rel(preds.numpy(), jpreds) <= TOL
    assert rel(h.numpy(), jh) <= TOL
    # the first step's noise is added as is; later ones feed back
    np.testing.assert_allclose((preds - clean)[:, 0].numpy(), noise[:, 0],
                               atol=1e-5)


def _stores_close(path, jpath):
    fc, jfc = ForecastDataset.open(path), JForecastDataset.open(jpath)
    np.testing.assert_array_equal(fc.forecast_reference_time,
                                  jfc.forecast_reference_time)
    np.testing.assert_array_equal(fc.leadtime_hours, jfc.leadtime_hours)
    for name in fc.feature_order:
        assert rel(fc.variables[name][...], jfc.variables[name][...]) <= TOL


def test_perturbation_matches_jax(exp):
    root, data = exp["root"], exp["data"]
    dyn, bc = SphericalDataset.open(data / DYN), SphericalDataset.open(
        data / BC)
    jdyn, jbc = JSphericalDataset.open(data / DYN), JSphericalDataset.open(
        data / BC)
    scaler = load_scaler(data / "Scalers" / "GlobalStandardScaler_dynamic.npz")
    jscaler = jload_scaler(data / "Scalers" /
                           "GlobalStandardScaler_dynamic.npz")
    pert = {"basis": perturbation_basis(jbuild_sampling("healpix", SAMPLING),
                                        n_modes=8),
            "ic_sigma": np.array([0.2, 0.1], np.float32),
            "step_sigma": np.array([0.05, 0.1], np.float32), "seed": 3}
    kw = dict(**AR, ar_iterations=4, ar_blocks=3, batch_size=2,
              forecast_reference_times=dyn.time[[20, 40, 60]],
              perturbation=pert)
    AutoregressivePredictions(
        exp["models"][0], data_dynamic=dyn, data_bc=bc,
        data_static=StaticDataset.open(data / STATIC), scaler=scaler,
        zarr_fpath=root / "pert_port.zarr", **kw)
    JAutoregressivePredictions(
        exp["jmodel"], exp["jparams"][0], data_dynamic=jdyn, data_bc=jbc,
        data_static=JStaticDataset.open(data / STATIC), scaler=jscaler,
        zarr_fpath=root / "pert_jax.zarr", **kw)
    _stores_close(root / "pert_port.zarr", root / "pert_jax.zarr")


@pytest.mark.parametrize("bc_generator", [None, "toa"])
def test_cli_predict_matches_jax(exp, bc_generator):
    root, data, exp_dir = exp["root"], exp["data"], exp["dirs"][0]
    dyn = SphericalDataset.open(data / DYN)
    # the last reference times: the rollout outruns the BC store
    frts = [str(t) for t in dyn.time[[100, 112]]]
    kw = dict(forecast_reference_times=frts, ar_iterations=8, ar_blocks=4,
              batch_size=2, bc_generator=bc_generator, verbose=False)
    name = f"predict_{bc_generator}"
    fc = predict_main(exp_dir, data, out_path=root / f"{name}_port.zarr",
                      device="cpu", **kw)
    jpredict_main(exp_dir, data, out_path=root / f"{name}_jax.zarr", **kw)
    assert fc.n_frt == 2 and fc.n_leadtime == 9
    _stores_close(root / f"{name}_port.zarr", root / f"{name}_jax.zarr")
