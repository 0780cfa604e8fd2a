"""Port serving path vs the JAX package, and the port's import hygiene.

ForecastService.predict / submit of the port (padded and split batches,
n_steps not a multiple of the block size, scaler round trip) are held
against the JAX block rollout chained by hand, at HEALPix-4 (192 nodes:
not a multiple of the 128-row block, so the block-sparse operator pads)
with level 0 forced block-sparse and seeded weights on both sides.
Tolerance: max abs error / max abs of the reference <= 1e-4 in scaled
units (fp32, errors fed back through 5 autoregressive steps)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.data import load_scaler as jload_scaler  # noqa: E402
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_rollout_block as jmake_rollout_block,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.scalers import (  # noqa: E402
    GlobalStandardScaler,
    load_scaler,
)
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.serve import ForecastService, export_rollout  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SUBDIV, KNN = 4, 8
V = 12 * SUBDIV ** 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
F_IN = F_DYN + F_BC + F_STATIC
INPUT_K, OUTPUT_K, FC = [-3, -2, -1], [0], 1
BATCH, BLOCK, H = 2, 3, 4


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    info = {
        "input_n_feature": F_IN, "output_n_feature": F_DYN,
        "input_n_time": len(INPUT_K), "output_n_time": len(OUTPUT_K),
        "input_shape_info": {"dynamic": {"node": V}},
        "output_shape_info": {"dynamic": {"node": V}},
    }
    kw = {"subdivisions": SUBDIV, "nest": True}
    model = UNetSpherical(info, "healpix", kw, knn=KNN, pool_method="max",
                          increment_learning=True, dense_threshold=V - 1,
                          device="cpu")
    assert model.geometry.cheb_ops[0].bcsr is not None
    jmodel = JUNetSpherical(info, "healpix", kw, knn=KNN, pool_method="max",
                            increment_learning=True)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", kw, k=KNN).L, symmetric=True,
            interpret=True))
    tree = seeded_params(model, 21)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)

    rng = np.random.default_rng(22)
    static = rng.standard_normal((V, F_STATIC)).astype(np.float32)
    scaler = GlobalStandardScaler().fit(
        (rng.standard_normal((40, V, F_DYN)) * [50.0, 10.0] + [5400.0, 270.0]
         ).astype(np.float32), feature_order=["z500", "t850"])
    scaler_bc = GlobalStandardScaler().fit(
        (rng.standard_normal((40, V, F_BC)) * 100.0 + 300.0).astype(np.float32))
    rollout = export_rollout(
        model, params_from_jax(tree), input_k=INPUT_K, output_k=OUTPUT_K,
        forecast_cycle=FC, batch_size=BATCH, block_size=BLOCK, static=static,
        n_bc_features=F_BC, timestep_hours=6.0)
    svc = ForecastService(rollout, scaler=scaler, scaler_bc=scaler_bc)

    # the JAX reference uses the port's scalers after a save/load through
    # the JAX package's loader
    d = tmp_path_factory.mktemp("scalers")
    scaler.save(d / "dyn.npz")
    scaler_bc.save(d / "bc.npz")
    jscaler, jscaler_bc = jload_scaler(d / "dyn.npz"), jload_scaler(d / "bc.npz")
    jrollout, _ = jmake_rollout_block(jmodel, JARIndexer.build(
        INPUT_K, OUTPUT_K, FC, 1), BLOCK)
    geom = jmodel.geometry_pytree()

    def reference(hist, bc, n_steps):
        """JAX rollout chained by hand over ceil(n_steps / BLOCK) blocks."""
        n_blocks = -(-n_steps // BLOCK)
        bc = np.concatenate([bc, np.repeat(bc[:, -1:], n_blocks * BLOCK
                                           - bc.shape[1], axis=1)], axis=1)
        h = jnp.asarray(jscaler.transform(hist), jnp.float32)
        bcs = jnp.asarray(jscaler_bc.transform(bc), jnp.float32)
        preds = []
        for b in range(n_blocks):
            h, _, p = jrollout(jparams, h, None,
                               bcs[:, b * BLOCK:(b + 1) * BLOCK],
                               jnp.asarray(static), geom)
            preds.append(np.asarray(p))
        return jscaler.inverse_transform(
            np.concatenate(preds, axis=1)[:, :n_steps])

    return svc, reference, rng, (scaler, jscaler)


def _inputs(rng, n, n_steps):
    hist = (rng.standard_normal((n, H, V, F_DYN)) * [50.0, 10.0]
            + [5400.0, 270.0]).astype(np.float32)
    bc = (rng.standard_normal((n, n_steps, len(INPUT_K), V, F_BC)) * 100.0
          + 300.0).astype(np.float32)
    return hist, bc


def test_scaler_round_trip(setup, tmp_path):
    _, _, rng, (scaler, jscaler) = setup
    x = (rng.standard_normal((3, V, F_DYN)) * 20 + 100).astype(np.float32)
    np.testing.assert_allclose(scaler.transform(x), jscaler.transform(x))
    np.testing.assert_allclose(scaler.inverse_transform(scaler.transform(x)),
                               x, rtol=1e-6)
    jscaler.save(tmp_path / "j.npz")
    back = load_scaler(tmp_path / "j.npz")
    np.testing.assert_array_equal(back.mean, scaler.mean)
    assert back.feature_order == ["z500", "t850"]


@pytest.mark.parametrize("n", [1, 3], ids=["padded", "split"])
def test_predict_matches_jax_rollout(setup, n):
    # batch 1 pads to the rollout's batch 2; batch 3 splits into 2 + 1;
    # 5 steps = 2 blocks of 3, the last one cut
    svc, reference, rng, _ = setup
    hist, bc = _inputs(rng, n, 5)
    out = svc.predict(hist, n_steps=5, bc=bc)
    assert out.shape == (n, 5, 1, V, F_DYN)
    assert np.all(np.isfinite(out))
    # compared in scaled units, where the fields are O(1)
    scaler = svc.scaler
    assert rel_err(scaler.transform(out),
                   scaler.transform(reference(hist, bc, 5))) <= 1e-4
    np.testing.assert_array_equal(svc.leadtimes(2), [[0.0], [6.0]])


def test_submit_matches_jax_rollout(setup):
    # 3 concurrent single-sample requests of different lengths: coalesced
    # into device batches of 2, each answered with its own n_steps
    svc, reference, rng, _ = setup
    reqs = [(*(a[0] for a in _inputs(rng, 1, n)), n) for n in (2, 4, 5)]
    futs = [svc.submit(hst, n_steps=n, bc=b) for hst, b, n in reqs]
    for (hst, b, n), fut in zip(reqs, futs):
        out = fut.result(timeout=120)
        assert out.shape == (n, 1, V, F_DYN)
        ref = reference(hst[None], b[None], n)[0]
        assert rel_err(svc.scaler.transform(out),
                       svc.scaler.transform(ref)) <= 1e-4


# torch-only test helpers: the spawned ranks of tests/test_torch_parallel.py
# import the worker and the thread pin, chip_smoke.py the others, and none
# may pull JAX in
TEST_HELPERS = ("torch_parallel_worker", "torch_threads", "torch_grad_terms",
                "torch_steer", "torch_split_probe")


# the write log the CLI tests and chip_smoke.py's cli2rank put on the CLIs'
# path (read, not imported: it acts at interpreter start)
SITE_HELPERS = ("write_log_site/sitecustomize",)


def _port_sources():
    return sorted((REPO / "deepsphere_weather_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"] + [REPO / "tests" / f"{m}.py"
                                   for m in TEST_HELPERS + SITE_HELPERS]


def test_port_sources_import_no_jax():
    banned = ("jax", "jaxlib", "deepsphere_weather_tpu", "pandas", "optax",
              "matplotlib")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_import_checks_cover_every_sampling_module():
    """The checks above glob the package: the modules of the samplings,
    graphs, remap, pools, image convolution and variant architectures
    are among those they read and import."""
    mods = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for m in ("sphere/samplings.py", "sphere/graph.py", "sphere/remap.py",
              "ops/pool.py", "ops/conv2d.py", "models/variants.py",
              "models/geometry.py"):
        assert f"deepsphere_weather_torch/{m}" in mods


def test_import_checks_cover_the_ell_route():
    """The ELL product's modules (its wrapper and operator, the ELL mode
    of `ChebOperator`, `laplacian_to_ell`, `kernels/build.py`) are among
    those the checks read and import."""
    mods = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for m in ("ops/bcsr.py", "ops/cheb.py", "sphere/graph.py",
              "kernels/build.py"):
        assert f"deepsphere_weather_torch/{m}" in mods


def test_import_checks_cover_the_launch_and_cli_modules():
    """The launch path, the data-preparation CLIs, the experiment sweeps,
    the profiling harness and the write log are among the sources the
    checks read (and, but the write log, import)."""
    mods = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for m in ("cli/launch.py", "cli/prepare_toy_data.py",
              "cli/compute_scalers.py", "cli/compute_benchmarks.py",
              "cli/create_configs.py", "cli/experiments.py",
              "utils/profiling.py"):
        assert f"deepsphere_weather_torch/{m}" in mods
    assert "tests/write_log_site/sitecustomize.py" in mods


def test_port_imports_no_jax_in_fresh_process():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "deepsphere_weather_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + list(TEST_HELPERS)
    code = ("import importlib, sys\n"
            "sys.path.insert(0, 'tests')\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'deepsphere_weather_tpu', 'pandas', 'matplotlib')]\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal path does not run")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:     # alone, without the program
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
