"""Port training driver vs the JAX package: `AutoregressiveTraining` on the
same toy store from the same weights, and checkpoints resumed across the
packages.

Two runs, each through both drivers, at HEALPix-4 (192 nodes, knn 8),
fp32, batch 4, every update scored (`scoring_interval=1`, so every
update's loss is recorded):

- "levers": the device-cache path, global-norm clipping (0.05: every
  update clips), validation (one batch per interval), the "full"
  early-stopping reset and the lr-plateau lever, AR growth 0 -> 1 -> 2,
  then one plateau decay and the stop, with checkpoints;
- "sparse": the streaming loader with level 0 block-sparse on both sides
  (the JAX operator in Pallas interpret mode, the port's through its
  autograd Function on the kernels' plain versions), no validation, the
  "counter" reset, AR growth 0 -> 1, then the stop.

The early-stopping minimum improvement (10) is beyond any loss change, so
every growth, reset and stop falls after a fixed count of scorings: the
decisions are the drivers' logic, not a race between two losses.
Per-update losses are held to 2e-4 relative (`docs/PARITY_NUMERIC.md`:
1.6e-4 over 60 Adam steps); the decisions, the scheduler and
early-stopping states and the final learning rate must be equal.

Checkpoints: each run's files are read by the other package (parameters,
Adam moments and counts bit for bit, scheduler state equal), and from
each checkpoint both packages take the same two updates on one batch:
the second one's loss, which depends on the loaded moments and count, is
held to 1e-5 relative.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.cli.train_predict import (  # noqa: E402
    _make_optimizer as jmake_optimizer,
)
from deepsphere_weather_tpu.data import (  # noqa: E402
    GlobalStandardScaler as JGlobalStandardScaler,
    SphericalDataset as JSphericalDataset,
    StaticDataset as JStaticDataset,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine import (  # noqa: E402
    ARScheduler as JARScheduler,
    AreaWeights as JAreaWeights,
    AutoregressiveTraining as JAutoregressiveTraining,
    EarlyStopping as JEarlyStopping,
)
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_context,
    make_train_step as jmake_train_step,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402
from deepsphere_weather_tpu.utils import Checkpointer as JCheckpointer  # noqa: E402

from deepsphere_weather_torch.data import (  # noqa: E402
    ARIndexer,
    GlobalStandardScaler,
    SphericalDataset,
    StaticDataset,
)
from deepsphere_weather_torch.data.loader import AutoregressiveDataset  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    ARScheduler,
    AreaWeights,
    AutoregressiveTraining,
    EarlyStopping,
    clip_by_global_norm_,
    make_optimizer,
    make_train_step,
)
import deepsphere_weather_torch.engine.training as port_training  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.utils import Checkpointer  # noqa: E402
from deepsphere_weather_torch.weights import params_to_jax  # noqa: E402

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN = 192, 8
LOSS_TOL, RESUME_TOL = 2e-4, 1e-5
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
RUNS = {
    "levers": dict(
        ar_iterations=2, device_cache=True, sparse=False, validation=True,
        settings={"learning_rate": 1e-3, "gradient_clipping": 0.05,
                  "lr_plateau_decay": 0.5},
        levers=dict(early_stopping_reset_on_growth="full",
                    lr_plateau_decay=0.5, lr_plateau_max_decays=1),
        patience=4),
    "sparse": dict(
        ar_iterations=1, device_cache=False, sparse=True, validation=False,
        settings={"learning_rate": 1e-3},
        levers=dict(early_stopping_reset_on_growth="counter"),
        patience=10),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU work in this module: the
    suite's workers share the cores, and OpenMP teams oversubscribed
    across them slowed these small-shape runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def assert_stop_states(got, want):
    """Early-stopping states: equal, the best loss within the loss bar."""
    assert {k: v for k, v in got.items() if k != "best"} == \
        {k: v for k, v in want.items() if k != "best"}
    assert (got["best"] is None) == (want["best"] is None)
    if want["best"] is not None:
        assert rel(got["best"], want["best"]) <= LOSS_TOL


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_training")
    jgenerate_toy_data(root, sampling_kwargs=SAMPLING, n_timesteps=160,
                       seed=5)
    port = (SphericalDataset.open(root / DYN), SphericalDataset.open(root / BC),
            StaticDataset.open(root / STATIC))
    jax_ = (JSphericalDataset.open(root / DYN),
            JSphericalDataset.open(root / BC), JStaticDataset.open(root / STATIC))
    return {"root": root, "port": port, "jax": jax_}


def ar_settings(n_ar):
    return {"input_k": [-2, -1], "output_k": [0], "forecast_cycle": 1,
            "ar_iterations": n_ar}


def build_models(toy, n_ar, sparse):
    """The port's model at its init (seeded torch generator) and the JAX
    model with the same parameters; `sparse` puts level 0 on the
    block-sparse operator on both sides."""
    info = jget_ar_model_tensor_info(ar_settings(n_ar), toy["jax"][0],
                                     data_static=toy["jax"][2],
                                     data_bc=toy["jax"][1])
    thr = V - 1 if sparse else None
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          dense_threshold=thr, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True,
                            dense_threshold=thr)
    if sparse:
        assert model.geometry.cheb_ops[0].bcsr is not None
        jmodel.geometry.cheb_ops[0] = JChebOperator(
            bcsr=JBlockSparseOperator.from_scipy(
                jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
                interpret=True))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_jax(model.state_dict()))
    return model, jmodel, params


def _drive(toy, side, run, exp_dir):
    cfg = RUNS[run]
    n_ar = cfg["ar_iterations"]
    dyn, bc, st = toy[side]
    port = side == "port"
    sched = (ARScheduler if port else JARScheduler)(
        method="LinearStep", factor=0.5, fixed_ar_weights=[0],
        initial_ar_absolute_weights=[1])
    stop = (EarlyStopping if port else JEarlyStopping)(
        patience=cfg["patience"], minimum_improvement=10.0,
        minimum_iterations=0)
    scaler = (GlobalStandardScaler if port else JGlobalStandardScaler)(
        ).fit_dataset(dyn)
    kw = dict(
        training_data_dynamic=dyn.subset(0, 100),
        training_data_bc=bc.subset(0, 100), data_static=st, scaler=scaler,
        ar_training_strategy="RNN", ar_scheduler=sched, early_stopping=stop,
        epochs=3, training_batch_size=4, validation_batch_size=4,
        validation_batches=1, scoring_interval=1, num_workers=2,
        shuffle_seed=11, device_cache=cfg["device_cache"], exp_dir=exp_dir,
        verbose=False, **ar_settings(n_ar), **cfg["levers"])
    if cfg["validation"]:
        kw.update(validation_data_dynamic=dyn.subset(100, 160),
                  validation_data_bc=bc.subset(100, 160))
    model, jmodel, params = build_models(toy, n_ar, cfg["sparse"])
    if port:
        opt = make_optimizer(model.parameters(), cfg["settings"])
        _, opt, info = AutoregressiveTraining(
            model, optimizer=opt, area_weights=AreaWeights(
                build_sampling("healpix", SAMPLING), device="cpu"), **kw)
        lr = opt.param_groups[0]["lr"]
    else:
        _, opt_state, _, info = JAutoregressiveTraining(
            jmodel, params, optimizer=jmake_optimizer(cfg["settings"]),
            area_weights=JAreaWeights(jbuild_sampling("healpix", SAMPLING)),
            **kw)
        lr = float(opt_state.hyperparams["learning_rate"]) \
            if hasattr(opt_state, "hyperparams") else cfg["settings"][
                "learning_rate"]
    return {"info": info, "lr": lr, "sched": sched.state_dict(),
            "stop": stop.state_dict(), "exp": exp_dir}


@pytest.fixture(scope="module")
def runs(toy, tmp_path_factory):
    out = {}
    made = {"cached": 0, "streaming": 0}
    cached, streaming = (port_training.make_cached_train_step,
                         port_training.make_train_step)

    def count(kind, fn):
        def mk(*a, **k):
            made[kind] += 1
            return fn(*a, **k)
        return mk

    mp = pytest.MonkeyPatch()
    mp.setattr(port_training, "make_cached_train_step",
               count("cached", cached))
    mp.setattr(port_training, "make_train_step", count("streaming", streaming))
    try:
        for run in RUNS:
            before = dict(made)
            out[run] = {side: _drive(toy, side, run,
                                     tmp_path_factory.mktemp(f"{run}_{side}"))
                        for side in ("port", "jax")}
            out[run]["made"] = {k: made[k] - before[k] for k in made}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_training_matches_jax(runs, run):
    port, jax_ = runs[run]["port"], runs[run]["jax"]
    info, jinfo = port["info"], jax_["info"]
    # the device-cache choice: the steps of each AR stage came from the
    # path asked for (one per stage), the other none
    n_stages = RUNS[run]["ar_iterations"] + 1
    want = ("cached" if RUNS[run]["device_cache"] else "streaming")
    assert runs[run]["made"] == {want: n_stages,
                                 ({"cached", "streaming"} - {want}).pop(): 0}
    assert 20 <= len(info.iterations) <= 40
    assert info.iterations == jinfo.iterations == list(
        range(1, len(info.iterations) + 1))
    # the decisions: AR growth, epoch boundaries, the AR weights' schedule,
    # the early-stopping and scheduler states at the end, the final lr
    assert info.ar_growth_events == jinfo.ar_growth_events
    assert len(info.ar_growth_events) == RUNS[run]["ar_iterations"]
    assert info.epoch_boundaries == jinfo.epoch_boundaries
    assert info.ar_weights_history == jinfo.ar_weights_history
    assert port["sched"] == jax_["sched"]
    assert_stop_states(port["stop"], jax_["stop"])
    assert port["lr"] == pytest.approx(jax_["lr"], rel=1e-7)
    if run == "levers":
        assert port["lr"] == pytest.approx(5e-4)      # one plateau decay
    # per-update losses (train; validation and per-iteration when scored)
    assert np.isfinite(info.training_total_loss).all()
    assert rel(info.training_total_loss, jinfo.training_total_loss) \
        <= LOSS_TOL
    assert rel(info.validation_total_loss, jinfo.validation_total_loss) \
        <= LOSS_TOL
    for p, j in zip(info.per_iteration_loss, jinfo.per_iteration_loss):
        assert len(p) == len(j) and rel(p, j) <= LOSS_TOL
    saved = json.loads((port["exp"] / "training_info"
                        / "ar_training_info.json").read_text())
    assert sorted(saved) == sorted(jinfo.to_dict())


def test_clip_follows_optax():
    """optax.clip_by_global_norm, not torch's clip_grad_norm_: kept below
    the bar, (g / n) * max_norm above it."""
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (1,))]
    for max_norm in (0.5, 100.0):
        want = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)[0]
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = clip_by_global_norm_(got, max_norm)
        assert float(norm) == pytest.approx(
            float(optax.global_norm([jnp.asarray(g) for g in grads])),
            rel=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_checkpoint_files_share_the_layout(runs):
    """The port writes the keys, shapes and dtypes the JAX package writes:
    optax's chain and inject_hyperparams levels with clipping and the
    lr lever on ("levers"), plain optax.adam's without ("sparse")."""
    for run in RUNS:
        pdir, jdir = runs[run]["port"]["exp"], runs[run]["jax"]["exp"]
        for f in ("model_weights/model.npz", "training_info/opt_state.npz"):
            with np.load(pdir / f) as p, np.load(jdir / f) as j:
                assert sorted(p.files) == sorted(j.files)
                for k in j.files:
                    assert p[k].shape == j[k].shape, (run, f, k)
                    assert p[k].dtype == j[k].dtype, (run, f, k)
                assert bytes(p["__meta__"]) == bytes(j["__meta__"])
        with np.load(pdir / "training_info/opt_state.npz") as p:
            prefix = ".inner_state/1/0/" if run == "levers" else "0/"
            assert f"{prefix}.count" in p.files
        p_state = json.loads((pdir / "training_info/state.json").read_text())
        j_state = json.loads((jdir / "training_info/state.json").read_text())
        assert sorted(p_state) == sorted(j_state)
        assert p_state["ar_scheduler"] == j_state["ar_scheduler"]
        assert_stop_states(p_state["early_stopping"],
                           j_state["early_stopping"])


def _resume_batch(toy, n_ar):
    """One fixed training batch (scaled windows) and its AR weights."""
    dyn, bc, st = toy["port"]
    idx = ARIndexer.build(**ar_settings(n_ar))
    ds = AutoregressiveDataset(dyn.subset(0, 100), idx,
                               data_bc=bc.subset(0, 100), data_static=st,
                               scaler=GlobalStandardScaler().fit_dataset(dyn))
    b = ds.get_batch(np.arange(4))
    b["static"] = ds.static
    return {k: b[k] for k in ("dynamic", "bc", "static")}, \
        np.ones(n_ar + 1, np.float32)


def _two_updates_port(toy, run, ckpt_dir, batch, w):
    cfg = RUNS[run]
    n_ar = cfg["ar_iterations"]
    model, _, _ = build_models(toy, n_ar, cfg["sparse"])
    opt = make_optimizer(model.parameters(), cfg["settings"])
    ck = Checkpointer(ckpt_dir)
    ck.load_model(model)
    ck.load_training_state(opt, model)
    # what was loaded, before the updates move it
    loaded = {name: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                     opt.state[p]["exp_avg_sq"].clone(),
                     int(opt.state[p]["step"]))
              for name, p in model.named_parameters()}
    lr = opt.param_groups[0]["lr"]
    step = make_train_step(model, ARIndexer.build(**ar_settings(n_ar)), opt,
                           n_ar + 1)
    area_w = AreaWeights(build_sampling("healpix", SAMPLING), device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    losses = [float(step(tb, w, area_w)[0]) for _ in range(2)]
    return losses, loaded, lr


_JAX_STEPS = {}


def _jax_step(toy, run):
    """(params template, optimizer, jitted train step, context) of a run,
    built once: both checkpoints of the run take the same compiled step."""
    if run not in _JAX_STEPS:
        cfg = RUNS[run]
        n_ar = cfg["ar_iterations"]
        _, jmodel, params = build_models(toy, n_ar, cfg["sparse"])
        optimizer = jmake_optimizer(cfg["settings"])
        step = jmake_train_step(jmodel, JARIndexer.build(**ar_settings(n_ar)),
                                optimizer, n_ar + 1)
        ctx = make_context(jmodel, JAreaWeights(jbuild_sampling("healpix",
                                                                SAMPLING)))
        _JAX_STEPS[run] = (params, optimizer, step, ctx)
    return _JAX_STEPS[run]


def _two_updates_jax(toy, run, ckpt_dir, batch, w):
    template, optimizer, step, ctx = _jax_step(toy, run)
    ck = JCheckpointer(ckpt_dir)
    params = ck.load_model(template)
    opt_state, _ = ck.load_training_state(optimizer.init(template))
    loaded = (params, opt_state)
    # the step donates its state: run it on copies
    p = jax.tree_util.tree_map(jnp.array, params)
    o = jax.tree_util.tree_map(jnp.array, opt_state)
    losses = []
    for _ in range(2):
        p, o, total, _ = step(p, o, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jnp.asarray(w), ctx)
        losses.append(float(total))
    return losses, loaded


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("run", list(RUNS))
def test_checkpoint_resumes_in_the_other_package(toy, runs, run, writer):
    ckpt_dir = runs[run][writer]["exp"]
    n_ar = RUNS[run]["ar_iterations"]
    batch, w = _resume_batch(toy, n_ar)
    losses, loaded, lr = _two_updates_port(toy, run, ckpt_dir, batch, w)
    jlosses, (params, opt_state) = _two_updates_jax(toy, run, ckpt_dir,
                                                    batch, w)
    # what each package loaded from the one file: equal
    adam = opt_state
    if RUNS[run]["settings"].get("lr_plateau_decay"):
        assert float(adam.hyperparams["learning_rate"]) == pytest.approx(
            lr, rel=1e-7)
        adam = adam.inner_state
    adam = adam[1][0] if RUNS[run]["settings"].get("gradient_clipping") \
        else adam[0]
    for name, (p, mu, nu, step) in loaded.items():
        node_p, node_mu, node_nu = params, adam.mu, adam.nu
        for part in name.split("."):
            node_p, node_mu, node_nu = node_p[part], node_mu[part], \
                node_nu[part]
        np.testing.assert_array_equal(p.numpy(), np.asarray(node_p))
        np.testing.assert_array_equal(mu.numpy(), np.asarray(node_mu))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(node_nu))
        assert step == int(adam.count) > 0
    # the scheduler and early-stopping state in the file, through both
    state = json.loads((ckpt_dir / "training_info/state.json").read_text())
    assert ARScheduler.from_state_dict(state["ar_scheduler"]).state_dict() \
        == JARScheduler.from_state_dict(state["ar_scheduler"]).state_dict()
    assert EarlyStopping.from_state_dict(state["early_stopping"]).state_dict() \
        == JEarlyStopping.from_state_dict(
            state["early_stopping"]).state_dict()
    # the next updates from the loaded state
    assert rel(losses, jlosses) <= RESUME_TOL


def test_params_to_jax_is_a_copy():
    """The exported tree stays as it was when the model trains on in
    place (it shared the parameters' memory, so a JAX run started from it
    began at the port's trained weights)."""
    p = torch.nn.Parameter(torch.ones(3))
    tree = params_to_jax({"w": p})
    with torch.no_grad():
        p.add_(1.0)
    np.testing.assert_array_equal(tree["w"], np.ones(3, np.float32))
