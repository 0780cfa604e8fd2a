"""The mesh's member axis vs the JAX package.

A stack of M = 4 HEALPix-4 UNetSphericals (knn 8, level 0 block-sparse:
the port's operator on the kernels' plain versions, the JAX operator in
Pallas interpret mode), members drawn from four seeds
(`weights.seeded_params`), on meshes of spawned `gloo` ranks
(`tests/torch_parallel_worker.py`; every mesh in turn on one spawn of 4
ranks, limited to 240 s):

- `make_member_train_step(mesh=...)` on 1 x 1 x 2, 2 x 1 x 2 and
  1 x 2 x 2 (data x node x member), two steps (AR1, RNN, batch 4, Adam
  lr 1e-4 with eps 1e-3, `tests/test_torch_members.py`'s reason), fp32
  and bf16, against the body of JAX's `make_member_train_step` on one
  device (`jax.vmap` of `jax.value_and_grad` of its loss and of optax's
  Adam update, the loss and gradients jitted once a precision so that
  the gradients come with the step): every member's losses of both steps on every rank (gathered
  over the member group, in member order), the gradients each rank's
  members stepped on (reduced over the node and data groups) against
  `jax.vmap(jax.grad)` at each step's weights, and the members'
  parameters after both steps: fp32 1e-5 per key (max abs error over
  max abs; a one-element leaf against the largest leaf of its kind, as
  `tests/test_torch_members.py` holds it), bf16 3e-2. The bf16
  gradients are held at the first step, where both sides hold the same
  weights, to the larger of 3e-2 and twice the single-process port's own
  gap to JAX on that key: the level-2 blocks (12 nodes) read 3.2e-2 to
  3.5e-2 apart, and the mesh's reductions round once more (the bf16
  card tests hold gradients the same way). Each rank holds
  its M / n_member members; a member's parameters are identical on all
  of its data and node ranks.
- K5 over K2: on the node-sharded ranks, the vmapped row-sharded product
  of 4 members and its vjp equal the loop over the members exactly, with
  one gather and one row-range call each way for all members (the loop:
  one per member).
- `ensemble_rollout_predictions(mesh=...)` on 1 x 1 x 2: every rank
  returns every member's predictions, within fp32 1e-5 of JAX's.
- `AutoregressiveTraining(n_members=4, mesh=...)` on 1 x 2 x 2 (toy
  store, AR growth 0 -> 1 and an early stop, both at fixed counts of
  scorings: minimum improvement 1e4), given the model with its whole
  geometry as the CLI gives it (the driver shards it and puts it back),
  takes the single-process run's decisions, with its losses within
  1e-5.
- Checkpoints across layouts: the member mesh's checkpoint (written by
  rank 0, the whole [M, ...] stack) equals the single-process run's, and
  a run resumed on the mesh from the single process's checkpoint matches
  one resumed on one process from the mesh's (1e-5).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data import (  # noqa: E402
    GlobalStandardScaler as JGlobalStandardScaler,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_ar_loss_fn as jmake_ar_loss_fn,
    make_context,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.prob import (  # noqa: E402
    ensemble_rollout_predictions as jensemble_rollout_predictions,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data import (  # noqa: E402
    GlobalStandardScaler,
    SphericalDataset,
    StaticDataset,
)
from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    Adam,
    ARScheduler,
    AutoregressiveTraining,
    EarlyStopping,
    make_member_train_step,
)
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.utils import Checkpointer  # noqa: E402
from deepsphere_weather_torch.utils.checkpoint import load_arrays  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    seeded_params,
    stack_states,
)
from torch_parallel_worker import (  # noqa: E402
    join_ranks,
    member_driver_worker,
    member_worker,
    start_ranks,
    tasks_worker,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, B, M = 192, 8, 4, 4
F_DYN, F_BC, F_STATIC = 2, 1, 2
AR = ([-3, -2, -1], [0], 1, 1)
N_SCAN = AR[3] + 1
LR, EPS = 1e-4, 1e-3
PRECISIONS = {"fp32": "float32", "bf16": "bfloat16"}
TOL = {"fp32": 1e-5, "bf16": 3e-2}
MESHES = {"1x1x2": (1, 1, 2), "2x1x2": (2, 1, 2), "1x2x2": (1, 2, 2)}
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
AR_SETTINGS = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 1,
               "ar_iterations": 1}
DRIVE = dict(**AR_SETTINGS, epochs=1, training_batch_size=8,
             validation_batch_size=8, scoring_interval=1,
             validation_batches=1, shuffle=True, shuffle_seed=3,
             device_cache=True, num_workers=1, verbose=False, n_members=M,
             learning_rate=LR)
# growth and the stop at fixed counts of scorings: no validation loss
# improves on the first by the minimum improvement
SCHEDULER = dict(method="LinearStep", factor=0.5, fixed_ar_weights=[0],
                 initial_ar_absolute_weights=[1])
STOPPING = dict(patience=2, minimum_improvement=1e4)
# the training periods [0, end) of the fresh and the resumed runs
TRAIN_ENDS = (80, 40)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def assert_members_close(got, ref, tol, own=None):
    """{key: [m, ...]} against {key: [m, ...]}, key by key; a leaf of one
    element a member against the largest leaf of its kind (module
    docstring). With `own` ({key: [m, ...]}), each key's bar is the larger
    of `tol` and twice own's error on it."""
    assert sorted(got) == sorted(ref) and got
    top = max(np.abs(np.asarray(r, np.float64)).max() for r in ref.values())

    def err(g, k):
        r = np.asarray(ref[k], np.float64)
        denom = top if r[0].size == 1 else np.abs(r).max()
        return np.abs(np.asarray(g, np.float64) - r).max() / denom

    for k, g in got.items():
        assert g.shape == np.shape(ref[k]), k
        bar = tol if own is None else max(tol, 2 * err(own[k], k))
        assert err(g, k) <= bar, (k, err(g, k), bar)


def tensor_info():
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": 3, "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def _model(info=None, dt="float32"):
    return UNetSpherical(info or tensor_info(), "healpix", SAMPLING, knn=KNN,
                         pool_method="max", increment_learning=True,
                         numeric_precision=dt, dense_threshold=V - 1,
                         device="cpu")


def _jmodel(info=None, dt="float32"):
    jmodel = JUNetSpherical(info or tensor_info(), "healpix", SAMPLING,
                            knn=KNN, pool_method="max",
                            increment_learning=True, numeric_precision=dt)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True,
            dtype=jnp.bfloat16 if dt == "bfloat16" else np.float32))
    return jmodel


def _trees(info=None, seed0=0):
    model = _model(info)
    trees = []
    for m in range(M):
        tree = seeded_params(model, seed0 + m)
        for blk in tree.values():
            if isinstance(blk, dict):
                blk["rezero_weight"] *= 0.1
        trees.append(tree)
    return trees


def _stack_trees(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _single_bf16_grads(trees, batch, w, area_w):
    """The single-process port's bf16 member gradients at the initial
    weights (its own first member step's)."""
    stack = MemberStack.from_states(_model(dt="bfloat16"),
                                    [params_from_jax(t) for t in trees])
    opt = Adam(stack.parameters(), LR, member_axis=True, eps=EPS)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {k: p.grad.numpy().copy() for k, p in stack.named_parameters()}))
    make_member_train_step(stack, ARIndexer.build(*AR), opt, N_SCAN)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, w,
        torch.from_numpy(area_w))
    return grads


def _jax_steps(dt, trees, batch, w, area_w):
    """The JAX member step's body, twice, at precision `dt` (module
    docstring): every member's losses, the gradients at each step's
    weights and the parameters after both."""
    jmodel = _jmodel(dt=PRECISIONS[dt])
    jindexer = JARIndexer.build(*AR)
    ctx = make_context(jmodel, jnp.asarray(area_w))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss = jmake_ar_loss_fn(jmodel, jindexer, N_SCAN, "RNN")
    value_and_grad = jax.jit(jax.vmap(
        jax.value_and_grad(loss, has_aux=True),
        in_axes=(0, None, None, None)))
    opt = optax.adam(LR, eps=EPS)
    params = _stack_trees([jax.tree_util.tree_map(jnp.asarray, t)
                           for t in trees])
    opt_state = jax.vmap(opt.init)(params)
    res = {"losses": [], "grads": []}
    for _ in range(2):
        (total, per_iter), grads = value_and_grad(
            params, jbatch, jnp.asarray(w), ctx)
        res["grads"].append(_flat(grads))
        updates, opt_state = jax.vmap(opt.update)(grads, opt_state,
                                                  params)
        params = optax.apply_updates(params, updates)
        res["losses"].append((np.asarray(total), np.asarray(per_iter)))
    res["params"] = _flat(params)
    return res


def _toy(root):
    jdyn, jbc, jstatic = jgenerate_toy_data(root, sampling_kwargs=SAMPLING,
                                            n_timesteps=120, seed=11)
    info = jget_ar_model_tensor_info(AR_SETTINGS, jdyn, data_static=jstatic,
                                     data_bc=jbc)
    return (jdyn, jbc, jstatic), info


def _port_data(root, area_w, end):
    dyn = SphericalDataset.open(root / DYN)
    bc = SphericalDataset.open(root / BC)
    return dict(training_data_dynamic=dyn.subset(0, end),
                validation_data_dynamic=dyn.subset(80, 120),
                training_data_bc=bc.subset(0, end),
                validation_data_bc=bc.subset(80, 120),
                data_static=StaticDataset.open(root / STATIC),
                scaler=GlobalStandardScaler().fit_dataset(dyn),
                area_weights=torch.from_numpy(area_w))


def _single_fresh(info, members, data, exp_dir):
    stack = MemberStack.from_states(_model(info), members)
    _, _, record = AutoregressiveTraining(
        stack, exp_dir=exp_dir, ar_scheduler=ARScheduler(**SCHEDULER),
        early_stopping=EarlyStopping(**STOPPING), **data, **DRIVE)
    return record.to_dict(), {k: v.detach().numpy().copy()
                              for k, v in stack.state_dict().items()}


def _single_resumed(info, data, resume_from, exp_dir):
    stack = MemberStack(_model(info), M)
    opt = Adam(stack.parameters(), LR, member_axis=True)
    ck = Checkpointer(resume_from)
    ck.load_model(stack)
    state = ck.load_training_state(opt, stack)
    _, _, record = AutoregressiveTraining(
        stack, optimizer=opt, exp_dir=exp_dir,
        ar_scheduler=ARScheduler.from_state_dict(state["ar_scheduler"]),
        early_stopping=EarlyStopping(patience=100), **data, **DRIVE)
    return record.to_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process driver run first (the mesh resumes from its
    checkpoint), then every run of ranks at once; the JAX references and
    the single-process resume from the mesh's checkpoint after."""
    root = tmp_path_factory.mktemp("toy")
    exp = tmp_path_factory.mktemp("exp")
    jstores, info = _toy(root)
    rng = np.random.default_rng(21)
    area_w = rng.uniform(0.5, 1.5, V).astype(np.float32)
    area_w /= area_w.sum()
    W = JARIndexer.build(*AR).window_size
    batch = {"dynamic": rng.standard_normal((B, W, V, F_DYN)),
             "bc": rng.standard_normal((B, W, V, F_BC)),
             "static": rng.standard_normal((V, F_STATIC))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    w = np.linspace(1.0, 0.5, N_SCAN).astype(np.float32)
    trees = _trees()
    members = [params_from_jax(t) for t in trees]

    driver_trees = _trees(info, seed0=10)
    driver_members = [params_from_jax(t) for t in driver_trees]
    single = _single_fresh(info, driver_members,
                           _port_data(root, area_w, TRAIN_ENDS[0]),
                           exp / "single")

    stores = {"root": str(root), "dyn": DYN, "bc": BC, "static": STATIC}
    rollout = {**stores, "info": info, "sampling": SAMPLING, "knn": KNN,
               "n": V, "ar": (AR_SETTINGS["input_k"], AR_SETTINGS["output_k"],
                              1, 2),
               "stacked": {k: v.numpy() for k, v in
                           stack_states(driver_members).items()},
               "n_steps": 3, "t0s": np.array([10, 14, 30]), "batch_size": 2}
    # every mesh in turn on one spawn of 4 ranks
    tasks = [(member_worker, {
        "n_data": n_data, "n_node": n_node, "n_member": n_member, "n": V,
        "knn": KNN, "info": tensor_info(), "sampling": SAMPLING, "ar": AR,
        "members": members, "batch": batch, "w": w, "area_w": area_w,
        "lr": LR, "eps": EPS, "runs": list(PRECISIONS.values()),
        "rollout": rollout if name == "1x1x2" else None})
        for name, (n_data, n_node, n_member) in MESHES.items()]
    tasks.append((member_driver_worker, {
        **stores, "n_data": 1, "n_node": 2, "n_member": 2, "info": info,
        "sampling": SAMPLING, "knn": KNN, "n": V, "members": driver_members,
        "area_w": area_w, "scheduler": SCHEDULER, "stopping": STOPPING,
        "drive": DRIVE, "train_ends": TRAIN_ENDS,
        "exp_fresh": str(exp / "mesh"), "resume_from": str(exp / "single"),
        "exp_resumed": str(exp / "mesh_resumed")}))
    handle = start_ranks(tasks_worker, 4, tmp_path_factory.mktemp("ranks"),
                         tasks)
    jdyn, jbc, jstatic = jstores

    def jax_rollout():
        return jensemble_rollout_predictions(
            _jmodel(info), _stack_trees([jax.tree_util.tree_map(
                jnp.asarray, t) for t in driver_trees]),
            data_dynamic=jdyn, data_bc=jbc, data_static=jstatic,
            scaler=JGlobalStandardScaler().fit_dataset(jdyn),
            inverse_scale=False, indexer=JARIndexer.build(*rollout["ar"]),
            n_steps=3, t0s=rollout["t0s"], batch_size=2)

    try:
        # XLA compiles apart from the GIL: both precisions and the
        # rollout at once
        with ThreadPoolExecutor(3) as pool:
            steps = {dt: pool.submit(_jax_steps, dt, trees, batch, w, area_w)
                     for dt in PRECISIONS}
            roll = pool.submit(jax_rollout)
            reference = {dt: f.result() for dt, f in steps.items()}
            reference["rollout"] = roll.result()
        reference["bf16"]["single"] = _single_bf16_grads(trees, batch, w,
                                                         area_w)
    finally:
        ranks = join_ranks(handle, timeout=240.0)
    results = {name: [r[i] for r in ranks if r[i] is not None]
               for i, name in enumerate(list(MESHES) + ["driver"])}
    single_resumed = _single_resumed(
        info, _port_data(root, area_w, TRAIN_ENDS[1]), exp / "mesh",
        exp / "single_resumed")
    return {"results": results, "reference": reference, "exp": exp,
            "single": single, "single_resumed": single_resumed}


@pytest.fixture(params=list(MESHES))
def mesh_run(request, runs):
    return MESHES[request.param], runs["results"][request.param]


@pytest.mark.parametrize("dt", list(PRECISIONS))
def test_member_mesh_losses_match_jax(mesh_run, runs, dt):
    _, ranks = mesh_run
    ref = runs["reference"][dt]["losses"]
    for r in ranks:
        for (total, per_iter), (jtotal, jper) in zip(
                r[PRECISIONS[dt]]["losses"], ref):
            assert total.shape == (M,) and per_iter.shape == (M, N_SCAN)
            assert rel_err(total, jtotal) <= TOL[dt]
            assert rel_err(per_iter, jper) <= TOL[dt]


@pytest.mark.parametrize("dt", list(PRECISIONS))
def test_member_mesh_gradients_match_jax(mesh_run, runs, dt):
    (_, _, n_member), ranks = mesh_run
    ref = runs["reference"][dt]["grads"]
    for r in ranks:
        m0, m1 = r["members"]
        assert m1 - m0 == M // n_member
        if dt == "bf16":     # the first step (module docstring)
            own = {k: v[m0:m1] for k, v in
                   runs["reference"]["bf16"]["single"].items()}
            assert_members_close(r["bfloat16"]["grads"][0],
                                 {k: v[m0:m1] for k, v in ref[0].items()},
                                 TOL[dt], own)
            continue
        for grads, jgrads in zip(r["float32"]["grads"], ref):
            assert_members_close(grads, {k: v[m0:m1]
                                         for k, v in jgrads.items()},
                                 TOL[dt])


@pytest.mark.parametrize("dt", list(PRECISIONS))
def test_member_mesh_params_match_jax(mesh_run, runs, dt):
    (n_data, n_node, n_member), ranks = mesh_run
    ref = runs["reference"][dt]["params"]
    assert [r["pos"] for r in ranks] == [
        (d, j, m) for d in range(n_data) for j in range(n_node)
        for m in range(n_member)]
    for r in ranks:
        m0, m1 = r["members"]
        assert (m0, m1) == (r["pos"][2] * M // n_member,
                            (r["pos"][2] + 1) * M // n_member)
        params = r[PRECISIONS[dt]]["params"]
        assert_members_close(params, {k: v[m0:m1] for k, v in ref.items()},
                             TOL[dt])
        # a member's parameters are the same on its data and node ranks
        # (rank pos[2] holds it at data and node rank 0)
        first = ranks[r["pos"][2]]
        assert first["members"] == (m0, m1)
        for k, v in params.items():
            np.testing.assert_array_equal(
                v, first[PRECISIONS[dt]]["params"][k], err_msg=k)


def test_k5_over_k2_folds_members_into_one_launch(runs):
    ranks = runs["results"]["1x2x2"]
    for r in ranks:
        got = r["k5_over_k2"]
        np.testing.assert_array_equal(got["vmap"]["y"], got["loop"]["y"])
        np.testing.assert_array_equal(got["vmap"]["gx"], got["loop"]["gx"])
        # forward and backward: one gather and one row-range call each,
        # for all 4 members; the loop makes one per member
        assert (got["vmap"]["launches"], got["vmap"]["gathers"]) == (2, 2)
        assert (got["loop"]["launches"], got["loop"]["gathers"]) == (8, 8)


def test_member_mesh_rollout_matches_jax(runs):
    ref = runs["reference"]["rollout"]
    for r in runs["results"]["1x1x2"]:
        preds = r["rollout"]["preds"]
        assert preds.shape == ref.shape == (M, 3, 3, 1, V, F_DYN)
        assert rel_err(preds, ref) <= TOL["fp32"]
        # one gather of the history and one of the predictions per block
        assert r["rollout"]["gathers"] == 2 * 2


def test_member_mesh_driver_takes_the_single_process_decisions(runs):
    record, _ = runs["single"]
    assert len(record["ar_growth_events"]) == 1
    for r in runs["results"]["driver"]:
        assert r["whole_geometry"]
        got = r["fresh"]["info"]
        for key in ("iterations", "validation_iterations",
                    "ar_growth_events", "epoch_boundaries"):
            assert got[key] == record[key], key
        for key in ("training_total_loss", "validation_total_loss",
                    "per_member_loss", "per_iteration_loss"):
            assert rel_err(got[key], record[key]) <= TOL["fp32"], key
        assert np.shape(got["per_member_loss"])[1] == M


def test_member_mesh_checkpoints_resume_across_layouts(runs):
    exp = runs["exp"]
    _, single_params = runs["single"]
    # the mesh's checkpoint: the whole stack, as one process writes it
    for name in ("model_weights/model.npz", "training_info/opt_state.npz"):
        mesh, single = (load_arrays(exp / d / name)
                        for d in ("mesh", "single"))
        assert sorted(mesh) == sorted(single)
        for k, v in mesh.items():
            assert v.shape == single[k].shape, k
            if np.abs(single[k]).max() > 0:
                assert rel_err(v, single[k]) <= TOL["fp32"], (name, k)
    # and every rank returns the whole trained stack
    for r in runs["results"]["driver"]:
        for k, v in r["fresh"]["params"].items():
            assert v.shape[0] == M
            assert rel_err(v, single_params[k]) <= TOL["fp32"], k
    # resumed on the mesh from one process's checkpoint, and on one
    # process from the mesh's: the same run
    want = runs["single_resumed"]
    assert len(want["iterations"]) > 2
    for r in runs["results"]["driver"]:
        got = r["resumed"]["info"]
        assert got["iterations"] == want["iterations"]
        for key in ("training_total_loss", "validation_total_loss",
                    "per_member_loss"):
            assert rel_err(got[key], want[key]) <= TOL["fp32"], key
