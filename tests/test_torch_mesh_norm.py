"""BatchNorm over a node or data mesh vs the JAX package on one device.

The HEALPix-4 UNetSpherical with 'batch' normalization (knn 8, level 0
block-sparse: the port's row-sharded operator on the kernels' plain
versions, the JAX operator in Pallas interpret mode), weights drawn by
`weights.seeded_params`, two `with_norm_state` train steps (AR2, RNN,
batch 4, Adam lr 1e-4 with eps 1e-3, `tests/test_torch_norm.py`'s reason)
on 2 x 1, 1 x 2 and 2 x 2 meshes of spawned `gloo` ranks (every mesh in
turn on one spawn of 4 ranks). Every rank's
training-mode statistics are then the global batch's (two all-reduced
passes, `models.layers.batch_stats_over`), and their backward sums the
ranks' gradients (`parallel.all_reduce_sum`). Against the JAX
`make_train_step(with_norm_state=True)` on one device, on the same
weights and batches:

- the global losses of both steps, fp32 1e-5 (max abs error over max
  abs);
- the gradients Adam stepped on, reduced over the mesh, per key against
  `jax.grad` of the JAX loss at each step's weights: max abs error over
  the key's scale within the larger of fp32 1e-5 and twice the
  single-process port's own gap to JAX on that key (its gradient at the
  JAX weights). The scale is the key's max abs, but for the keys whose
  gradient cancels, held as the repo's other tests hold them
  (`torch_grad_terms`): a one-element gradient (ReZero weight,
  increment scale) against the sum of its terms' magnitudes, and a norm
  bias that feeds the next BatchNorm through no activation (zero in
  exact arithmetic) against its block's norm-scale gradient. The
  level-2 blocks' gradients read 1e-5 to 2e-5 apart between the
  single-process port and JAX; the mesh sums the statistics in another
  order (the ranks' partial sums, then the all-reduce), a second
  rounding of the same size: hence twice. The card's BatchNorm test
  holds its bf16 gradients the same way (the larger of the bar and the
  CPU's own gap);
- the running statistics after each step, fp32 1e-5, and identical on
  every rank; the parameters after the steps, fp32 1e-5, identical on
  every rank.

The member steps take the same statistics (each member its own, over
its member rank's data and node groups): two `with_norm_state` steps of
2 BatchNorm members on 2 x 1 x 2 and 1 x 2 x 2 against the
single-process port member step (which `tests/test_torch_members.py`
holds against JAX's), losses and each rank's members' running
statistics within fp32 1e-5.

A copy whose all-reduce backward returned the rank's own gradient (each
rank differentiating its loss share through the statistics alone) failed
here: its gradients read up to 1e-3 apart (the increment scale, over its
terms' sum), its second step's losses 9.1e-5.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_ar_loss_fn as jmake_ar_loss_fn,
    make_context,
    make_train_step as jmake_train_step,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    Adam,
    make_ar_loss_fn,
    make_member_train_step,
)
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    norm_state_from_jax,
    params_from_jax,
    seeded_params,
)
from torch_grad_terms import cancelling_norm_biases, term_sums  # noqa: E402
from torch_parallel_worker import (  # noqa: E402
    bn_member_worker,
    bn_worker,
    join_ranks,
    start_ranks,
    tasks_worker,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, B = 192, 8, 4
F_DYN, F_BC, F_STATIC = 2, 1, 2
AR = ([-3, -2, -1], [0], 1, 2)
LR, EPS = 1e-4, 1e-3
FP32 = 1e-5
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
MEMBER_MESHES = {"2x1x2": (2, 1, 2), "1x2x2": (1, 2, 2)}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def tensor_info():
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": 3, "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _model():
    return UNetSpherical(tensor_info(), "healpix", SAMPLING, knn=KNN,
                         pool_method="max", increment_learning=True,
                         batch_norm=True, dense_threshold=V - 1,
                         device="cpu")


def _single_grads(tree, batch, w, area_w):
    """The single-process port's gradient at the JAX weights `tree`, and
    the sums of the one-element gradients' terms' magnitudes."""
    model = _model()
    model.load_state_dict(params_from_jax(tree))
    sums = term_sums(model)
    loss = make_ar_loss_fn(model, ARIndexer.build(*AR), 3, collect_stats=True)
    total, _ = loss({k: torch.from_numpy(v) for k, v in batch.items()}, w,
                    torch.from_numpy(area_w))
    total.backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()}, sums


def _scales(ref, sums):
    """Each key's scale (module docstring)."""
    cancel = cancelling_norm_biases(_model())
    return {k: (sums[k] if k in sums
                else np.abs(ref[cancel[k]]).max() if k in cancel
                else np.abs(v).max()) for k, v in ref.items()}


def _seeded(seed):
    """Seeded weights (JAX tree), the ReZero weights scaled by 0.1."""
    tree = seeded_params(_model(), seed)
    for blk in tree.values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    return tree


def _setup():
    """The seeded weights (JAX tree), the batches, AR and area weights."""
    tree = _seeded(12)
    rng = np.random.default_rng(13)
    W = JARIndexer.build(*AR).window_size
    batch = {"dynamic": rng.standard_normal((B, W, V, F_DYN)),
             "bc": rng.standard_normal((B, W, V, F_BC)),
             "static": rng.standard_normal((V, F_STATIC))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    w = np.linspace(1.0, 0.5, 3).astype(np.float32)
    area_w = rng.uniform(0.5, 1.5, V).astype(np.float32)
    return tree, batch, w, area_w / area_w.sum()


def _jax_reference(tree, batch, w, area_w):
    """Two JAX `with_norm_state` steps on one device: per step the loss,
    `jax.grad` at its weights (and the single-process port's there) and
    the running statistics after it; the parameters after both."""
    jmodel = JUNetSpherical(tensor_info(), "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True,
                            batch_norm=True)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True, dtype=np.float32))
    jindexer = JARIndexer.build(*AR)
    ctx = make_context(jmodel, jnp.asarray(area_w))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    grad_fn = jax.jit(jax.grad(jmake_ar_loss_fn(jmodel, jindexer, 3, "RNN",
                                                collect_stats=True),
                               has_aux=True))
    opt = optax.adam(LR, eps=EPS)
    step = jmake_train_step(jmodel, jindexer, opt, 3, "RNN",
                            with_norm_state=True)
    params = jax.tree_util.tree_map(jnp.array, tree)
    opt_state, ns = opt.init(params), jmodel.init_norm_state()
    out = {"losses": [], "grads": [], "single": [], "scales": [],
           "norm_state": []}
    for _ in range(2):
        out["grads"].append(_flat(grad_fn(params, jbatch, jnp.asarray(w),
                                          ctx)[0]))
        single, sums = _single_grads(
            jax.tree_util.tree_map(np.asarray, params), batch, w, area_w)
        out["single"].append(single)
        out["scales"].append(_scales(out["grads"][-1], sums))
        params, opt_state, ns, total, per_iter = step(
            params, opt_state, ns, jbatch, jnp.asarray(w), ctx)
        out["losses"].append((float(total), np.asarray(per_iter)))
        out["norm_state"].append({k: v.numpy() for k, v in
                                  norm_state_from_jax(jax.tree_util.tree_map(
                                      np.asarray, ns)).items()})
    out["params"] = _flat(params)
    return out


def _single_members(members, batch, w, area_w):
    """Two `with_norm_state` member steps in one process: every member's
    losses and running statistics after each."""
    stack = MemberStack.from_states(_model(), members)
    opt = Adam(stack.parameters(), LR, member_axis=True, eps=EPS)
    step = make_member_train_step(stack, ARIndexer.build(*AR), opt, 3,
                                  with_norm_state=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"losses": [], "norm_state": []}
    for _ in range(2):
        out["losses"].append(step(tb, w, torch.from_numpy(area_w))[1]
                             .numpy())
        out["norm_state"].append({k: v.numpy().copy()
                                  for k, v in stack.norm_state().items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, batch, w, area_w = _setup()
    params = params_from_jax(tree)
    members = [params, params_from_jax(_seeded(14))]
    common = {"n": V, "knn": KNN, "info": tensor_info(),
              "sampling": SAMPLING, "ar": AR, "batch": batch, "w": w,
              "area_w": area_w, "lr": LR, "eps": EPS}
    # every mesh in turn on one spawn of 4 ranks
    tasks = [(bn_worker, {**common, "n_data": d, "n_node": j,
                          "params": params}) for d, j in MESHES.values()]
    tasks += [(bn_member_worker, {**common, "n_data": d, "n_node": j,
                                  "n_member": m, "members": members})
              for d, j, m in MEMBER_MESHES.values()]
    handle = start_ranks(tasks_worker, 4, tmp_path_factory.mktemp("bn"),
                         tasks)
    try:
        reference = _jax_reference(tree, batch, w, area_w)
        reference["members"] = _single_members(members, batch, w, area_w)
    finally:
        ranks = join_ranks(handle)
    names = list(MESHES) + list(MEMBER_MESHES)
    results = {name: [r[i] for r in ranks if r[i] is not None]
               for i, name in enumerate(names)}
    return results, reference


@pytest.fixture(params=list(MESHES))
def ranks(request, runs):
    return runs[0][request.param]


@pytest.fixture
def reference(runs):
    return runs[1]


def test_bn_mesh_losses_match_jax(ranks, reference):
    for r in ranks:
        for (total, per_iter), (jtotal, jper) in zip(r["losses"],
                                                     reference["losses"]):
            assert rel_err(total, jtotal) <= FP32
            assert rel_err(per_iter, jper) <= FP32


def test_bn_mesh_gradients_match_jax(ranks, reference):
    for r in ranks:
        for grads, ref, single, scale in zip(
                r["grads"], reference["grads"], reference["single"],
                reference["scales"]):
            assert sorted(grads) == sorted(ref)
            for k, g in grads.items():
                e, own = (np.abs(np.asarray(t, np.float64) - ref[k]).max() / scale[k]
                          for t in (g, single[k]))
                assert e <= max(FP32, 2 * own), (k, e, own)


def test_bn_mesh_running_stats_match_jax(ranks, reference):
    for step, ref in enumerate(reference["norm_state"]):
        first = ranks[0]["norm_state"][step]
        assert sorted(first) == sorted(ref)
        for k, v in first.items():
            assert rel_err(v, ref[k]) <= FP32, (step, k)
        for r in ranks[1:]:
            for k, v in r["norm_state"][step].items():
                np.testing.assert_array_equal(v, first[k], err_msg=k)


def test_bn_mesh_params_match_jax(ranks, reference):
    for k, v in ranks[0]["params"].items():
        assert rel_err(v, reference["params"][k]) <= FP32, k
    for r in ranks[1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k],
                                          err_msg=k)


@pytest.mark.parametrize("name", list(MEMBER_MESHES))
def test_bn_member_mesh_matches_one_process(runs, name):
    want = runs[1]["members"]
    for r in runs[0][name]:
        m0, m1 = r["members"]
        for losses, ref in zip(r["losses"], want["losses"]):
            assert rel_err(losses, ref) <= FP32
        for state, ref in zip(r["norm_state"], want["norm_state"]):
            for k, v in state.items():
                assert rel_err(v, ref[k][m0:m1]) <= FP32, k
