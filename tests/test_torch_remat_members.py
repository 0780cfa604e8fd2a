"""Port member-parallel (DeepEnsemble) steps with `remat=True` vs the JAX
package's.

At HEALPix-4 (192 nodes, knn 8), fp32, level 0 block-sparse on both sides
(the JAX operator in Pallas interpret mode, the port's through its
autograd Function and the registered op's vmap rule on the kernels' plain
versions), M = 2 members drawn from two seeds and stacked
(`models.MemberStack`; the JAX tree with a leading [M] axis), AR2 (three
model calls), RNN strategy:

- `make_member_train_step(..., remat=True)` against JAX's
  `make_member_train_step(..., remat=True)`: losses within 1e-5, and the
  gradients the port's optimizer steps on within 1e-5 of those JAX's step
  takes (an optax transformation keeps them; a one-element leaf, ReZero or
  the increment scale, against the largest gradient: it is one sum in
  which terms cancel; a BatchNorm bias whose gradient cancels in exact
  arithmetic against its norm scale's, as `tests/test_torch_mesh_norm.py`
  holds it), with and without BatchNorm (`with_norm_state`: the
  folded running statistics within 1e-5 of the JAX step's; a gradient
  key of the BatchNorm model may read the two packages' gap without
  remat and JAX's own between its remat and plain steps besides, both
  fp32 rounding through the normalization); again with M = 5 (the JAX
  package's DeepEnsemble default, seeds 0-4) on the plain model, whose
  ELL products each carry all five members: one a member-stacked matvec
  at five times the widths of a one-member stack (but the first
  convolution's two on the shared batch), the recompute's as many again;
- the same port step against itself without remat: losses within 1e-6,
  the gradients and the folded statistics equal to 1e-6 (the recompute's
  statistics are not folded a second time), for the 'RNN' and 'AR'
  strategies and keep-first feedback, with the count of plain-version
  products: the recompute runs every forward product once more
  (`tests/test_torch_members.py` holds the launches of the member step);
- a node-sharded member step (1 data x 2 node ranks, one spawn of `gloo`
  ranks through `tests/torch_parallel_worker.py`) with remat against the
  same ranks without it and against the single-process step: losses and
  the reduced gradients within 1e-6 and 1e-5.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_grad_terms import cancelling_norm_biases  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_context,
    make_member_train_step as jmake_member_train_step,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402
from deepsphere_weather_tpu.utils.checkpoint import _path_str  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import make_member_train_step  # noqa: E402
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    norm_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_params,
)

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, B, M = 192, 8, 4, 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
JAX_TOL, SELF_TOL, MESH_TOL = 1e-5, 1e-6, 1e-5
AR2 = ([-3, -2, -1], [0], 1, 2)
# two outputs a call over overlapping windows: keep-first feedback
KEEP_FIRST = ([-2, -1], [0, 1], 1, 2)
W_AR = np.linspace(1.0, 0.5, 3).astype(np.float32)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def grad_errors(got, ref, scale_of=None, n_members=M):
    """{key: error} of two {key: array} gradient dicts: max abs error over
    the key's max abs; a leaf of one element a member (one sum in which
    terms cancel) against the largest gradient instead, and a key of
    `scale_of` against the key it names (a BatchNorm bias whose gradient
    cancels, `tests/torch_grad_terms.py`)."""
    assert sorted(got) == sorted(ref) and got
    scale_of = scale_of or {}
    top = max(float(np.abs(np.asarray(r, np.float64)).max())
              for r in ref.values())
    out = {}
    for k in ref:
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        denom = (top if r.size <= n_members
                 else np.abs(np.asarray(ref[scale_of[k]])).max()
                 if k in scale_of else np.abs(r).max())
        out[k] = (np.abs(g - r).max() / denom if denom
                  else 0.0 if np.array_equal(g, r) else np.inf)
    return out


def assert_grads_close(got, ref, tol, scale_of=None, n_members=M):
    for k, e in grad_errors(got, ref, scale_of, n_members).items():
        assert e <= (tol[k] if isinstance(tol, dict) else tol), (k, e)


def _keep_grads():
    """An optax transformation whose state is the last gradients and
    whose updates are zero: the JAX member step then returns each
    member's gradients as they are."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


GRAD_KEEPER = _keep_grads()


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def flat_jax(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _info(n_in=3, n_out=1):
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": n_in,
            "output_n_time": n_out,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def _trees(model, seeds=(0, 1)):
    trees = []
    for i, seed in enumerate(seeds):
        tree = seeded_params(model, seed)
        for blk in tree.values():
            if isinstance(blk, dict):
                blk["rezero_weight"] *= 0.1
        tree["res_increment"] *= 1 + 2 * i
        trees.append(tree)
    return trees


def _model(batch_norm=False, info=None):
    return UNetSpherical(info or _info(), "healpix", SAMPLING, knn=KNN,
                         pool_method="max", increment_learning=True,
                         batch_norm=batch_norm, dense_threshold=V - 1,
                         device="cpu")


def _batch(indexer, seed=20):
    rng = np.random.default_rng(seed)
    W = indexer.window_size
    return {"dynamic": rng.standard_normal((B, W, V, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((B, W, V, F_BC)).astype(np.float32),
            "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}


def _area_w():
    w = np.random.default_rng(7).uniform(0.5, 1.5, V).astype(np.float32)
    return w / w.sum()


def port_member_step(model, trees, indexer, batch, remat, batch_norm=False,
                     strategy="RNN"):
    """One port member step (SGD at lr 0: the gradients are the record):
    (total [M], per_iter [M, 3], {param: grad [M, ...]}, {buffer: folded
    statistics}, the widths of the ELL products run, in order)."""
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    opt = torch.optim.SGD(stack.parameters(), lr=0.0)
    grads = []
    opt.register_step_pre_hook(lambda *_: grads.append(
        {k: p.grad.numpy().copy() for k, p in stack.named_parameters()}))
    step = make_member_train_step(stack, indexer, opt, 3,
                                  ar_training_strategy=strategy,
                                  remat=remat, with_norm_state=batch_norm)
    widths = []
    orig = bcsr_mod.ell_spmm_reference

    def counted(vals, cols, x, *a, **k):
        widths.append(x.shape[1])
        return orig(vals, cols, x, *a, **k)
    bcsr_mod.ell_spmm_reference = counted
    try:
        total, per_iter = step({k: torch.from_numpy(v)
                                for k, v in batch.items()}, W_AR,
                               torch.from_numpy(_area_w()))
    finally:
        bcsr_mod.ell_spmm_reference = orig
    stats = {k: v.numpy().copy() for k, v in stack.norm_state().items()}
    return total.numpy(), per_iter.numpy(), grads[0], stats, widths


# (batch_norm, members): five members, the JAX package's DeepEnsemble
# default, on the fp32 model whose level 0 runs the ELL product
JAX_CASES = [(False, M), (True, M), (False, 5)]


@pytest.mark.parametrize("batch_norm,n_members", JAX_CASES,
                         ids=["plain", "bn", "plain-5members"])
def test_remat_member_step_matches_jax(batch_norm, n_members):
    model = _model(batch_norm)
    trees = _trees(model, seeds=tuple(range(n_members)))
    indexer, jindexer = ARIndexer.build(*AR2), JARIndexer.build(*AR2)
    batch = _batch(indexer)
    total, per_iter, grads, stats, widths = port_member_step(
        model, trees, indexer, batch, True, batch_norm)

    jmodel = JUNetSpherical(_info(), "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True,
                            batch_norm=batch_norm)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True, dtype=np.float32))
    jparams = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ctx = make_context(jmodel, jnp.asarray(_area_w()))

    def jstep_of(remat):
        """JAX's member step (its optimizer keeps the gradients as its
        state and leaves the parameters): (losses, per_iter, norm state,
        flat gradients)."""
        jstep = jmake_member_train_step(jmodel, jindexer, GRAD_KEEPER, 3,
                                        remat=remat,
                                        with_norm_state=batch_norm)
        jparams = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)
        state = jax.vmap(GRAD_KEEPER.init)(jparams)
        args = (jbatch, jnp.asarray(W_AR), ctx)
        if batch_norm:
            jns = jax.tree_util.tree_map(
                lambda x: jnp.stack([x] * n_members),
                jmodel.init_norm_state())
            _, state, jns, jtotal, jper = jstep(jparams, state, jns, *args)
        else:
            jns = None
            _, state, jtotal, jper = jstep(jparams, state, *args)
        return jtotal, jper, jns, flat_jax(state)

    jtotal, jper, jns, jgrads = jstep_of(True)
    assert rel_err(per_iter, jper) <= JAX_TOL
    assert rel_err(total, jtotal) <= JAX_TOL
    # the same step without remat
    total0, per0, grads0, stats0, widths0 = port_member_step(
        model, trees, indexer, batch, False, batch_norm)
    cancel = {k.replace(".", "/"): v.replace(".", "/")
              for k, v in cancelling_norm_biases(model).items()}
    assert bool(cancel) == batch_norm
    tol = JAX_TOL
    if batch_norm:
        # the BatchNorm model's fp32 gradients differ between the two
        # packages without remat too (up to 1.4e-5 on conv3's weights)
        # and within JAX between its remat and plain steps: a key may
        # read those two gaps and the port's own remat gap (1e-6) added
        jgrads0 = jstep_of(False)[3]
        gap = grad_errors(flat_jax(params_to_jax(_tensors(grads0))),
                          jgrads0, cancel)
        own = grad_errors(jgrads0, jgrads, cancel)
        tol = {k: max(JAX_TOL, gap[k] + own[k] + SELF_TOL) for k in gap}
        assert_grads_close(flat_jax(norm_state_to_jax(_tensors(stats))),
                           flat_jax(jns), JAX_TOL)
    assert_grads_close(flat_jax(params_to_jax(_tensors(grads))), jgrads,
                       tol, cancel, n_members)
    assert rel_err(per_iter, per0) <= SELF_TOL
    assert rel_err(total, total0) <= SELF_TOL
    assert_grads_close(grads, grads0, SELF_TOL, n_members=n_members)
    if batch_norm:
        assert_grads_close(stats, stats0, SELF_TOL)
    # one ELL product a member-stacked matvec: the step's forward (10 a
    # model call), as many again in the recompute, and its backward (but
    # the first convolution's on the raw input), each at n_members times
    # the widths of a one-member stack but those 2 on the shared batch
    one = port_member_step(model, trees[:1], indexer, batch, False)[4]
    fwd = 10 * 3
    assert len(widths0) == len(one) == 2 * fwd - 2
    assert widths0[:2] == one[:2] and widths0[2:] == [
        n_members * w for w in one[2:]]
    assert sorted(widths) == sorted(widths0 + widths0[:fwd])


CASES = [("RNN", AR2, 30, 28), ("AR", AR2, 30, 24),
         ("RNN", KEEP_FIRST, 30, 28)]


@pytest.mark.parametrize("strategy,ar,fwd,bwd", CASES,
                         ids=["rnn", "ar", "keep_first"])
def test_remat_member_step_matches_itself(strategy, ar, fwd, bwd):
    """Remat against no remat; the products: `fwd` forward (10 a model
    call) and `bwd` backward ones without remat, `fwd` more with it."""
    indexer = ARIndexer.build(*ar[:4], stack_most_recent_prediction=False)
    model = _model(info=_info(len(ar[0]), len(ar[1])))
    trees = _trees(model)
    batch = _batch(indexer, seed=3)
    total0, per0, grads0, _, widths0 = port_member_step(
        model, trees, indexer, batch, False, strategy=strategy)
    total, per, grads, _, widths1 = port_member_step(
        model, trees, indexer, batch, True, strategy=strategy)
    n0, n1 = len(widths0), len(widths1)
    assert rel_err(per, per0) <= SELF_TOL
    assert rel_err(total, total0) <= SELF_TOL
    assert_grads_close(grads, grads0, SELF_TOL)
    assert (n0, n1) == (fwd + bwd, 2 * fwd + bwd)


@pytest.fixture(scope="module", autouse=True)
def node_ranks(tmp_path_factory):
    """The member step on a 1 x 2 node mesh, without and with remat, in
    one spawn of 2 ranks started before the module's first test (they run
    while the JAX steps compile); and the single-process member step with
    remat. Returns a function that joins the ranks."""
    from torch_parallel_worker import (join_ranks, member_worker, start_ranks,
                                       tasks_worker)

    model = _model()
    trees = _trees(model)
    indexer = ARIndexer.build(*AR2)
    batch = _batch(indexer)
    cfg = {"n_data": 1, "n_node": 2, "n_member": 1, "n": V, "knn": KNN,
           "sampling": SAMPLING, "info": _info(), "ar": AR2,
           "members": [params_from_jax(t) for t in trees],
           "area_w": _area_w(), "batch": batch, "w": W_AR, "lr": 1e-4,
           "eps": 1e-3, "runs": ("float32",)}
    handle = start_ranks(tasks_worker, 2, tmp_path_factory.mktemp("ranks"),
                         [(member_worker, cfg),
                          (member_worker, dict(cfg, remat=True))])
    single = port_member_step(model, trees, indexer, batch, True)
    return lambda: (join_ranks(handle, timeout=300.0), single)


def test_remat_member_step_on_a_node_mesh(node_ranks):
    ranks, (total, per_iter, grads, _, _) = node_ranks()
    assert len(ranks) == 2
    for plain, remat in ranks:
        assert remat["pos"] == plain["pos"]
        for (t0, p0), (t1, p1) in zip(plain["float32"]["losses"],
                                      remat["float32"]["losses"]):
            assert rel_err(p1, p0) <= SELF_TOL
            assert rel_err(t1, t0) <= SELF_TOL
        for g0, g1 in zip(plain["float32"]["grads"],
                          remat["float32"]["grads"]):
            assert_grads_close(g1, g0, SELF_TOL)
        # the first step against the single process
        t1, p1 = remat["float32"]["losses"][0]
        assert rel_err(p1, per_iter) <= MESH_TOL
        assert rel_err(t1, total) <= MESH_TOL
        assert_grads_close(remat["float32"]["grads"][0], grads, MESH_TOL)
