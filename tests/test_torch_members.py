"""Port member-parallel (DeepEnsemble) training and rollout vs the JAX
package.

At HEALPix-4 (192 nodes, knn 8), fp32, level 0 block-sparse on both sides
(the JAX operator in Pallas interpret mode, the port's through its
autograd Function and the registered op's vmap rule on the kernels' plain
versions), M = 2 members drawn from two seeds (`weights.seeded_params`)
and stacked (`models.MemberStack`; the JAX tree with a leading [M] axis):

- `make_member_train_step` and `make_cached_member_train_step`, 3 steps,
  with and without norm state (BatchNorm), with global-norm clipping at a
  bound between the two members' gradient norms (one member clips, the
  other does not): losses, parameters and running statistics within 2e-4
  of JAX's vmapped steps, and the Adam moments after the first (clipped)
  step (`utils.checkpoint.optimizer_arrays`, optax's layout with its [M]
  counts; later gradients follow parameters 1e-4 apart through ReLU
  decisions, so their moments are not a port check); each member
  within 1e-5 of the port's single step on that member alone (its own
  clipping). Adam runs with lr 1e-4 and eps 1e-3: with eps 1e-7 an
  element whose gradient is rounding-small (exactly zero for some
  BatchNorm biases, `tests/test_torch_norm.py`) takes a full step of size
  lr in each package's own direction, and at lr 1e-3 the parameters, 5e-7
  apart after two steps, flipped a decision (ReLU or max pool) in the
  third and read 6e-5 to 3e-4 apart, without any fault;
- one plain-version call per block-sparse product for both members: as
  many calls as the single step, each at twice its width, except the two
  products of the first convolution of the first AR iteration, whose
  input (the shared batch) has no member axis; every call the ELL
  product's (the fp32 operator's layout);
- the plain member step again at M = 5 (the JAX package's DeepEnsemble
  default, seeds 0-4, the member increment scales x1 to x9): the same
  bars, one ELL product per member-stacked matvec at five times the
  single widths;
- the member validation functions (eval mode with BatchNorm) within 1e-5;
- `AutoregressiveTraining(n_members=2)` on a toy store against JAX's:
  per-member validation losses and the member-mean losses within 2e-4;
  its refusals (`n_members` with `swag`, a wrong `initial_norm_state`,
  a member mesh the members do not divide over);
- `ensemble_rollout_predictions` within 1e-5, with boundary conditions and
  with keep-first feedback.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data import (  # noqa: E402
    GlobalStandardScaler as JGlobalStandardScaler,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine import (  # noqa: E402
    AutoregressiveTraining as JAutoregressiveTraining,
    EarlyStopping as JEarlyStopping,
)
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_cached_member_train_step as jmake_cached_member_train_step,
    make_cached_member_validation_fn as jmake_cached_member_validation_fn,
    make_context,
    make_member_train_step as jmake_member_train_step,
    make_member_validation_fn as jmake_member_validation_fn,
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
from deepsphere_weather_tpu.utils.checkpoint import _path_str  # noqa: E402

from deepsphere_weather_torch.data import (  # noqa: E402
    GlobalStandardScaler,
    SphericalDataset,
    StaticDataset,
)
from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    Adam,
    AutoregressiveTraining,
    EarlyStopping,
    make_cached_member_train_step,
    make_cached_member_validation_fn,
    make_member_train_step,
    make_member_validation_fn,
    make_train_step,
)
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.parallel import ProcessMesh, member_range  # noqa: E402
from deepsphere_weather_torch.prob import ensemble_rollout_predictions  # noqa: E402
from deepsphere_weather_torch.utils.checkpoint import optimizer_arrays  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    member_state,
    norm_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_params,
    stack_states,
)

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, B, M = 192, 8, 4, 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
TRAIN_TOL, SINGLE_TOL, FP32 = 2e-4, 1e-5, 1e-5
# Adam in the trajectory checks (module docstring): lr 1e-4, eps 1e-3
LR, ADAM_EPS = 1e-4, 1e-3
AR2 = ([-3, -2, -1], [0], 1, 2)
# products whose input is the shared batch (no member axis): the first
# convolution's two Laplacian products, in the first AR iteration
SHARED_PRODUCTS = 2


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _kind(key):
    """'mu', 'nu' or 'count' for an optax state key, '' for the rest."""
    return key.split("/.")[-1].split("/")[0] if "/." in key else ""


def assert_flat_close(got, ref, tol, n_members=M):
    """Two {key: array} dicts, key by key: max abs error over max abs of
    the reference. A leaf of one element a member (the ReZero weights, the
    increment scale, their moments) is one sum over a whole block's
    output, in which terms cancel: it is held against the largest leaf of
    its kind instead (`tests/test_torch_train.py` holds such gradients to
    the sum of their terms' magnitudes)."""
    assert sorted(got) == sorted(ref) and got
    scale = {}
    for k, r in ref.items():
        scale[_kind(k)] = max(scale.get(_kind(k), 0.0),
                              float(np.abs(np.asarray(r, np.float64)).max()))
    for k in got:
        r = np.asarray(ref[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == r.shape, k
        if np.abs(r).max() == 0:
            np.testing.assert_array_equal(g, r, k)
            continue
        denom = (scale[_kind(k)] if r.size <= n_members
                 else np.abs(r).max())
        e = np.abs(g - r).max() / denom
        assert e <= tol, (k, e)


def flat_jax(tree):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _info(n_in=3, n_out=1):
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": n_in,
            "output_n_time": n_out,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def _jax_sparse(jmodel):
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True, dtype=np.float32))
    return jmodel


def build_members(batch_norm, info=None, seeds=(0, 1)):
    """(port template, JAX model, per-member JAX trees)."""
    info = info or _info()
    kw = dict(knn=KNN, pool_method="max", increment_learning=True,
              batch_norm=batch_norm)
    model = UNetSpherical(info, "healpix", SAMPLING, dense_threshold=V - 1,
                          device="cpu", **kw)
    jmodel = _jax_sparse(JUNetSpherical(info, "healpix", SAMPLING, **kw))
    trees = []
    for i, seed in enumerate(seeds):
        tree = seeded_params(model, seed)
        for blk in tree.values():
            if isinstance(blk, dict):
                blk["rezero_weight"] *= 0.1
        # the increment scale x1 and x3: the output, and with it nearly
        # every gradient, of member 1 is larger (the clipping check puts
        # its bound between the members' gradient norms)
        tree["res_increment"] *= 1 + 2 * i
        trees.append(tree)
    return model, jmodel, trees


def stack_trees(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def make_batch(rng, indexer, batch=B):
    W = indexer.window_size
    return {"dynamic": rng.standard_normal((batch, W, V, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((batch, W, V, F_BC)).astype(np.float32),
            "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _area_w():
    w = np.random.default_rng(7).uniform(0.5, 1.5, V).astype(np.float32)
    return w / w.sum()


def grad_norm(model, indexer, batch, w, area_w):
    """Global gradient norm of one loss of `model` (no update)."""
    from deepsphere_weather_torch.engine import make_ar_loss_fn

    model.zero_grad(set_to_none=True)
    make_ar_loss_fn(model, indexer, 3)(batch, w, area_w)[0].backward()
    norm = float(torch.stack([p.grad.square().sum()
                              for p in model.parameters()]).sum().sqrt())
    model.zero_grad(set_to_none=True)
    return norm


@pytest.fixture
def products(monkeypatch):
    """The plain-version products run, by name, in order, beside their
    widths (`widths`; the fp32 model's are the ELL product's)."""
    out, sizes = [], []
    for name in ("bcsr_super_spmm_reference", "ell_spmm_reference"):
        fn = getattr(bcsr_mod, name)

        def record(a, idx, x, *rest, fn=fn, name=name, **kw):
            out.append(name)
            sizes.append(x.shape[1])
            return fn(a, idx, x, *rest, **kw)
        monkeypatch.setattr(bcsr_mod, name, record)
    return out, sizes


@pytest.fixture
def widths(products):
    """The widths of the plain-version products run, in order."""
    return products[1]


# (batch_norm, cached, members); five members, the JAX package's
# DeepEnsemble default, on the fp32 model whose level 0 runs the ELL
# product: one product a member-stacked matvec at five times the widths
CASES = [(False, False, M), (True, True, M), (True, False, M),
         (False, True, M), (False, False, 5)]


@pytest.mark.parametrize("batch_norm,cached,n_members", CASES,
                         ids=[f"{'bn' if b else 'plain'}-"
                              f"{'cached' if c else 'batch'}"
                              + (f"-{n}members" if n != M else "")
                              for b, c, n in CASES])
def test_member_train_steps_match_jax(batch_norm, cached, n_members,
                                      products):
    names, widths = products
    model, jmodel, trees = build_members(batch_norm,
                                         seeds=tuple(range(n_members)))
    eps = ADAM_EPS
    indexer, jindexer = ARIndexer.build(*AR2), JARIndexer.build(*AR2)
    area_w = _area_w()
    tw = torch.from_numpy(area_w)
    w = np.linspace(1.0, 0.5, 3).astype(np.float32)
    rng = np.random.default_rng(20)
    T = 16
    data = {"dynamic": rng.standard_normal((T, V, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((T, V, F_BC)).astype(np.float32),
            "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}
    widxs = [np.array([t + indexer.rel_offsets
                       for t in rng.integers(3, 12, B)]) for _ in range(3)]
    batches = [{"dynamic": data["dynamic"][wi], "bc": data["bc"][wi],
                "static": data["static"]} for wi in widxs]

    # one member clips, the other does not: the bound between their norms
    norms = []
    for tree in trees:
        model.load_state_dict(params_from_jax(tree))
        norms.append(grad_norm(model, indexer, to_torch(batches[0]), w, tw))
    assert max(norms) > 1.5 * min(norms), norms
    clip = float(np.sqrt(norms[0] * norms[1]))

    # the port's member step
    model.load_state_dict(params_from_jax(trees[0]))
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    opt = Adam(stack.parameters(), LR, gradient_clipping=clip,
               member_axis=True, eps=eps)
    if cached:
        step = make_cached_member_train_step(stack, indexer, opt, 3,
                                             with_norm_state=batch_norm)
    else:
        step = make_member_train_step(stack, indexer, opt, 3,
                                      with_norm_state=batch_norm)
    # JAX's vmapped step
    jopt = optax.chain(optax.clip_by_global_norm(clip),
                       optax.adam(LR, eps=eps))
    jparams = stack_trees([jax.tree_util.tree_map(jnp.asarray, t)
                           for t in trees])
    jopt_state = jax.vmap(jopt.init)(jparams)
    jns = jax.tree_util.tree_map(lambda x: jnp.stack([x] * n_members),
                                 jmodel.init_norm_state())
    ctx = make_context(jmodel, jnp.asarray(area_w))
    mk = jmake_cached_member_train_step if cached else jmake_member_train_step
    jstep = mk(jmodel, jindexer, jopt, 3, with_norm_state=batch_norm)
    jdata = jax.tree_util.tree_map(jnp.asarray, data)
    losses = []
    for i in range(3):
        names.clear()
        widths.clear()
        if cached:
            total, per_iter = step(to_torch(data), torch.from_numpy(widxs[i]),
                                   w, tw)
            jargs = (jdata, jnp.asarray(widxs[i]), jnp.asarray(w), ctx)
        else:
            total, per_iter = step(to_torch(batches[i]), w, tw)
            jargs = (jax.tree_util.tree_map(jnp.asarray, batches[i]),
                     jnp.asarray(w), ctx)
        member_widths = list(widths)
        member_products = list(names)
        if batch_norm:
            jparams, jopt_state, jns, jtotal, jper = jstep(
                jparams, jopt_state, jns, *jargs)
        else:
            jparams, jopt_state, jtotal, jper = jstep(jparams, jopt_state,
                                                      *jargs)
        assert total.shape == (n_members,)
        assert per_iter.shape == (n_members, 3)
        assert rel_err(per_iter.numpy(), jper) <= TRAIN_TOL, i
        assert rel_err(total.numpy(), jtotal) <= TRAIN_TOL, i
        losses.append(per_iter.numpy())
        if i == 0:
            # the moments of the first (clipped) gradients; later ones
            # follow parameters 1e-4 apart through ReLU decisions
            assert_flat_close(optimizer_arrays(opt, stack),
                              flat_jax(jopt_state), TRAIN_TOL, n_members)
    assert_flat_close(flat_jax(params_to_jax(stack.state_dict())),
                      flat_jax(jparams), TRAIN_TOL, n_members)
    counts = {k: v for k, v in optimizer_arrays(opt, stack).items()
              if k.endswith(".count")}
    assert all(np.array_equal(v, np.full(n_members, 3))
               for v in counts.values())
    assert sorted(counts) == sorted(k for k in flat_jax(jopt_state)
                                    if k.endswith(".count"))
    if batch_norm:
        assert_flat_close(flat_jax(norm_state_to_jax(stack.norm_state())),
                          flat_jax(jns), TRAIN_TOL, n_members)

    # each member against the port's single step on it alone
    for m, tree in enumerate(trees):
        model.load_state_dict(params_from_jax(tree))
        with torch.no_grad():
            for name, buf in model.norm_state().items():
                buf.fill_(0.0 if name.endswith("mean") else 1.0)
        sopt = Adam(model.parameters(), LR, gradient_clipping=clip, eps=eps)
        sstep = make_train_step(model, indexer, sopt, 3,
                                with_norm_state=batch_norm)
        for i in range(3):
            widths.clear()
            _, sper = sstep(to_torch(batches[i]), w, tw)
            assert rel_err(losses[i][m], sper.numpy()) <= SINGLE_TOL, (m, i)
        assert_flat_close(
            {k: v.numpy() for k, v in model.state_dict().items()},
            {k: v.numpy() for k, v in member_state(
                stack.state_dict(), m).items()}, SINGLE_TOL, n_members=1)
        if batch_norm:
            assert_flat_close(
                {k: v.numpy() for k, v in model.norm_state().items()},
                {k: v.numpy() for k, v in member_state(
                    stack.norm_state(), m).items()}, SINGLE_TOL,
                n_members=1)
    # one product per member-stacked matvec, at M times the single widths,
    # on the ELL layout (the fp32 operator's)
    single_widths = list(widths)
    assert len(member_widths) == len(single_widths) > SHARED_PRODUCTS
    assert member_widths[:SHARED_PRODUCTS] == single_widths[:SHARED_PRODUCTS]
    assert member_widths[SHARED_PRODUCTS:] == [
        n_members * x for x in single_widths[SHARED_PRODUCTS:]]
    assert set(member_products) == {"ell_spmm_reference"}


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_member_validation_matches_jax(batch_norm):
    model, jmodel, trees = build_members(batch_norm, seeds=(2, 3))
    indexer, jindexer = ARIndexer.build(*AR2), JARIndexer.build(*AR2)
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    jparams = stack_trees([jax.tree_util.tree_map(jnp.asarray, t)
                           for t in trees])
    area_w = _area_w()
    ctx = make_context(jmodel, jnp.asarray(area_w))
    rng = np.random.default_rng(30)
    if batch_norm:
        # distinct running statistics per member
        with torch.no_grad():
            for name, buf in stack.norm_state().items():
                buf.copy_(torch.from_numpy(
                    (rng.uniform(0.5, 1.5, buf.shape) if name.endswith("var")
                     else 0.1 * rng.standard_normal(buf.shape)
                     ).astype(np.float32)))
        ctx = {**ctx, "norm_state": jax.tree_util.tree_map(
            jnp.asarray, norm_state_to_jax(stack.norm_state()))}
    w = np.ones(3, np.float32)
    T = 12
    data = {"dynamic": rng.standard_normal((T, V, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((T, V, F_BC)).astype(np.float32),
            "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}
    widx = np.array([t + indexer.rel_offsets for t in (3, 5, 7, 8)])
    batch = {"dynamic": data["dynamic"][widx], "bc": data["bc"][widx],
             "static": data["static"]}
    tw = torch.from_numpy(area_w)
    total, per = make_member_validation_fn(stack, indexer, 3,
                                           eval_mode=batch_norm)(
        to_torch(batch), w, tw)
    ctotal, cper = make_cached_member_validation_fn(
        stack, indexer, 3, eval_mode=batch_norm)(
        to_torch(data), torch.from_numpy(widx), w, tw)
    jtotal, jper = jmake_member_validation_fn(
        jmodel, jindexer, 3, eval_mode=batch_norm)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(w),
        ctx)
    jctotal, jcper = jmake_cached_member_validation_fn(
        jmodel, jindexer, 3, eval_mode=batch_norm)(
        jparams, jax.tree_util.tree_map(jnp.asarray, data),
        jnp.asarray(widx), jnp.asarray(w), ctx)
    assert total.shape == (M,) and per.shape == (M, 3)
    for got, ref in ((per, jper), (total, jtotal), (cper, jcper),
                     (ctotal, jctotal)):
        assert rel_err(got.numpy(), ref) <= FP32


# --- the driver and the rollout on a toy store ------------------------------

DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
AR_SETTINGS = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 1,
               "ar_iterations": 1}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("members_toy")
    jdyn, jbc, jstatic = jgenerate_toy_data(root, sampling_kwargs=SAMPLING,
                                            n_timesteps=120, seed=11)
    dyn = SphericalDataset.open(root / DYN)
    bc = SphericalDataset.open(root / BC)
    static = StaticDataset.open(root / STATIC)
    info = jget_ar_model_tensor_info(AR_SETTINGS, jdyn, data_static=jstatic,
                                     data_bc=jbc)
    return {"root": root, "jax": (jdyn, jbc, jstatic), "port": (dyn, bc,
                                                                static),
            "scaler": GlobalStandardScaler().fit_dataset(dyn),
            "jscaler": JGlobalStandardScaler().fit_dataset(jdyn),
            "info": info}


def test_member_training_driver_matches_jax(toy):
    model, jmodel, trees = build_members(False, info=toy["info"],
                                         seeds=(4, 5))
    dyn, bc, static = toy["port"]
    jdyn, jbc, jstatic = toy["jax"]
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    common = dict(**AR_SETTINGS, epochs=1, training_batch_size=8,
                  validation_batch_size=8, scoring_interval=2,
                  validation_batches=2, shuffle=True, shuffle_seed=3,
                  device_cache=True, num_workers=1, verbose=False,
                  n_members=M)
    _, _, info = AutoregressiveTraining(
        stack, training_data_dynamic=dyn.subset(0, 80),
        validation_data_dynamic=dyn.subset(80, 120),
        training_data_bc=bc.subset(0, 80), validation_data_bc=bc.subset(80, 120),
        data_static=static, scaler=toy["scaler"], learning_rate=LR,
        early_stopping=EarlyStopping(patience=100), **common)
    _, _, _, jinfo = JAutoregressiveTraining(
        jmodel, stack_trees([jax.tree_util.tree_map(jnp.asarray, t)
                             for t in trees]),
        training_data_dynamic=jdyn.subset(0, 80),
        validation_data_dynamic=jdyn.subset(80, 120),
        training_data_bc=jbc.subset(0, 80),
        validation_data_bc=jbc.subset(80, 120),
        data_static=jstatic, scaler=toy["jscaler"], learning_rate=LR,
        early_stopping=JEarlyStopping(patience=100), **common)
    assert info.iterations == jinfo.iterations and len(info.iterations) > 2
    assert np.shape(info.per_member_loss) == (len(info.iterations), M)
    assert rel_err(info.per_member_loss, jinfo.per_member_loss) <= TRAIN_TOL
    assert rel_err(info.training_total_loss,
                   jinfo.training_total_loss) <= TRAIN_TOL
    assert rel_err(info.validation_total_loss,
                   jinfo.validation_total_loss) <= TRAIN_TOL
    # the two members learned apart
    per = np.asarray(info.per_member_loss)
    assert np.abs(per[:, 0] - per[:, 1]).max() > 0


def test_member_training_refusals(toy):
    model, _, trees = build_members(True, info=toy["info"], seeds=(4, 5))
    dyn, bc, static = toy["port"]
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    kw = dict(training_data_dynamic=dyn.subset(0, 40),
              training_data_bc=bc.subset(0, 40), data_static=static,
              **AR_SETTINGS, epochs=1, training_batch_size=8,
              num_workers=1, verbose=False)
    with pytest.raises(ValueError, match="does not compose with SWAG"):
        AutoregressiveTraining(stack, n_members=M, swag=True, **kw)
    with pytest.raises(ValueError, match="matches neither the single-model"):
        AutoregressiveTraining(
            stack, n_members=M,
            initial_norm_state={k: torch.zeros(3, 5) for k in
                                stack.norm_state()}, **kw)
    with pytest.raises(TypeError, match="MemberStack"):
        AutoregressiveTraining(model, n_members=M, **kw)
    # a member mesh over which the members do not divide, as the JAX
    # NamedSharding(P("member")) refuses it (before any collective); one
    # they divide over is accepted (its place among the members)
    mesh = ProcessMesh(data_rank=0, n_data=1, node_rank=0, n_node=1,
                       data_group=None, node_group=None,
                       device=torch.device("cpu"), member_rank=1,
                       n_member=4, member_group=None)
    with pytest.raises(ValueError, match="2 members do not divide over 4"):
        AutoregressiveTraining(stack, n_members=M, mesh=mesh, **kw)
    assert member_range(8, mesh) == (2, 4)
    assert member_range(M, None) == (0, M)


@pytest.mark.parametrize("feedback", ["bc", "keep_first"])
def test_ensemble_rollout_predictions_match_jax(toy, feedback):
    if feedback == "keep_first":
        ar = {"input_k": [-2, -1], "output_k": [0, 1], "forecast_cycle": 1}
        recent = False
    else:
        ar = {k: v for k, v in AR_SETTINGS.items() if k != "ar_iterations"}
        recent = True
    info = jget_ar_model_tensor_info({**ar, "ar_iterations": 1},
                                     toy["jax"][0], data_static=toy["jax"][2],
                                     data_bc=toy["jax"][1])
    model, jmodel, trees = build_members(False, info=info, seeds=(6, 7))
    dyn, bc, static = toy["port"]
    jdyn, jbc, jstatic = toy["jax"]
    n_steps = 3
    indexer = ARIndexer.build(ar["input_k"], ar["output_k"],
                              ar["forecast_cycle"], n_steps - 1, recent)
    jindexer = JARIndexer.build(ar["input_k"], ar["output_k"],
                                ar["forecast_cycle"], n_steps - 1, recent)
    t0s = np.array([10, 14, 30])
    stacked = stack_states([params_from_jax(t) for t in trees])
    kw = dict(indexer=indexer, n_steps=n_steps, t0s=t0s, batch_size=2)
    preds = ensemble_rollout_predictions(
        model, stacked, data_dynamic=dyn, data_bc=bc, data_static=static,
        scaler=toy["scaler"], inverse_scale=False, **kw)
    # scaled space: the JAX function's inverse scaling writes into a
    # read-only view of its device output (a reference defect, ROADMAP
    # Queue 3); the port's is held to the scaler below
    jpreds = jensemble_rollout_predictions(
        jmodel, stack_trees([jax.tree_util.tree_map(jnp.asarray, t)
                             for t in trees]),
        data_dynamic=jdyn, data_bc=jbc, data_static=jstatic,
        scaler=toy["jscaler"], inverse_scale=False,
        **{**kw, "indexer": jindexer})
    n_out = len(ar["output_k"])
    assert preds.shape == (M, len(t0s), n_steps, n_out, V, F_DYN)
    assert np.isfinite(preds).all()
    assert rel_err(preds, jpreds) <= FP32
    phys = ensemble_rollout_predictions(
        model, stacked, data_dynamic=dyn, data_bc=bc, data_static=static,
        scaler=toy["scaler"], **kw)
    np.testing.assert_allclose(
        phys, toy["scaler"].inverse_transform(preds), rtol=1e-6, atol=1e-5)
    # the members differ
    assert np.abs(preds[0] - preds[1]).max() > 0
