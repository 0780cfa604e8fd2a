"""Port architectures and every shipped configuration vs the JAX package.

1. The four variant architectures against JAX at fp32 1e-5, forward and
   gradients (one-element gradients against the sum of their terms'
   magnitudes, `torch_grad_terms`), at HEALPix-4, ConvNetSpherical with
   `conv_type='image'` on the equiangular 8x16 grid.
2. `get_model` knows the JAX package's architectures, and the weight
   bridge carries the learned pools' logits and every variant's tree
   exactly, both ways.
3. Every one of the shipped configs under configs/ read, validated and
   built by the port's `get_model` at a tiny stand-in of its own sampling
   family, with its pool method and graph type, level 0 block-sparse
   (voronoi with its transposed layout), and one forward finite and of
   the right shape.
4. `shard_geometry` shards geometries whose pools cross node shards (each
   rank's node ranges, its pools gathering their input over the node
   group and keeping its rows: the same rows as the whole pool's) and
   keeps nested HEALPix with the hierarchical pools local.

The grids400 models against JAX are `tests/test_torch_grids400.py`, whose
stand-in grids and helpers this file shares."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402

from deepsphere_weather_torch.config import (  # noqa: E402
    get_ar_settings,
    get_model_settings,
    get_training_settings,
    read_config_file,
)
from deepsphere_weather_torch.models import (  # noqa: E402
    ARCHITECTURES,
    get_model,
    shard_geometry,
)
from deepsphere_weather_torch.ops.pool import ShardedPool, ShardedUnpool  # noqa: E402
from deepsphere_weather_torch.parallel import NodeShard  # noqa: E402
from deepsphere_weather_torch.parallel.mesh import ProcessMesh  # noqa: E402
from deepsphere_weather_torch.sphere import (  # noqa: E402
    build_sampling,
    coarsen_sampling_kwargs,
)
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)
from test_torch_grids400 import (  # noqa: E402
    B,
    F_DYN,
    F_IN,
    INPUT_K,
    KNN,
    STAND_IN,
    TOL,
    assert_trees_close,
    grads_tree,
    rel_err,
    seeded_tree,
    tensor_info,
)
from torch_grad_terms import term_sums  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").rglob("*.json"))


VARIANTS = [("ResNetSpherical", "healpix4", "graph"),
            ("EPDNetSpherical", "healpix4", "graph"),
            ("ConvNetSpherical", "equiangular8x16", "image"),
            ("DownscalingNetSpherical", "healpix4", "graph")]
VARIANT_GRIDS = {"healpix4": STAND_IN["Healpix_400km"],
                 "equiangular8x16": STAND_IN["Equiangular_400km"]}


@pytest.mark.parametrize("arch,grid,conv_type", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_variant_matches_jax(arch, grid, conv_type):
    name, kw = VARIANT_GRIDS[grid]
    samp = build_sampling(name, kw)
    n_in = samp.n_nodes // 4 if arch == "DownscalingNetSpherical" else None
    info = tensor_info(samp.n_nodes, n_in)
    common = dict(sampling=name, sampling_kwargs=kw, knn=KNN,
                  conv_type=conv_type, pool_method="max",
                  increment_learning=True)
    model = get_model(arch, info, device="cpu", **common)
    jmodel = jget_model(arch, info, **common)
    assert type(model).__name__ == arch
    assert model.geometry.conv_type == conv_type
    if conv_type == "image":
        assert all(op is None for op in model.geometry.cheb_ops)
        assert model.geometry.lonlat_ratio == 2.0
    tree = seeded_tree(model, 3)
    jinit = jmodel.init(jax.random.key(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), jinit)
            == jax.tree_util.tree_map(lambda a: a.shape, tree))
    model.load_state_dict(params_from_jax(tree))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, len(INPUT_K), info["input_shape_info"][
        "dynamic"]["node"], F_IN)).astype(np.float32)
    g = rng.standard_normal((B, 1, samp.n_nodes, F_DYN)).astype(np.float32)
    sums = term_sums(model)
    y = model(torch.from_numpy(x))
    (y * torch.from_numpy(g)).sum().backward()
    jout = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(
        lambda p: (jmodel.apply(p, jnp.asarray(x)) * g).sum()))(jparams)
    assert rel_err(y.detach().numpy(), np.asarray(jout)) <= TOL["fp32"]
    assert_trees_close(grads_tree(model), jgrads, TOL["fp32"], sums=sums)


ROUND_TRIP = [("UNetSpherical", "Icosahedral_400km", "learn", "graph"),
              ("UNetSpherical", "Equiangular_400km", "max", "image"),
              ("ResNetSpherical", "Healpix_400km", "max", "graph"),
              ("EPDNetSpherical", "Cubed_400km", "max", "graph"),
              ("ConvNetSpherical", "Equiangular_400km", "max", "image"),
              ("DownscalingNetSpherical", "O24", "max", "graph")]


@pytest.mark.parametrize("arch,sampling_dir,pool,conv_type", ROUND_TRIP,
                         ids=[f"{a}-{s}-{p}-{c}" for a, s, p, c in ROUND_TRIP])
def test_weights_round_trip_jax_tree(arch, sampling_dir, pool, conv_type):
    """The JAX init tree (learned pool logits `pool{lvl}`/`unpool{lvl}`
    and every variant's blocks) -> `params_from_jax` -> the port's module
    -> `params_to_jax`: the same keys, shapes and values, exactly."""
    name, kw = STAND_IN[sampling_dir]
    n = build_sampling(name, kw).n_nodes
    coarse = build_sampling(name, coarsen_sampling_kwargs(name, kw, 2))
    n_in = coarse.n_nodes if arch == "DownscalingNetSpherical" else None
    info = tensor_info(n, n_in)
    common = dict(sampling=name, sampling_kwargs=kw, knn=KNN,
                  pool_method=pool, conv_type=conv_type)
    model = get_model(arch, info, device="cpu", **common)
    jtree = jax.tree_util.tree_map(
        np.asarray, jget_model(arch, info, **common).init(jax.random.key(4)))
    model.load_state_dict(params_from_jax(jtree))
    back = params_to_jax(model.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert flat.keys() == jflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=str(k))
    if pool == "learn":
        assert {"pool0", "unpool0", "pool1", "unpool1"} <= set(back)
        # the logits are the pools' own initial values on both stacks
        np.testing.assert_array_equal(
            back["pool0"], model.geometry.pools[0].init_logits.numpy())


def test_get_model_knows_every_jax_architecture():
    from deepsphere_weather_tpu.models import ARCHITECTURES as JARCH

    assert sorted(ARCHITECTURES) == sorted(JARCH)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_model("TransformerSpherical", tensor_info(192))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[str(p.relative_to(REPO / "configs"))
                              for p in CONFIGS])
def test_shipped_config_builds(path):
    cfg = read_config_file(path)
    ms = get_model_settings(cfg)
    ts = get_training_settings(cfg)
    get_ar_settings(cfg)
    shipped = build_sampling(ms["sampling"], dict(ms["sampling_kwargs"]))
    assert shipped.n_nodes > 2000
    name, kw = STAND_IN[ms["sampling_name"]]
    assert name == ms["sampling"]
    n = build_sampling(name, kw).n_nodes
    kwargs = {k: v for k, v in ms.items() if k != "architecture_name"}
    kwargs.update(sampling_kwargs=kw, knn=KNN,
                  pool_method=str(ms["pool_method"]).lower(),
                  numeric_precision=ts["numeric_precision"])
    model = get_model(ms["architecture_name"], tensor_info(n, f_in=7),
                      device="cpu", dense_threshold=n - 1, **kwargs)
    geom = model.geometry
    assert geom.samplings[0].cache_key() == build_sampling(name, kw).cache_key()
    op = geom.cheb_ops[0].bcsr
    assert (op.svals_t is not None) == (ms["graph_type"] == "voronoi")
    pool = kwargs["pool_method"]
    want = {"max": "MaxPool", "avg": "AvgPool", "interp": "GeneralAvgPool",
            "maxarea": "GeneralMaxAreaPool", "maxval": "GeneralMaxValPool",
            "learn": "GeneralLearnPool"}[pool]
    assert type(geom.pools[0]).__name__.endswith(want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, n, 7)).astype(np.float32))
    with torch.no_grad():
        y = model(x)
    assert y.shape == (1, 1, n, 2) and torch.isfinite(y).all()


def test_every_sampling_pool_and_graph_type_is_shipped():
    seen = set()
    for path in CONFIGS:
        ms = json.loads(path.read_text())["model_settings"]
        seen.add((ms["sampling"], ms["pool_method"].lower(), ms["graph_type"]))
    assert len(CONFIGS) == 108
    assert {s for s, _, _ in seen} == {"healpix", "equiangular",
                                       "icosahedral", "cubed", "gauss"}
    assert {p for _, p, _ in seen} == {"max", "avg", "interp", "maxarea",
                                       "maxval", "learn"}
    assert {g for _, _, g in seen} == {"knn", "voronoi", "mesh"}


def _mesh(node_rank=0):
    """A 1 x 2 node mesh as rank `node_rank` sees it; no collective runs
    here, so its groups are placeholders."""
    return ProcessMesh(data_rank=0, n_data=1, node_rank=node_rank, n_node=2,
                       data_group=object(), node_group=object(),
                       device=torch.device("cpu"))


@pytest.mark.parametrize("sampling_dir,pool,conv_type", [
    ("Healpix_400km", "interp", "graph"), ("Healpix_400km", "learn", "graph"),
    ("Equiangular_400km", "max", "graph"), ("Equiangular_400km", "avg",
                                            "image"),
    ("O24", "maxval", "graph"), ("Cubed_400km", "maxarea", "graph")])
def test_shard_geometry_refuses_non_nested_geometry(sampling_dir, pool,
                                                   conv_type, monkeypatch):
    # (named for what it checked before the remap and equiangular pools
    # gathered over the node group: it now checks that they shard)
    name, kw = STAND_IN[sampling_dir]
    n = build_sampling(name, kw).n_nodes
    model = get_model("UNetSpherical", tensor_info(n), sampling=name,
                      sampling_kwargs=kw, knn=KNN, pool_method=pool,
                      conv_type=conv_type, device="cpu")
    geom = model.geometry
    # one node shard (or none) needs no sharding and keeps the geometry
    assert shard_geometry(geom, None) is geom
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((2, v, 4)).astype(np.float32))
          for v in geom.n_nodes]
    # the gather of every rank's rows, here the whole input it was cut from
    whole = {}
    monkeypatch.setattr(NodeShard, "gather",
                        lambda self, x: whole[(self.v0, self.v1)])
    for r in range(2):
        shard = shard_geometry(geom, _mesh(r))
        assert shard.node_ranges == [(r * v // 2, (r + 1) * v // 2)
                                     for v in geom.n_nodes]
        assert shard.n_nodes == [v // 2 for v in geom.n_nodes]
        for lvl, (p, u) in enumerate(zip(shard.pools, shard.unpools)):
            assert isinstance(p, ShardedPool) and isinstance(u, ShardedUnpool)
            (a0, a1), (b0, b1) = shard.node_ranges[lvl:lvl + 2]
            fine, coarse = xs[lvl], xs[lvl + 1]
            whole[(a0, a1)], whole[(b0, b1)] = fine, coarse
            y, idx = p(fine[:, a0:a1])
            want, want_idx = geom.pools[lvl](fine)
            assert torch.equal(y, want[:, b0:b1])
            assert (idx is None) == (want_idx is None)
            assert torch.equal(u(coarse[:, b0:b1], want_idx),
                               geom.unpools[lvl](coarse, want_idx)[:, a0:a1])
        if conv_type == "image":
            assert all(isinstance(op, NodeShard) for op in shard.cheb_ops)
        else:
            assert all(op.group is not None or op.bcsr.group is not None
                       for op in shard.cheb_ops)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_shard_geometry_keeps_hierarchical_healpix(pool):
    name, kw = STAND_IN["Healpix_400km"]
    model = get_model("UNetSpherical", tensor_info(192), sampling=name,
                      sampling_kwargs=kw, knn=KNN, pool_method=pool,
                      device="cpu")
    shard = shard_geometry(model.geometry, _mesh())
    assert shard.node_ranges == [(0, 96), (0, 24), (0, 6)]
    assert shard.pools is model.geometry.pools

