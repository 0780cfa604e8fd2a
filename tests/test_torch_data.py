"""Port data stack vs the JAX package: the toy generator, the zarr store,
the AR loaders, the tensor info, the scalers and the device-resident
dataset.

Everything here is exact (numpy on both sides, the same code paths): the
toy arrays and the loaders' batches are compared bit for bit, a store
written by one package is read back by the other byte for byte, and the
chunk files two writers produce are the same bytes. HEALPix-4 (192 nodes),
short periods, a few batches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepsphere_weather_tpu.data import (  # noqa: E402
    AutoregressiveDataLoader as JLoader,
    AutoregressiveDataset as JARDataset,
    GlobalMinMaxScaler as JGlobalMinMaxScaler,
    GlobalStandardScaler as JGlobalStandardScaler,
    SequentialScaler as JSequentialScaler,
    SphericalDataset as JSphericalDataset,
    StaticDataset as JStaticDataset,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
    load_scaler as jload_scaler,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.data.scalers import AnomalyScaler as JAnomalyScaler  # noqa: E402
from deepsphere_weather_tpu.data.zarrstore import (  # noqa: E402
    ZarrArray as JZarrArray,
    create_group as jcreate_group,
    open_group as jopen_group,
)
from deepsphere_weather_tpu.data.toy import (  # noqa: E402
    perturbation_basis as jperturbation_basis,
)
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402

from deepsphere_weather_torch.data import (  # noqa: E402
    ARIndexer,
    AutoregressiveDataLoader,
    AutoregressiveDataset,
    GlobalMinMaxScaler,
    GlobalStandardScaler,
    SequentialScaler,
    SphericalDataset,
    StaticDataset,
    generate_toy_data,
    get_ar_model_tensor_info,
    load_scaler,
)
from deepsphere_weather_torch.data.toy import perturbation_basis  # noqa: E402
from deepsphere_weather_torch.data.zarrstore import (  # noqa: E402
    ZarrArray,
    create_group,
    open_group,
)
from deepsphere_weather_torch.native import bloscio  # noqa: E402
from deepsphere_weather_torch.parallel import (  # noqa: E402
    ProcessMesh,
    put_device_dataset,
    shard_window_indices,
)
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402

SAMPLING = {"subdivisions": 4, "nest": True}
N_TIME, SEED = 120, 4
AR = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 2,
      "ar_iterations": 2}
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
COMPRESSORS = [None, "zlib", pytest.param(
    "blosc:lz4", marks=pytest.mark.skipif(not bloscio.available(),
                                          reason="libblosc not installed"))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU work in this module: the
    suite's workers share the cores, and OpenMP teams oversubscribed
    across them slowed these small-shape runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy data of both generators from one seed, each opened by its
    own package."""
    root = tmp_path_factory.mktemp("toy_data")
    generate_toy_data(root / "port", sampling_kwargs=SAMPLING,
                      n_timesteps=N_TIME, seed=SEED)
    jgenerate_toy_data(root / "jax", sampling_kwargs=SAMPLING,
                       n_timesteps=N_TIME, seed=SEED)
    return {
        "root": root,
        "port": (SphericalDataset.open(root / "port" / DYN),
                 SphericalDataset.open(root / "port" / BC),
                 StaticDataset.open(root / "port" / STATIC)),
        "jax": (JSphericalDataset.open(root / "jax" / DYN),
                JSphericalDataset.open(root / "jax" / BC),
                JStaticDataset.open(root / "jax" / STATIC)),
    }


def _tree_files(path):
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("store", [DYN, BC, STATIC])
def test_toy_stores_are_the_same_bytes(toy, store):
    # the same seed writes the same store: every array, every chunk file
    # and every metadata file, byte for byte
    port, jax_ = toy["root"] / "port" / store, toy["root"] / "jax" / store
    files = _tree_files(port)
    assert files and files == _tree_files(jax_)


def test_toy_arrays_equal(toy):
    (dyn, bc, st), (jdyn, jbc, jst) = toy["port"], toy["jax"]
    np.testing.assert_array_equal(dyn.read_all(), jdyn.read_all())
    np.testing.assert_array_equal(bc.read_all(), jbc.read_all())
    np.testing.assert_array_equal(st.read_stacked(), jst.read_stacked())
    np.testing.assert_array_equal(dyn.time, jdyn.time)
    np.testing.assert_array_equal(dyn.lat, jdyn.lat)
    assert dyn.feature_order == jdyn.feature_order == ["t850", "z500"]


def test_perturbation_basis_equal():
    got = perturbation_basis(build_sampling("healpix", SAMPLING), seed=3)
    want = jperturbation_basis(jbuild_sampling("healpix", SAMPLING), seed=3)
    np.testing.assert_array_equal(got, want)


def _write(create, path, data, compressor):
    g = create(path, attrs={"feature_order": ["a"], "note": "x"},
               overwrite=True)
    arr = g.create_array("a", shape=data.shape, chunks=(7, 64),
                         dtype=data.dtype, compressor=compressor,
                         attrs={"units": "K"})
    arr[...] = data
    arr.append(data[:5])            # zarr append along time
    arr[3:9, 10:100] = -data[:6, :90]
    return g


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_store_round_trips_between_packages(tmp_path, compressor):
    data = np.random.default_rng(0).standard_normal((30, 192)).astype(
        np.float32)
    want = np.concatenate([data, data[:5]])
    want[3:9, 10:100] = -data[:6, :90]
    _write(create_group, tmp_path / "port.zarr", data, compressor)
    _write(jcreate_group, tmp_path / "jax.zarr", data, compressor)
    # each package reads the other's store, values and attributes
    for reader, path in ((open_group, tmp_path / "jax.zarr"),
                         (jopen_group, tmp_path / "port.zarr"),
                         (open_group, tmp_path / "port.zarr")):
        g = reader(path)
        assert g.attrs == {"feature_order": ["a"], "note": "x"}
        assert g.array_names() == ["a"]
        a = g["a"]
        assert a.attrs == {"units": "K"} and a.shape == want.shape
        np.testing.assert_array_equal(a[...], want)
        np.testing.assert_array_equal(a[12:20, 5], want[12:20, 5])
    # both writers produce the same files
    assert _tree_files(tmp_path / "port.zarr") == \
        _tree_files(tmp_path / "jax.zarr")


def test_store_arrays_read_in_either_package(tmp_path):
    # single arrays (no group) with a fill value and an unwritten chunk
    a = ZarrArray.create(tmp_path / "p", shape=(10, 8), chunks=(4, 8),
                         dtype=np.int64, compressor="zlib", fill_value=-1)
    a[0:4] = np.arange(32).reshape(4, 8)
    j = JZarrArray(tmp_path / "p")
    np.testing.assert_array_equal(j[...], a[...])
    assert (j[4:] == -1).all()


def _datasets(toy, side, preload):
    dyn, bc, st = toy[side]
    if side == "port":
        indexer, ds_cls, sc_cls = ARIndexer, AutoregressiveDataset, \
            GlobalStandardScaler
    else:
        indexer, ds_cls, sc_cls = JARIndexer, JARDataset, JGlobalStandardScaler
    idx = indexer.build(AR["input_k"], AR["output_k"], AR["forecast_cycle"],
                        AR["ar_iterations"])
    return ds_cls(dyn.subset(10, 110), idx, data_bc=bc.subset(10, 110),
                  data_static=st, scaler=sc_cls().fit_dataset(dyn),
                  scaler_bc=sc_cls().fit_dataset(bc), preload=preload)


@pytest.mark.parametrize("preload", ["auto", False], ids=["mirror", "reads"])
def test_loaders_give_the_same_batches(toy, preload):
    """Two epochs of each loader (thread pool, prefetch, seeded shuffle,
    the AR depth grown between them): the same batch order and bytes."""
    ds, jds = _datasets(toy, "port", preload), _datasets(toy, "jax", preload)
    assert ds.has_mirror == jds.has_mirror == (preload == "auto")
    for epoch, n_ar in ((0, 1), (1, 2)):
        ds.update_AR_iterations(n_ar)
        jds.update_AR_iterations(n_ar)
        kw = dict(batch_size=4, shuffle=True, shuffle_seed=17,
                  num_workers=3, prefetch_factor=2, epoch=epoch)
        got = list(AutoregressiveDataLoader(ds, **kw))
        want = list(JLoader(jds, **kw))
        assert len(got) == len(want) == len(ds) // 4
        for b, jb in zip(got, want):
            assert sorted(b) == sorted(jb)
            for k in jb:
                assert b[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(b[k], jb[k])
        got = list(AutoregressiveDataLoader(ds, **kw).iter_index_batches())
        want = list(JLoader(jds, **kw).iter_index_batches())
        for b, jb in zip(got, want):
            np.testing.assert_array_equal(b, jb)
            np.testing.assert_array_equal(ds.window_indices(b),
                                          jds.window_indices(jb))


def test_loader_transfer_runs_in_the_pool(toy):
    ds = _datasets(toy, "port", "auto")
    seen = []

    def transfer(b):
        seen.append(1)
        return {k: torch.as_tensor(v) for k, v in b.items()
                if k in ("dynamic", "bc", "static")}

    batches = list(AutoregressiveDataLoader(ds, batch_size=8, num_workers=2,
                                            transfer=transfer))
    assert len(seen) == len(batches) and all(
        isinstance(b["dynamic"], torch.Tensor) for b in batches)


def test_tensor_info_equal(toy):
    (dyn, bc, st), (jdyn, jbc, jst) = toy["port"], toy["jax"]
    assert get_ar_model_tensor_info(AR, dyn, data_static=st, data_bc=bc) == \
        jget_ar_model_tensor_info(AR, jdyn, data_static=jst, data_bc=jbc)
    assert get_ar_model_tensor_info(AR, dyn) == \
        jget_ar_model_tensor_info(AR, jdyn)


def _scalers(toy):
    (dyn, _, _), (jdyn, _, _) = toy["port"], toy["jax"]
    return [
        (GlobalStandardScaler().fit_dataset(dyn),
         JGlobalStandardScaler().fit_dataset(jdyn)),
        (GlobalMinMaxScaler().fit_dataset(dyn),
         JGlobalMinMaxScaler().fit_dataset(jdyn)),
        (SequentialScaler(GlobalStandardScaler().fit_dataset(dyn),
                          GlobalMinMaxScaler().fit_dataset(dyn)),
         JSequentialScaler(JGlobalStandardScaler().fit_dataset(jdyn),
                           JGlobalMinMaxScaler().fit_dataset(jdyn))),
    ]


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["standard", "minmax", "sequential"])
def test_scaler_files_cross_load(toy, tmp_path, which):
    scaler, jscaler = _scalers(toy)[which]
    x = toy["port"][0].read_stacked(np.arange(5))
    np.testing.assert_array_equal(scaler.transform(x), jscaler.transform(x))
    name = "s" if which == 2 else "s.npz"      # a sequential is a directory
    scaler.save(tmp_path / f"port_{name}")
    jscaler.save(tmp_path / f"jax_{name}")
    for loaded in (load_scaler(tmp_path / f"jax_{name}"),
                   jload_scaler(tmp_path / f"port_{name}")):
        np.testing.assert_array_equal(loaded.transform(x),
                                      jscaler.transform(x))
        np.testing.assert_array_equal(
            loaded.inverse_transform(loaded.transform(x)),
            jscaler.inverse_transform(jscaler.transform(x)))
    assert type(load_scaler(tmp_path / f"jax_{name}")) is type(scaler)


def test_time_grouped_scaler_files_are_refused(toy, tmp_path):
    jdyn = toy["jax"][0]
    JAnomalyScaler(time_groups="month").fit(
        jdyn.read_all(), jdyn.time).save(tmp_path / "anom.npz")
    with pytest.raises(NotImplementedError, match="item 4"):
        load_scaler(tmp_path / "anom.npz")


def test_device_dataset_and_window_indices(toy):
    ds = _datasets(toy, "port", "auto")
    dyn, bc, st = ds.mirror_arrays()
    data = put_device_dataset(ds, device="cpu")
    np.testing.assert_array_equal(data["dynamic"].numpy(), dyn)
    np.testing.assert_array_equal(data["bc"].numpy(), bc)
    np.testing.assert_array_equal(data["static"].numpy(), st)
    idx = np.array([3, 0, 7, 5])
    widx = shard_window_indices(ds.window_indices(idx), device="cpu")
    assert widx.dtype == torch.int64
    np.testing.assert_array_equal(widx.numpy(), ds.window_indices(idx))
    # rank (data 1, node 1) of a 2 x 2 mesh: the second node half of every
    # timestep, and the second half of the batch rows
    mesh = ProcessMesh(data_rank=1, n_data=2, node_rank=1, n_node=2,
                       data_group=None, node_group=None,
                       device=torch.device("cpu"))
    part = put_device_dataset(ds, mesh)
    np.testing.assert_array_equal(part["dynamic"].numpy(), dyn[:, 96:])
    np.testing.assert_array_equal(part["bc"].numpy(), bc[:, 96:])
    np.testing.assert_array_equal(part["static"].numpy(), st[96:])
    np.testing.assert_array_equal(
        shard_window_indices(ds.window_indices(idx), mesh).numpy(),
        ds.window_indices(idx)[2:])
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            put_device_dataset(ds)
