"""K5: the vmap rule of the registered SpMM op vs the JAX package.

`torch.func.vmap` of `BlockSparseOperator.matvec` over a member axis, on
the super-row and the plain layout, symmetric (knn L) and not (D L):

- equals the per-member loop exactly (the product is linear per column,
  so folding the members into the columns changes no sum);
- equals `jax.vmap` of the JAX interpret-mode operator (whose
  `custom_vmap` rule folds the same way) within 1e-5 in fp32 and 2e-2 in
  bf16 (max abs error / max abs);
- runs ONE product per vmapped matvec, at width K * m (the plain version
  is recorded: on a CPU tensor the op runs it in the kernel's place);
- `vmap(grad)` equals the per-member gradients within 1e-5, with one
  product forward and one backward;
- a batched operator array raises NotImplementedError with the JAX
  message.
"""

import jax
import numpy as np
import pytest
from scipy import sparse

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)

from deepsphere_weather_torch.ops import BlockSparseOperator  # noqa: E402
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402

KNN, K_MEMBERS, M = 8, 3, 40
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 2e-2}
LAYOUTS = {"super": 2, "plain": 0}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def mats():
    L = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN).L
    L = L.tocsr().astype(np.float32)
    d = np.random.default_rng(0).uniform(0.5, 2.0, L.shape[0])
    return {"sym": L,
            "nonsym": (sparse.diags(d.astype(np.float32)) @ L).tocsr()}


def _op(mats, sym, layout, dt="fp32"):
    """The operator on the block layout `layout` alone: an fp32 one's ELL
    (its route for fp32 x) is taken away, so that every case runs the
    block layout's rule (the ELL route's is held in test_torch_ell.py)."""
    op = BlockSparseOperator.from_scipy(
        mats[sym], symmetric=sym == "sym", dtype=TORCH_DT[dt],
        rows_per_super=LAYOUTS[layout], device="cpu")
    op.ell = None
    return op


def _x(n, dt="fp32", seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (K_MEMBERS, n, M)).astype(np.float32)
    return x, torch.from_numpy(x).to(TORCH_DT[dt])


@pytest.fixture
def products(monkeypatch):
    """The widths of the plain-version products run, in order."""
    widths = []
    for name in ("bcsr_super_spmm_reference", "bcsr_spmm_reference"):
        fn = getattr(bcsr_mod, name)

        def record(a, idx, x, nz=None, *rest, fn=fn):
            widths.append(x.shape[1])
            return fn(a, idx, x, nz, *rest)
        monkeypatch.setattr(bcsr_mod, name, record)
    return widths


@pytest.mark.parametrize("sym", ["sym", "nonsym"])
@pytest.mark.parametrize("layout", ["super", "plain"])
def test_vmap_equals_member_loop_with_one_product(mats, products, sym,
                                                  layout):
    op = _op(mats, sym, layout)
    _, xt = _x(mats[sym].shape[0])
    with torch.no_grad():
        y = torch.func.vmap(op.matvec)(xt)
        assert products == [K_MEMBERS * 128]    # each member pads 40 -> 128
        loop = torch.stack([op.matvec(x) for x in xt])
    assert y.shape == (K_MEMBERS, mats[sym].shape[0], M)
    assert torch.equal(y, loop)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("sym", ["sym", "nonsym"])
@pytest.mark.parametrize("layout", ["super", "plain"])
def test_vmap_matches_jax_vmap(mats, sym, layout, dt):
    op = _op(mats, sym, layout, dt)
    x, xt = _x(mats[sym].shape[0], dt, seed=2)
    with torch.no_grad():
        y = torch.func.vmap(op.matvec)(xt)
    jop = JBlockSparseOperator.from_scipy(
        mats[sym], symmetric=sym == "sym", interpret=True,
        dtype=JAX_DT[dt], rows_per_super=LAYOUTS[layout])
    yj = jax.vmap(jop.matvec)(jnp.asarray(x, JAX_DT[dt]))
    assert y.dtype == TORCH_DT[dt]
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL[dt]


@pytest.mark.parametrize("sym", ["sym", "nonsym"])
@pytest.mark.parametrize("layout", ["super", "plain"])
def test_vmap_of_grad_equals_member_grads(mats, products, sym, layout):
    op = _op(mats, sym, layout)
    x, xt = _x(mats[sym].shape[0], seed=3)

    def loss(xi):
        return (op.matvec(xi) ** 2).sum()

    g = torch.func.vmap(torch.func.grad(loss))(xt)
    assert products == [K_MEMBERS * 128] * 2   # forward, backward
    loop = torch.stack([torch.func.grad(loss)(xi) for xi in xt])
    assert rel_err(g.numpy(), loop.numpy()) <= 1e-5
    L = mats[sym]
    want = np.stack([2.0 * (L.T @ (L @ xi)) for xi in x])
    assert rel_err(g.numpy(), want) <= 1e-5


def test_batched_operator_raises(mats):
    op = _op(mats, "sym", "super")
    a = torch.stack([op.svals, op.svals])
    x = torch.zeros(2, op.rows, 128)
    with pytest.raises(NotImplementedError, match="vmap over "
                       "BlockSparseOperator arrays themselves"):
        torch.func.vmap(lambda ai, xi: bcsr_mod.spmm(
            ai, op.ucols, xi, op.nz, True))(a, x)
