"""The SpMM kernels' lists of nonzero slots (`super_nonzero_slots` and
`plain_nonzero_slots`, the `nz` of `BlockSparseOperator` and its shards, in
the super-row and the plain layout) against the JAX package's nonzero
blocks, and the plain versions that take them.

A zero block adds an exact zero, so a product over the listed slots must
equal the product over every slot bit for bit, and a list that drops a
nonzero block must not. HEALPix-4 and -8 with k 8, and HEALPix-16 with the
flagship's knn-20; the same scipy matrix goes to both packages. The JAX
side runs its Pallas operator in interpret mode on the CPU, as its own
tests do; tolerances are those of `tests/test_torch_ops.py` (max abs error
/ max abs: fp32 1e-5, bf16 1e-2)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from scipy import sparse  # noqa: E402

from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
    _nonzero_block_mask,
    bcsr_from_scipy as jbcsr_from_scipy,
)

from deepsphere_weather_torch.models.geometry import cached_graph_laplacian  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    bcsr_spmm,
    bcsr_spmm_reference,
    bcsr_spmm_rows,
    bcsr_spmm_rows_reference,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    bcsr_super_spmm_rows,
    bcsr_super_spmm_rows_reference,
    plain_nonzero_slots,
    super_nonzero_slots,
)
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402

TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
MV_TOL = {"fp32": 1e-5, "bf16": 1e-2}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["hp4", "hp8", "hp16"])
def lap(request):
    if request.param == "hp16":
        return cached_graph_laplacian(
            "healpix", {"subdivisions": 16, "nest": True}, 20, "knn")[1]
    subdiv = int(request.param[2:])
    return build_graph("healpix", {"subdivisions": subdiv, "nest": True},
                       k=8).L.tocsr()


def _x(rows, width, dt, seed):
    x = np.random.default_rng(seed).standard_normal((rows, width))
    return torch.from_numpy(x.astype(np.float32)).to(TORCH_DT[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_slot_counts_match_jax_nonzero_blocks(lap, dt):
    # each nonzero block of the plain BCSR is one nonzero union slot of
    # its row block; padding row blocks list none
    jcounts = _nonzero_block_mask(jbcsr_from_scipy(lap)[0]).sum(1)
    op = BlockSparseOperator.from_scipy(lap, dtype=TORCH_DT[dt], device="cpu")
    counts = op.nz[..., 0].reshape(-1).numpy()
    n_rb = jcounts.shape[0]
    np.testing.assert_array_equal(counts[:n_rb], jcounts)
    assert not counts[n_rb:].any()
    # the listed slots are exactly the nonzero blocks, in increasing order
    n_s, R, bs, ubs = op.svals.shape
    blocks = op.svals.float().view(n_s, R, bs, ubs // bs, bs)
    nonzero = blocks.abs().sum(dim=(2, 4)) > 0
    for s in range(n_s):
        for r in range(R):
            c = int(op.nz[s, r, 0])
            listed = op.nz[s, r, 1:1 + c].tolist()
            assert listed == sorted(listed)
            assert listed == torch.nonzero(nonzero[s, r]).flatten().tolist()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_plain_versions_with_list_equal_without(lap, dt):
    op = BlockSparseOperator.from_scipy(lap, dtype=TORCH_DT[dt], device="cpu")
    x = _x(op.rows, 64, dt, 1)
    a, idx, nz = op.svals, op.ucols, op.nz
    assert torch.equal(bcsr_super_spmm_reference(a, idx, x, nz),
                       bcsr_super_spmm_reference(a, idx, x))
    n_s = a.shape[0]
    for s0, s1 in ((0, n_s), (0, 1), (n_s - 1, n_s)):
        assert torch.equal(bcsr_super_spmm_rows_reference(a, idx, x, s0, s1, nz),
                           bcsr_super_spmm_rows_reference(a, idx, x, s0, s1))
    # the CPU wrappers run the plain versions with the list they are given
    assert torch.equal(bcsr_super_spmm(a, idx, x, nz),
                       bcsr_super_spmm_reference(a, idx, x))


def test_wrong_list_changes_the_result(lap):
    op = BlockSparseOperator.from_scipy(lap, device="cpu")
    x = _x(op.rows, 64, "fp32", 2)
    right = bcsr_super_spmm_reference(op.svals, op.ucols, x, op.nz)
    # drop the first listed slot of the last row block that lists one
    g = int(torch.nonzero(op.nz[..., 0].reshape(-1)).max())
    s, r = divmod(g, op.svals.shape[1])
    wrong = op.nz.clone()
    c = int(wrong[s, r, 0])
    wrong[s, r, 1:c] = op.nz[s, r, 2:c + 1]
    wrong[s, r, 0] = c - 1
    y = bcsr_super_spmm_reference(op.svals, op.ucols, x, wrong)
    rows = slice(g * 128, (g + 1) * 128)
    assert not torch.equal(y[rows], right[rows])
    keep = torch.ones(y.shape[0], dtype=torch.bool)
    keep[rows] = False
    assert torch.equal(y[keep], right[keep])


def test_row_block_without_slots_gives_zeros():
    # R = 4 at HEALPix-4: one super-row of 4 row blocks, the last 2 padding
    L = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8).L
    op = BlockSparseOperator.from_scipy(L, rows_per_super=4, device="cpu")
    assert op.nz[0, :, 0].tolist()[2:] == [0, 0]
    x = _x(op.rows, 64, "fp32", 3)
    y = bcsr_super_spmm_reference(op.svals, op.ucols, x, op.nz)
    assert not y[256:].any()
    assert torch.equal(y, bcsr_super_spmm_reference(op.svals, op.ucols, x))


def test_bad_list_is_refused(lap):
    op = BlockSparseOperator.from_scipy(lap, device="cpu")
    x = _x(op.rows, 64, "fp32", 4)
    for bad in (op.nz.long(), op.nz[:, :, :-1], torch.cat([op.nz, op.nz])):
        with pytest.raises(ValueError, match="slot list"):
            bcsr_super_spmm(op.svals, op.ucols, x, bad)
        with pytest.raises(ValueError, match="slot list"):
            bcsr_super_spmm_rows(op.svals, op.ucols, x, 0, 1, bad)


def _nonsymmetric(L):
    d = np.random.default_rng(0).uniform(0.5, 2.0, L.shape[0])
    return (sparse.diags(d.astype(np.float32)) @ L).tocsr().astype(np.float32)


@pytest.mark.parametrize("n_node", [2, 4])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_row_shard_slices_the_list_with_the_tables(lap, n_node, symmetric):
    mat = lap if symmetric else _nonsymmetric(lap)
    op = BlockSparseOperator.from_scipy(mat, symmetric=symmetric, device="cpu")
    assert (op.nz_t is None) == symmetric
    n = mat.shape[0]
    for rank in range(n_node):
        v0, v1 = rank * n // n_node, (rank + 1) * n // n_node
        shard = op.row_shard(v0, v1, group=None)
        for full, part in ((op.forward_layout(), shard.forward_layout()),
                           (op.transpose_layout(), shard.transpose_layout())):
            _, a, idx, nz = full
            kind, a_s, idx_s, nz_s, r0, _ = part
            lo = r0 // (128 * a.shape[1])
            hi = lo + a_s.shape[0]
            assert kind == "super"
            assert torch.equal(a_s, a[lo:hi]) and torch.equal(idx_s, idx[lo:hi])
            assert torch.equal(nz_s, nz[lo:hi])
            assert torch.equal(nz_s, super_nonzero_slots(a_s))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("subdiv", [4, 8])
def test_matvec_matches_jax_interpret(subdiv, symmetric, dt):
    L = build_graph("healpix", {"subdivisions": subdiv, "nest": True},
                    k=8).L.tocsr()
    mat = L if symmetric else _nonsymmetric(L)
    n = mat.shape[0]
    op = BlockSparseOperator.from_scipy(mat, symmetric=symmetric,
                                        dtype=TORCH_DT[dt], device="cpu")
    jop = JBlockSparseOperator.from_scipy(mat, symmetric=symmetric, m_tile=128,
                                          interpret=True, dtype=JAX_DT[dt])
    x_np = np.random.default_rng(subdiv).standard_normal((n, 96)).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(TORCH_DT[dt]).requires_grad_()
    y = op.matvec(x)
    yj = np.asarray(jop.matvec(jnp.asarray(x_np, JAX_DT[dt])), np.float32)
    assert y.dtype == TORCH_DT[dt] and y.shape == (n, 96)
    assert rel_err(y.detach().float().numpy(), yj) <= MV_TOL[dt]
    # the backward walks the transposed layout's own list
    g = np.random.default_rng(subdiv + 1).standard_normal((n, 96)).astype(
        np.float32)
    y.backward(torch.from_numpy(g).to(TORCH_DT[dt]))
    gt = mat.T @ torch.from_numpy(g).to(TORCH_DT[dt]).float().numpy()
    assert rel_err(x.grad.float().numpy(), gt) <= 2 * MV_TOL[dt]


# ---------------------------------------------------------------------------
# The plain layout (rows_per_super=0)
# ---------------------------------------------------------------------------

def _plain(mat, **kw):
    return BlockSparseOperator.from_scipy(mat, rows_per_super=0, device="cpu",
                                          **kw)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_plain_slots_match_jax_nonzero_blocks(lap, dt):
    # the listed slots of each row block are exactly the JAX package's
    # nonzero blocks of the same padded BCSR, in slot order
    mask = _nonzero_block_mask(jbcsr_from_scipy(lap)[0])
    op = _plain(lap, dtype=TORCH_DT[dt])
    n_rb, max_nb = mask.shape
    assert op.nz.dtype == torch.int32 and op.nz.shape == (n_rb, 1 + max_nb)
    assert torch.equal(op.nz, plain_nonzero_slots(op.vals))
    np.testing.assert_array_equal(op.nz[:, 0].numpy(), mask.sum(1))
    for r in range(n_rb):
        c = int(op.nz[r, 0])
        assert op.nz[r, 1:1 + c].tolist() == np.flatnonzero(mask[r]).tolist()


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_plain_operator_carries_its_lists(lap, symmetric):
    mat = lap if symmetric else _nonsymmetric(lap)
    op = _plain(mat, symmetric=symmetric)
    kind, _, _, nz = op.forward_layout()
    assert kind == "plain" and nz is op.nz
    if symmetric:
        assert op.nz_t is None and op.transpose_layout()[3] is op.nz
        return
    kind_t, _, _, nz_t = op.transpose_layout()
    assert kind_t == "plain" and nz_t is op.nz_t
    assert torch.equal(op.nz_t, plain_nonzero_slots(op.vals_t))
    mask_t = _nonzero_block_mask(jbcsr_from_scipy(mat.T.tocsr())[0])
    np.testing.assert_array_equal(op.nz_t[:, 0].numpy(), mask_t.sum(1))


@pytest.mark.parametrize("n_node", [2, 4])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_plain_row_shard_slices_the_list(lap, n_node, symmetric):
    mat = lap if symmetric else _nonsymmetric(lap)
    op = _plain(mat, symmetric=symmetric)
    n = mat.shape[0]
    for rank in range(n_node):
        v0, v1 = rank * n // n_node, (rank + 1) * n // n_node
        shard = op.row_shard(v0, v1, group=None)
        for full, part in ((op.forward_layout(), shard.forward_layout()),
                           (op.transpose_layout(), shard.transpose_layout())):
            _, a, idx, nz = full
            kind, a_s, idx_s, nz_s, r0, _ = part
            lo, hi = r0 // 128, r0 // 128 + a_s.shape[0]
            assert kind == "plain"
            assert torch.equal(a_s, a[lo:hi]) and torch.equal(idx_s, idx[lo:hi])
            assert torch.equal(nz_s, nz[lo:hi])
            assert torch.equal(nz_s, plain_nonzero_slots(a_s))


# (A dtype, x dtype, round_a): the regimes of the plain kernel
PLAIN_REGIMES = [("fp32", "fp32", True), ("bf16", "bf16", True),
                 ("fp32", "bf16", True), ("fp32", "bf16", False)]


@pytest.mark.parametrize("a_dt,x_dt,round_a", PLAIN_REGIMES)
def test_plain_versions_with_plain_list_equal_without(lap, a_dt, x_dt,
                                                      round_a):
    op = _plain(lap, dtype=TORCH_DT[a_dt])
    x = _x(op.rows, 64, x_dt, 5)
    a, idx, nz = op.vals, op.cols, op.nz
    assert torch.equal(bcsr_spmm_reference(a, idx, x, nz, round_a=round_a),
                       bcsr_spmm_reference(a, idx, x, round_a=round_a))
    n_rb = a.shape[0]
    for r0, r1 in ((0, n_rb), (0, 1), (n_rb - 1, n_rb)):
        assert torch.equal(
            bcsr_spmm_rows_reference(a, idx, x, r0, r1, nz, round_a=round_a),
            bcsr_spmm_rows_reference(a, idx, x, r0, r1, round_a=round_a))
    # the CPU wrappers run the plain versions with the list they are given
    assert torch.equal(bcsr_spmm(a, idx, x, nz, round_a=round_a),
                       bcsr_spmm_reference(a, idx, x, round_a=round_a))


def test_plain_wrong_list_changes_the_result(lap):
    op = _plain(lap)
    x = _x(op.rows, 64, "fp32", 6)
    right = bcsr_spmm_reference(op.vals, op.cols, x, op.nz)
    # drop the first listed slot of the last row block
    r = op.nz.shape[0] - 1
    wrong = op.nz.clone()
    c = int(wrong[r, 0])
    wrong[r, 1:c] = op.nz[r, 2:c + 1]
    wrong[r, 0] = c - 1
    y = bcsr_spmm_reference(op.vals, op.cols, x, wrong)
    rows = slice(r * 128, (r + 1) * 128)
    assert not torch.equal(y[rows], right[rows])
    assert torch.equal(y[:r * 128], right[:r * 128])
    assert not torch.equal(
        bcsr_spmm_rows_reference(op.vals, op.cols, x, r, r + 1, wrong),
        bcsr_spmm_rows_reference(op.vals, op.cols, x, r, r + 1, op.nz))


def test_plain_bad_list_is_refused(lap):
    op = _plain(lap)
    x = _x(op.rows, 64, "fp32", 7)
    for bad in (op.nz.long(), op.nz[:, :-1], torch.cat([op.nz, op.nz]),
                op.nz[None]):
        with pytest.raises(ValueError, match="slot list"):
            bcsr_spmm(op.vals, op.cols, x, bad)
        with pytest.raises(ValueError, match="slot list"):
            bcsr_spmm_rows(op.vals, op.cols, x, 0, 1, bad)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("subdiv", [4, 8])
def test_plain_matvec_matches_jax_interpret(subdiv, symmetric, dt):
    # the JAX operator in interpret mode runs the plain layout (K4)
    L = build_graph("healpix", {"subdivisions": subdiv, "nest": True},
                    k=8).L.tocsr()
    mat = L if symmetric else _nonsymmetric(L)
    n = mat.shape[0]
    op = _plain(mat, symmetric=symmetric, dtype=TORCH_DT[dt])
    jop = JBlockSparseOperator.from_scipy(mat, symmetric=symmetric, m_tile=128,
                                          interpret=True, dtype=JAX_DT[dt],
                                          rows_per_super=0)
    x_np = np.random.default_rng(subdiv + 2).standard_normal((n, 96)).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(TORCH_DT[dt]).requires_grad_()
    y = op.matvec(x)
    yj = np.asarray(jop.matvec(jnp.asarray(x_np, JAX_DT[dt])), np.float32)
    assert y.dtype == TORCH_DT[dt] and y.shape == (n, 96)
    assert rel_err(y.detach().float().numpy(), yj) <= MV_TOL[dt]
    # the backward walks the transposed layout's own list
    g = np.random.default_rng(subdiv + 3).standard_normal((n, 96)).astype(
        np.float32)
    y.backward(torch.from_numpy(g).to(TORCH_DT[dt]))
    gt = mat.T @ torch.from_numpy(g).to(TORCH_DT[dt]).float().numpy()
    assert rel_err(x.grad.float().numpy(), gt) <= 2 * MV_TOL[dt]
