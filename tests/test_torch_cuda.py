"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the super-row SpMM (K1) and the plain-BCSR SpMM (K3, and K4's fp32-A
regime), forward and backward, in every regime (`spmm_regime`: the
tensor-core bodies for bf16 x, fp32 A rounded or split; the gather body
for fp32 x, fp32 or bf16 A), their row-range entries (K2 and K3's
row-sharded form) against the rows of the full launch (exactly) and their
plain versions (exactly in the fp32-x regimes: one FMA chain over the
nonzeros in the walk's order, as the plain version's product sums them;
the bf16-x tensor-core body at the bf16 bar: it sums in another order),
the gather body's row groups, its flushes of rows longer than its lists
and its skipped zero entries (0 x inf), the slot lists (every column
tile, zero row blocks, the list against walking every slot), K4's split of
fp32 A into bf16 hi + lo told apart from K3's rounding on a product that
cancels (`tests/torch_split_probe.py`: under 2^-14 and above it), one
training step against the CPU plain path, K5 (the op's vmap rule: one
launch per vmapped product, forward and backward) and exported artifacts
(single and 2-member) saved, loaded and run on the card; the fp32 ELL
product (`ell_spmm`, every fp32 operator's route) equal to its plain
version bit for bit, its row ranges to the full launch's rows, its
backward 2 L^T (L x); `cheb_conv`'s bf16 channel mixes (tensor-core GEMMs,
fp32 accumulation) against their fp32-widened form at HEALPix-64's level
0, apart by summation order alone, and the flag a bf16 model sets so that
no split-K is reduced in bf16.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. This file imports neither JAX nor the JAX package, so it also runs on
a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: `tests/conftest.py` sets JAX up.) Tolerance: max abs error
/ max abs of the plain version, fp32 1e-5, bf16 1e-2 (summation order and
one bf16 output rounding); a training step's losses and gradients, per
gradient key, 1e-5 (fp32, the CPU taking the card's ReLU and max-pool
decisions) and 3e-2 (bf16: roundings at the same points in another
order); a one-element gradient against the sum of its terms' magnitudes,
see the test; the BatchNorm step's bf16 gradients to the larger of 3e-2
and the CPU's own bf16-vs-fp32 gap on the key (see the test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy import sparse  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import AreaWeights, make_ar_loss_fn  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.models.geometry import cached_graph_laplacian  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    ChebOperator,
    bcsr_from_scipy,
    bcsr_super_from_scipy,
    bcsr_spmm,
    bcsr_spmm_reference,
    bcsr_spmm_rows,
    bcsr_spmm_rows_reference,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    bcsr_super_spmm_rows,
    bcsr_super_spmm_rows_reference,
    cheb_conv,
    EllOperator,
    ell_spmm,
    ell_spmm_reference,
    ell_spmm_rows,
    ell_spmm_rows_reference,
    launch_counts,
    plain_nonzero_slots,
    spmm_col_tile,
    super_nonzero_slots,
)
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402
from torch_grad_terms import cancelling_norm_biases, term_sums  # noqa: E402
from torch_split_probe import SPLIT_BAR, split_probe  # noqa: E402
from torch_steer import steer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda

DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 1e-2}
TRAIN_TOL = {"fp32": 1e-5, "bf16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


# HEALPix-4: 192 rows pad to one half-empty super-row; HEALPix-8: 3 full ones
@pytest.mark.parametrize("subdiv", [4, 8])
@pytest.mark.parametrize("a_dt", ["fp32", "bf16"])
@pytest.mark.parametrize("x_dt", ["fp32", "bf16"])
def test_kernel_matches_plain_version(cuda, subdiv, a_dt, x_dt):
    g = build_graph("healpix", {"subdivisions": subdiv, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(g.L, dtype=DT[a_dt], device=cuda)
    rng = np.random.default_rng(subdiv)
    x = torch.from_numpy(rng.standard_normal((op.rows, 384)).astype(
        np.float32)).to(cuda, DT[x_dt])
    before = launch_counts["bcsr_super_spmm"]
    y = bcsr_super_spmm(op.svals, op.ucols, x)
    torch.cuda.synchronize()
    assert launch_counts["bcsr_super_spmm"] == before + 1
    assert y.dtype == DT[x_dt] and y.shape == (op.rows, 384)
    ref = bcsr_super_spmm_reference(op.svals, op.ucols, x)
    assert rel_err(y, ref) <= TOL[x_dt]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_matvec_pads_and_matches_scipy(cuda, dt):
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(g.L, dtype=DT[dt], device=cuda)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((g.n_nodes, 33)).astype(np.float32)
    y = op.matvec(torch.from_numpy(x).to(cuda, DT[dt]))
    assert y.shape == (g.n_nodes, 33) and y.dtype == DT[dt]
    assert rel_err(y.float(), torch.from_numpy(g.L @ x)) <= TOL[dt] * 2


def test_kernel_rejects_non_contiguous(cuda):
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(g.L, device=cuda)
    x = torch.zeros((256, op.rows), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        bcsr_super_spmm(op.svals, op.ucols, x)


@pytest.mark.parametrize("layout", ["super", "plain"])
def test_kernel_raises_when_the_descriptor_encode_fails(cuda, layout):
    # TMA needs x 16-byte aligned: a view 2 bytes in cannot be encoded,
    # and the bf16 launch raises rather than fall back to another body
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(
        g.L, dtype=torch.bfloat16,
        rows_per_super=2 if layout == "super" else 0, device=cuda)
    _, a, idx, nz = op.forward_layout()
    full_fn, key = ROW_FNS[layout][0], ROW_FNS[layout][4]
    flat = torch.zeros(op.rows * 128 + 1, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(op.rows, 128)
    before = launch_counts[key]
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        full_fn(a, idx, x, nz)
    assert launch_counts[key] == before


@pytest.mark.parametrize("subdiv", [4, 8])
@pytest.mark.parametrize("a_dt,x_dt,round_a", [
    ("fp32", "fp32", True), ("bf16", "bf16", True), ("bf16", "fp32", True),
    ("fp32", "bf16", True), ("fp32", "bf16", False)])
def test_plain_kernel_matches_plain_version(cuda, subdiv, a_dt, x_dt, round_a):
    g = build_graph("healpix", {"subdivisions": subdiv, "nest": True}, k=8)
    vals, cols, n_pad = bcsr_from_scipy(g.L)
    a = torch.from_numpy(vals).to(cuda, DT[a_dt])
    c = torch.from_numpy(cols).to(cuda)
    nz = plain_nonzero_slots(a)
    rng = np.random.default_rng(subdiv + 10)
    x_np = rng.standard_normal((n_pad, 320)).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda, DT[x_dt])
    before = launch_counts["bcsr_spmm"]
    y = bcsr_spmm(a, c, x, nz, round_a=round_a)
    torch.cuda.synchronize()
    assert launch_counts["bcsr_spmm"] == before + 1
    assert y.dtype == DT[x_dt] and y.shape == (n_pad, 320)
    assert rel_err(y, bcsr_spmm_reference(a, c, x, nz, round_a=round_a)) \
        <= TOL[x_dt]
    # scipy with A as the product sees it: bf16-stored, or fp32 rounded to
    # bf16 against bf16 x in the round_a regime
    L = g.L.copy()
    if a_dt == "bf16" or (x_dt == "bf16" and round_a):
        L.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
    n = g.n_nodes
    ref = L @ x.float().cpu().numpy()[:n]
    assert rel_err(y[:n].float(), torch.from_numpy(ref)) <= 2 * TOL[x_dt]


# (full, row range, plain row range, row-range key, full key)
ROW_FNS = {"super": (bcsr_super_spmm, bcsr_super_spmm_rows,
                     bcsr_super_spmm_rows_reference, "bcsr_super_spmm_rows",
                     "bcsr_super_spmm"),
           "plain": (bcsr_spmm, bcsr_spmm_rows, bcsr_spmm_rows_reference,
                     "bcsr_spmm_rows", "bcsr_spmm")}


# the flagship's level 0 (HEALPix-16, 12 super-rows) and its large-graph
# form (HEALPix-64, 192), split over 2 and 4 node ranks
@pytest.mark.parametrize("subdiv", [16, 64])
@pytest.mark.parametrize("n_node", [2, 4])
@pytest.mark.parametrize("layout", ["super", "plain"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_row_range_kernel_equals_full_launch_rows(cuda, subdiv, n_node, layout,
                                                  dt):
    L = cached_graph_laplacian("healpix", {"subdivisions": subdiv,
                                           "nest": True}, 20, "knn")[1]
    op = BlockSparseOperator.from_scipy(
        L, dtype=DT[dt], rows_per_super=2 if layout == "super" else 0,
        device=cuda)
    _, a, idx, nz = op.forward_layout()
    full_fn, rows_fn, plain_fn, key, _ = ROW_FNS[layout]
    kw = {"nz": nz}
    unit = op.rows // a.shape[0]
    rng = np.random.default_rng(subdiv + n_node)
    x = torch.from_numpy(rng.standard_normal((op.rows, 256)).astype(
        np.float32)).to(cuda, DT[dt])
    full = full_fn(a, idx, x, **kw)
    n = L.shape[0]
    for r in range(n_node):
        v0, v1 = r * n // n_node, (r + 1) * n // n_node
        lo, hi = v0 // unit, -(-v1 // unit)
        before = launch_counts[key]
        y = rows_fn(a, idx, x, lo, hi, **kw)
        torch.cuda.synchronize()
        assert launch_counts[key] == before + 1
        assert y.dtype == DT[dt] and y.shape == ((hi - lo) * unit, 256)
        assert torch.equal(y, full[lo * unit:hi * unit])
        ref = plain_fn(a, idx, x, lo, hi, **kw)
        if dt == "bf16":
            assert rel_err(y, ref) <= TOL[dt]   # tensor cores: another order
        else:
            assert torch.equal(y, ref)


@pytest.mark.parametrize("layout", ["super", "plain"])
def test_row_range_kernel_rejects_bad_ranges(cuda, layout):
    g = build_graph("healpix", {"subdivisions": 8, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(
        g.L, rows_per_super=2 if layout == "super" else 0, device=cuda)
    _, a, idx, _ = op.forward_layout()
    rows_fn, key = ROW_FNS[layout][1], ROW_FNS[layout][3]
    x = torch.zeros((op.rows, 128), device=cuda)
    n = a.shape[0]
    before = launch_counts[key]
    for b, e in ((-1, 1), (0, 0), (1, 0), (n - 1, n + 1), (n, n + 1)):
        with pytest.raises(ValueError, match="range"):
            rows_fn(a, idx, x, b, e)
    assert launch_counts[key] == before


# the tensor-core body's column tile is 256, 128 or 64 by M alone (at most
# 128 for fp32 A); the plain layout's in each bf16-x regime: bf16 A, and
# fp32 A rounded to bf16 (round_a) or split into bf16 hi + lo (K4)
@pytest.mark.parametrize("layout", ["super", "plain"])
@pytest.mark.parametrize("M,tile", [(64, 64), (128, 128), (192, 64),
                                    (256, 256), (384, 128), (2048, 256)])
def test_kernel_every_column_tile(cuda, M, tile, layout):
    from deepsphere_weather_torch.ops.bcsr import _kernel, _plain_kernel

    L = cached_graph_laplacian("healpix", {"subdivisions": 16, "nest": True},
                               20, "knn")[1]
    rng = np.random.default_rng(M)
    n = L.shape[0]
    Lb = L.copy()
    Lb.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
    regimes = ([(torch.bfloat16, True), (torch.float32, True)]
               if layout == "super" else
               [(torch.bfloat16, True), (torch.float32, True),
                (torch.float32, False)])
    for a_dt, round_a in regimes:
        op = BlockSparseOperator.from_scipy(
            L, dtype=a_dt, rows_per_super=2 if layout == "super" else 0,
            device=cuda)
        _, a, idx, nz = op.forward_layout()
        x = torch.from_numpy(rng.standard_normal((op.rows, M)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        # the fp32-A regimes stop at 128 columns (256 spill)
        want_tile = tile if a_dt == torch.bfloat16 else min(tile, 128)
        assert spmm_col_tile(M, a_dt, torch.bfloat16) == want_tile
        if layout == "super":
            tile_of = _kernel().lib.bcsr_super_spmm_col_tile
            assert tile_of(M, int(a_dt == torch.bfloat16), 1) == want_tile
            y = bcsr_super_spmm(a, idx, x, nz)
            want = bcsr_super_spmm_reference(a, idx, x, nz)
        else:
            tile_of = _plain_kernel().lib.bcsr_spmm_col_tile
            assert tile_of(M, int(a_dt == torch.bfloat16), 1) == want_tile
            y = bcsr_spmm(a, idx, x, nz, round_a=round_a)
            want = bcsr_spmm_reference(a, idx, x, nz, round_a=round_a)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and y.shape == (op.rows, M)
        assert rel_err(y, want) <= TOL["bf16"]
        # scipy with A as the product sees it: fp32 only in K4's regime
        # (the super layout rounds fp32 A to bf16 against bf16 x, as K1)
        mat = L if a_dt == torch.float32 and not round_a else Lb
        ref = torch.from_numpy(mat @ x[:n].float().cpu().numpy())
        assert rel_err(y[:n].float(), ref) <= 2 * TOL["bf16"]


def test_column_tile_rule_matches_the_kernels(cuda):
    # `spmm_col_tile` (the rule the CPU tests hold) is the kernels' own
    from deepsphere_weather_torch.ops.bcsr import _kernel, _plain_kernel

    for lib, name in ((_kernel().lib, "bcsr_super_spmm"),
                      (_plain_kernel().lib, "bcsr_spmm")):
        tile_of = getattr(lib, f"{name}_col_tile")
        for a_dt in (torch.float32, torch.bfloat16):
            for x_dt in (torch.float32, torch.bfloat16):
                for M in (4, 60, 64, 96, 128, 192, 256, 320, 384, 1024,
                          2048, 10240):
                    assert tile_of(M, int(a_dt == torch.bfloat16),
                                   int(x_dt == torch.bfloat16)) == \
                        spmm_col_tile(M, a_dt, x_dt), (name, a_dt, x_dt, M)


# every A/x pair that is not one dtype on both sides, on both layouts'
# row ranges: the gather body (bf16 A, fp32 x) exactly, the fp32-A
# tensor-core bodies (fp32 A, bf16 x) at the bf16 bar against the plain
# version, and each range equal to the full launch's rows
@pytest.mark.parametrize("subdiv", [16, 64])
@pytest.mark.parametrize("layout", ["super", "plain"])
@pytest.mark.parametrize("a_dt,x_dt", [("bf16", "fp32"), ("fp32", "bf16")])
def test_row_range_kernel_mixed_types_equals_full_launch_rows(
        cuda, subdiv, layout, a_dt, x_dt):
    L = cached_graph_laplacian("healpix", {"subdivisions": subdiv,
                                           "nest": True}, 20, "knn")[1]
    op = BlockSparseOperator.from_scipy(
        L, dtype=DT[a_dt], rows_per_super=2 if layout == "super" else 0,
        device=cuda)
    _, a, idx, nz = op.forward_layout()
    full_fn, rows_fn, plain_fn, key, full_key = ROW_FNS[layout]
    unit = op.rows // a.shape[0]
    x = torch.from_numpy(np.random.default_rng(subdiv).standard_normal(
        (op.rows, 256)).astype(np.float32)).to(cuda, DT[x_dt])
    before = launch_counts[full_key]
    full = full_fn(a, idx, x, nz)
    torch.cuda.synchronize()
    assert launch_counts[full_key] == before + 1
    assert full.dtype == DT[x_dt]
    n = a.shape[0]
    for lo, hi in ((0, n // 2), (n // 2, n), (1, n - 1)):
        y = rows_fn(a, idx, x, lo, hi, nz)
        assert torch.equal(y, full[lo * unit:hi * unit])
        ref = plain_fn(a, idx, x, lo, hi, nz)
        if x_dt == "bf16":
            assert rel_err(y, ref) <= TOL["bf16"]
        else:
            assert torch.equal(y, ref)
    Lb = L.copy()
    Lb.data = torch.from_numpy(L.data).to(torch.bfloat16).float().numpy()
    m = L.shape[0]
    want = torch.from_numpy(Lb @ x[:m].float().cpu().numpy())
    assert rel_err(full[:m].float(), want) <= 2 * TOL[x_dt]


# the gather body's row groups: 32 rows a CTA where the launch has enough
# row blocks for two CTAs an SM, else 16 or 8 (HEALPix-16's 24 row blocks:
# 8); ranges of every size between give each, all equal to the full
# launch's rows, and within the fp32 bar of the plain version (whose
# product cuBLAS may split along k for a small range)
@pytest.mark.parametrize("layout", ["super", "plain"])
@pytest.mark.parametrize("a_dt", ["fp32", "bf16"])
def test_gather_body_every_row_group(cuda, layout, a_dt):
    L = cached_graph_laplacian("healpix", {"subdivisions": 64, "nest": True},
                               20, "knn")[1]
    op = BlockSparseOperator.from_scipy(
        L, dtype=DT[a_dt], rows_per_super=2 if layout == "super" else 0,
        device=cuda)
    _, a, idx, nz = op.forward_layout()
    full_fn, rows_fn, plain_fn = ROW_FNS[layout][:3]
    unit = op.rows // a.shape[0]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (op.rows, 128)).astype(np.float32)).to(cuda)
    full = full_fn(a, idx, x, nz)
    n = a.shape[0]
    for span in (1, 3, 16, 40, 70, n // 2, n):
        lo = (n - span) // 3
        y = rows_fn(a, idx, x, lo, lo + span, nz)
        assert torch.equal(y, full[lo * unit:(lo + span) * unit]), span
        assert rel_err(y, plain_fn(a, idx, x, lo, lo + span, nz)) \
            <= TOL["fp32"], span


def _long_rows(n, seed):
    """A sparse [n, n] fp32 matrix whose rows hold up to all 128 columns of
    a block and up to 3 x 128 nonzeros: longer than the gather body's
    lists (64 entries a row), so that its flushes run."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n):
        k = int(rng.integers(0, 3)) if r % 5 else 3 * 128
        c = (rng.choice(n, size=k, replace=False) if r % 5
             else np.arange(3 * 128) % n)
        if r % 7 == 0:     # one whole block row
            c = np.concatenate([c, (r // 128) * 128 + np.arange(128)])
        c = np.unique(c)
        rows.append(np.full(c.size, r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("layout", ["super", "plain"])
@pytest.mark.parametrize("a_dt", ["fp32", "bf16"])
def test_gather_body_flushes_long_rows(cuda, layout, a_dt):
    A = _long_rows(1024, 3)
    if layout == "super":
        a_np, idx_np, n_pad = bcsr_super_from_scipy(A)
        a = torch.from_numpy(a_np).to(cuda, DT[a_dt])
        nz = super_nonzero_slots(a)
    else:
        a_np, idx_np, n_pad = bcsr_from_scipy(A)
        a = torch.from_numpy(a_np).to(cuda, DT[a_dt])
        nz = plain_nonzero_slots(a)
    idx = torch.from_numpy(idx_np).to(cuda)
    full_fn, rows_fn, plain_fn = ROW_FNS[layout][:3]
    rows = n_pad if layout == "plain" else a.shape[0] * a.shape[1] * 128
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (rows, 192)).astype(np.float32)).to(cuda)
    y = full_fn(a, idx, x, nz)
    assert torch.equal(y, full_fn(a, idx, x, None))
    ref = (bcsr_super_spmm_reference(a, idx, x, nz) if layout == "super"
           else bcsr_spmm_reference(a, idx, x, nz))
    assert rel_err(y, ref) <= TOL["fp32"]
    n = a.shape[0]
    unit = rows // n
    assert torch.equal(rows_fn(a, idx, x, 1, n, nz), y[unit:])
    Ab = A.copy()
    if a_dt == "bf16":
        Ab.data = torch.from_numpy(A.data).to(torch.bfloat16).float().numpy()
    want = torch.from_numpy(Ab @ x[:1024].cpu().numpy())
    assert rel_err(y[:1024], want) <= TOL["fp32"]


# 0 x inf: a dense-block sum gives NaN where an infinite x row meets only
# zero entries of a listed block; the gather body multiplies A's nonzero
# entries alone, so its output stays finite (as the ELL route's)
@pytest.mark.parametrize("layout", ["super", "plain"])
def test_gather_body_skips_zero_entries(cuda, layout):
    # HEALPix-4: 192 nodes in two row blocks; x's padding rows 192..255
    # lie in block-column 1, which every row block lists, and meet only
    # zero entries of A
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(
        g.L, rows_per_super=2 if layout == "super" else 0, device=cuda)
    _, a, idx, nz = op.forward_layout()
    n = g.n_nodes
    assert op.rows == 256
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (op.rows, 64)).astype(np.float32)).to(cuda)
    x[n:] = float("inf")
    full_fn = ROW_FNS[layout][0]
    y = full_fn(a, idx, x, nz)
    assert torch.isfinite(y).all()
    x0 = x.clone()
    x0[n:] = 0.0
    assert torch.equal(y, full_fn(a, idx, x0, nz))
    plain = (bcsr_super_spmm_reference if layout == "super"
             else bcsr_spmm_reference)
    assert torch.isnan(plain(a, idx, x, nz)).any()


# R = 4 at HEALPix-4: one super-row of 4 row blocks, the last 2 padding
# (no listed slot)
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_kernel_row_block_without_slots_writes_zeros(cuda, dt):
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=8)
    op = BlockSparseOperator.from_scipy(g.L, dtype=DT[dt], rows_per_super=4,
                                        device=cuda)
    assert op.nz[0, :, 0].tolist()[2:] == [0, 0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (op.rows, 128)).astype(np.float32)).to(cuda, DT[dt])
    y = bcsr_super_spmm(op.svals, op.ucols, x, op.nz)
    torch.cuda.synchronize()
    assert torch.equal(y[256:], torch.zeros_like(y[256:]))
    assert rel_err(y, bcsr_super_spmm_reference(op.svals, op.ucols, x,
                                                op.nz)) <= TOL[dt]


# the slot list skips only zero blocks: the same sums, bit for bit (the
# plain layout's fp32-A cases: K3's rounding and K4's split)
@pytest.mark.parametrize("layout,dt", [
    ("super", "fp32"), ("super", "bf16"), ("plain", "fp32"), ("plain", "bf16"),
    ("plain", "fp32_a"), ("plain", "fp32_a_split")])
def test_kernel_slot_list_equals_every_slot(cuda, dt, layout):
    L = cached_graph_laplacian("healpix", {"subdivisions": 16, "nest": True},
                               20, "knn")[1]
    a_dt, x_dt = {"fp32_a": ("fp32", "bf16"),
                  "fp32_a_split": ("fp32", "bf16")}.get(dt, (dt, dt))
    op = BlockSparseOperator.from_scipy(
        L, dtype=DT[a_dt], rows_per_super=2 if layout == "super" else 0,
        device=cuda)
    _, a, idx, nz = op.forward_layout()
    full_fn, rows_fn = ROW_FNS[layout][:2]
    kw = {} if layout == "super" else {"round_a": dt != "fp32_a_split"}
    assert int(nz[..., 0].sum()) < nz[..., 1:].numel()   # some skipped
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (op.rows, 1024)).astype(np.float32)).to(cuda, DT[x_dt])
    assert torch.equal(full_fn(a, idx, x, nz, **kw),
                       full_fn(a, idx, x, None, **kw))
    n = a.shape[0]
    assert torch.equal(rows_fn(a, idx, x, 1, n - 1, nz, **kw),
                       rows_fn(a, idx, x, 1, n - 1, None, **kw))


# K4's split (hi + lo) told apart from K3's rounding of fp32 A (hi), which
# the bf16 bar cannot do: the probe's exact product is about 0, so no output
# rounding hides what each regime did to A (tests/torch_split_probe.py);
# column tiles 64 and 128, the full launch and a row range
@pytest.mark.parametrize("subdiv", [16, 64])
@pytest.mark.parametrize("M", [64, 1024])
def test_split_reads_apart_from_rounding(cuda, subdiv, M):
    L = cached_graph_laplacian("healpix", {"subdivisions": subdiv,
                                           "nest": True}, 20, "knn")[1]
    A, x_np, reading = split_probe(L, M, subdiv + M)
    op = BlockSparseOperator.from_scipy(A, rows_per_super=0, device=cuda)
    _, a, idx, nz = op.forward_layout()
    x = torch.nn.functional.pad(torch.from_numpy(x_np),
                                (0, 0, 0, op.rows - A.shape[0])).to(
                                    cuda, torch.bfloat16)
    got = {}
    for round_a in (False, True):
        y = bcsr_spmm(a, idx, x, nz, round_a=round_a)
        got[round_a] = reading(y.float().cpu().numpy())
        n_rb = a.shape[0]
        rows = bcsr_spmm_rows(a, idx, x, 1, n_rb, nz, round_a=round_a)
        assert torch.equal(rows, y[128:])
    assert got[False] < SPLIT_BAR < got[True], got


def _nonsymmetric(L):
    d = np.random.default_rng(0).uniform(0.5, 2.0, L.shape[0])
    return (sparse.diags(d.astype(np.float32)) @ L).tocsr().astype(np.float32)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("rows_per_super,kernel", [
    (2, "bcsr_super_spmm"), (0, "bcsr_spmm")], ids=["K1", "K3"])
def test_backward_is_2_lt_l_x(cuda, symmetric, rows_per_super, kernel):
    g = build_graph("healpix", {"subdivisions": 8, "nest": True}, k=8)
    mat = g.L if symmetric else _nonsymmetric(g.L)
    op = BlockSparseOperator.from_scipy(mat, symmetric=symmetric,
                                        rows_per_super=rows_per_super,
                                        device=cuda)
    op.ell = None      # fp32 x on the block layout (its own route: ELL)
    x_np = np.random.default_rng(2).standard_normal(
        (g.n_nodes, 200)).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda).requires_grad_()
    before = dict(launch_counts)
    y = op.matvec(x)
    assert y.grad_fn is not None       # the kernel's output carries a gradient
    (y ** 2).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts[kernel] == before[kernel] + 2
    assert sum(launch_counts.values()) == sum(before.values()) + 2
    m64 = mat.astype(np.float64)
    want = 2.0 * (m64.T @ (m64 @ x_np.astype(np.float64)))
    assert rel_err(x.grad, torch.from_numpy(want)) <= 1e-5


def _knn(subdiv):
    return cached_graph_laplacian("healpix", {"subdivisions": subdiv,
                                              "nest": True}, 20, "knn")[1]


# the ELL kernel adds the same rounded products in the same order as its
# plain version: the two agree bit for bit, at any width that is a
# multiple of 4
@pytest.mark.parametrize("subdiv", [8, 16])
@pytest.mark.parametrize("M", [4, 60, 1024])
def test_ell_kernel_matches_plain_version(cuda, subdiv, M):
    L = _knn(subdiv)
    op = EllOperator.from_scipy(L, device=cuda)
    x_np = np.random.default_rng(subdiv + M).standard_normal(
        (L.shape[0], M)).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda)
    before = dict(launch_counts)
    y = ell_spmm(op.vals, op.cols, x, op.tables)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in launch_counts.items()
            if v != before[k]} == {"ell_spmm": 1}
    assert torch.equal(y, ell_spmm_reference(op.vals, op.cols, x))
    assert rel_err(y, torch.from_numpy(L @ x_np)) <= TOL["fp32"]
    # a view 4 bytes into its storage is copied to an aligned one first
    base = torch.zeros(x.numel() + 1, device=cuda)
    base[1:] = x.reshape(-1)
    assert torch.equal(ell_spmm(op.vals, op.cols, base[1:].view_as(x),
                                op.tables), y)
    # the kernel reads the layout through its union tables: none, none run
    with pytest.raises(ValueError, match="union tables"):
        ell_spmm(op.vals, op.cols, x)


@pytest.mark.parametrize("subdiv", [16, 64])
@pytest.mark.parametrize("n_node", [2, 4])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_ell_row_range_equals_full_launch_rows(cuda, subdiv, n_node,
                                               symmetric):
    L = _knn(subdiv)
    mat = L if symmetric else _nonsymmetric(L)
    op = EllOperator.from_scipy(mat, symmetric=symmetric, device=cuda)
    _, vals, cols, tables = (op.forward_layout() if symmetric
                             else op.transpose_layout())
    n = L.shape[0]
    x = torch.from_numpy(np.random.default_rng(n_node).standard_normal(
        (n, 256)).astype(np.float32)).to(cuda)
    full = ell_spmm(vals, cols, x, tables)
    for r in range(n_node):
        v0, v1 = r * n // n_node, (r + 1) * n // n_node
        before = launch_counts["ell_spmm_rows"]
        y = ell_spmm_rows(vals, cols, x, v0, v1, tables)
        torch.cuda.synchronize()
        assert launch_counts["ell_spmm_rows"] == before + 1
        assert torch.equal(y, full[v0:v1])
        assert torch.equal(y, ell_spmm_rows_reference(vals, cols, x, v0, v1))
        # a row shard's own rows and union tables, against the full x
        _, s_vals, s_cols, s_tables, _, _ = op.row_shard(
            v0, v1, None).transpose_layout()
        assert torch.equal(ell_spmm_rows(s_vals, s_cols, x, 0, v1 - v0,
                                         s_tables), y)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_ell_backward_is_2_lt_l_x(cuda, symmetric):
    # an fp32 operator's route: the ELL kernel forward and, on the
    # transposed layout when A is not symmetric, backward; a 2-member
    # vmap of its gradient is one launch each way
    g = build_graph("healpix", {"subdivisions": 8, "nest": True}, k=8)
    mat = g.L if symmetric else _nonsymmetric(g.L)
    op = BlockSparseOperator.from_scipy(mat, symmetric=symmetric, device=cuda)
    x_np = np.random.default_rng(2).standard_normal(
        (2, g.n_nodes, 200)).astype(np.float32)
    x = torch.from_numpy(x_np[0]).to(cuda).requires_grad_()
    before = dict(launch_counts)
    (op.matvec(x) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in launch_counts.items()
            if v != before[k]} == {"ell_spmm": 2}
    m64 = mat.astype(np.float64)
    want = np.stack([2.0 * (m64.T @ (m64 @ xi.astype(np.float64)))
                     for xi in x_np])
    assert rel_err(x.grad, torch.from_numpy(want[0])) <= 1e-5
    before = launch_counts["ell_spmm"]
    grad = torch.func.vmap(torch.func.grad(
        lambda xi: (op.matvec(xi) ** 2).sum()))(torch.from_numpy(x_np).to(
            cuda))
    torch.cuda.synchronize()
    assert launch_counts["ell_spmm"] == before + 2
    assert rel_err(grad, torch.from_numpy(want)) <= 1e-5


def _grads(model):
    return {k: p.grad.double().cpu() for k, p in model.named_parameters()}


# fp32 train step: a decision that differs between the card and the CPU
# must sit this close to its kink or tie (|x| or the max-pool gap, over
# the call's largest |x|): within fp32 rounding
KINK_TOL = 1e-6


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_train_step_matches_cpu(cuda, dt):
    # HEALPix-8 AR2, level 0 block-sparse (768 nodes; K1 on the card):
    # losses and every gradient on the card against the CPU plain path.
    # fp32: the CPU takes the card's ReLU and max-pool decisions, each
    # one that differs shown to sit within fp32 rounding of its kink or
    # tie, so that the gradients compare per key at 1e-5
    info = {"input_n_feature": 5, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": 768}},
            "output_shape_info": {"dynamic": {"node": 768}}}
    sampling = {"subdivisions": 8, "nest": True}
    indexer = ARIndexer.build([-3, -2, -1], [0], 1, 2)
    rng = np.random.default_rng(3)
    W = indexer.window_size
    batch = {"dynamic": rng.standard_normal((2, W, 768, 2)),
             "bc": rng.standard_normal((2, W, 768, 1)),
             "static": rng.standard_normal((768, 2))}
    cpu = torch.device("cpu")
    tree, pinned, runs = None, None, []
    for dev in (cuda, cpu):
        model = UNetSpherical(
            info, "healpix", sampling, knn=8, increment_learning=True,
            dense_threshold=767,
            numeric_precision="bfloat16" if dt == "bf16" else "float32",
            device=dev)
        if tree is None:
            tree = seeded_params(model, 4)
            for blk in tree.values():
                if isinstance(blk, dict):
                    blk["rezero_weight"] *= 0.1
        model.load_state_dict(params_from_jax(tree))
        decisions, gaps = (steer(model, pinned) if dt == "fp32"
                           else (None, []))
        pinned = decisions
        sums = term_sums(model)
        area_w = AreaWeights(model.geometry.samplings[0], device=dev)
        data = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
                for k, v in batch.items()}
        before = dict(launch_counts)
        total, per_iter = make_ar_loss_fn(model, indexer, 3)(
            data, np.ones(3, np.float32), area_w)
        total.backward()
        runs.append({"total": total.item(), "per_iter": per_iter.detach().cpu(),
                     "grads": _grads(model), "gaps": gaps, "sums": sums,
                     "launches": {k: launch_counts[k] - before[k]
                                  for k in before}})
    card, ref = runs
    # fp32 runs the ELL kernel, bf16 K1
    kernel = "ell_spmm" if dt == "fp32" else "bcsr_super_spmm"
    assert card["launches"] == {k: 3 * 10 + 3 * 10 - 2 if k == kernel else 0
                                for k in launch_counts}
    assert not any(ref["launches"].values())
    tol = TRAIN_TOL[dt]
    assert abs(card["total"] - ref["total"]) <= tol * abs(ref["total"])
    assert rel_err(card["per_iter"], ref["per_iter"]) <= tol
    assert all(gap <= KINK_TOL for gap in ref["gaps"]), ref["gaps"]
    # per key: max abs error over max abs of the CPU's; a one-element
    # gradient (ReZero, increment) is one sum whose terms cancel, and is
    # held against the sum of its terms' magnitudes instead
    assert set(ref["sums"]) == {k for k, v in ref["grads"].items()
                                if v.numel() == 1}
    worst = (0.0, "")
    for k, v in card["grads"].items():
        want = ref["grads"][k]
        scale = ref["sums"].get(k, float(want.abs().max()))
        err = float((v - want).abs().max()) / scale
        worst = max(worst, (err, k))
        assert err <= tol, (k, err)
    cancel = [ref["sums"][k] / abs(float(ref["grads"][k]))
              for k in ref["sums"] if float(ref["grads"][k])]
    steered = (f"{len(ref['gaps'])} decisions taken from the card differed "
               f"from the CPU's own, worst {max(ref['gaps'], default=0.0):.3e}"
               " from its kink or tie; " if dt == "fp32" else "")
    print(f"{dt}: {steered}worst gradient {worst[1]} {worst[0]:.3e} (tol "
          f"{tol:g}); one-element gradients: sum of |terms| / |sum| "
          f"{min(cancel):.3g} to {max(cancel):.3g}")


@pytest.mark.parametrize("layout,kernel", [
    ("super", "bcsr_super_spmm"), ("plain", "bcsr_spmm")], ids=["K1", "K3"])
def test_vmapped_matvec_is_one_launch(cuda, layout, kernel):
    # K5: vmap over 2 members folds them into the columns: one launch per
    # product, forward and backward, at the bf16 bar against the member
    # loop on the card and the CPU plain path; fp32 gradients 2 L^T (L x)
    g = build_graph("healpix", {"subdivisions": 8, "nest": True}, k=20)
    rps = 2 if layout == "super" else 0
    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((2, g.n_nodes, 320)).astype(np.float32)
    op = BlockSparseOperator.from_scipy(g.L, dtype=torch.bfloat16,
                                        rows_per_super=rps, device=cuda)
    x = torch.from_numpy(x_np).to(cuda, torch.bfloat16)
    before = dict(launch_counts)
    with torch.no_grad():
        y = torch.func.vmap(op.matvec)(x)
    torch.cuda.synchronize()
    assert launch_counts[kernel] == before[kernel] + 1
    assert sum(launch_counts.values()) == sum(before.values()) + 1
    with torch.no_grad():
        loop = torch.stack([op.matvec(xi) for xi in x])
        cpu = torch.func.vmap(BlockSparseOperator.from_scipy(
            g.L, dtype=torch.bfloat16, rows_per_super=rps,
            device="cpu").matvec)(x.cpu())
    assert rel_err(y.float(), loop.float()) <= TOL["bf16"]
    assert rel_err(y.float(), cpu.float()) <= TOL["bf16"]

    op32 = BlockSparseOperator.from_scipy(g.L, rows_per_super=rps,
                                          device=cuda)
    op32.ell = None    # fp32 x on the block layout (its own route: ELL)
    x32 = torch.from_numpy(x_np).to(cuda)
    before = dict(launch_counts)
    grad = torch.func.vmap(torch.func.grad(
        lambda xi: (op32.matvec(xi) ** 2).sum()))(x32)
    torch.cuda.synchronize()
    assert launch_counts[kernel] == before[kernel] + 2
    L = g.L.astype(np.float64)
    want = np.stack([2.0 * (L.T @ (L @ xi.astype(np.float64))) for xi in x_np])
    assert rel_err(grad, torch.from_numpy(want)) <= 1e-5


def test_artifact_on_card(cuda, tmp_path):
    # HEALPix-8 bf16 (level 0 block-sparse: K1), exported, saved and
    # loaded on the card: the single artifact against the in-process
    # rollout and the 2-member one against each member's, at the bf16 bar
    # (3e-2, the train step's: two steps of roundings); 10 K1 launches per
    # forward for one member or both
    from deepsphere_weather_torch.engine.step import make_rollout_block
    from deepsphere_weather_torch.serve import (
        export_ensemble_rollout,
        export_rollout,
        load_artifact,
        save_artifact,
    )

    info = {"input_n_feature": 2, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": 768}},
            "output_shape_info": {"dynamic": {"node": 768}}}
    model = UNetSpherical(info, "healpix", {"subdivisions": 8, "nest": True},
                          knn=20, increment_learning=True, dense_threshold=767,
                          numeric_precision="bfloat16", device=cuda)
    states = []
    for seed in (6, 7):
        tree = seeded_params(model, seed)
        for blk in tree.values():
            if isinstance(blk, dict):
                blk["rezero_weight"] *= 0.1
        states.append(params_from_jax(tree))
    kw = dict(input_k=[-3, -2, -1], output_k=[0], forecast_cycle=1,
              batch_size=2, block_size=2)
    save_artifact(tmp_path / "single", export_rollout(model, states[0], **kw))
    save_artifact(tmp_path / "ensemble",
                  export_ensemble_rollout(model, states, **kw))
    single, _, _ = load_artifact(tmp_path / "single")
    ensemble, _, _ = load_artifact(tmp_path / "ensemble")
    assert single.meta["platforms"] == ["cuda"]
    assert ensemble.meta["n_members"] == 2

    hist = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 4, 768, 2)).astype(np.float32)).to(cuda)
    refs = []
    for state in states:
        model.load_state_dict(state)
        rollout, _ = make_rollout_block(model, ARIndexer.build(
            [-3, -2, -1], [0], 1, 1), 2)
        with torch.inference_mode():
            refs.append(rollout(hist, None, None, None)[2].float())
    for rollout, inp, want in ((single, hist, refs[0]),
                               (ensemble, torch.stack([hist, hist]),
                                torch.stack(refs))):
        before = launch_counts["bcsr_super_spmm"]
        _, preds = rollout.call(inp)
        torch.cuda.synchronize()
        assert launch_counts["bcsr_super_spmm"] - before == 2 * 10
        assert rel_err(preds.float(), want) <= TRAIN_TOL["bf16"]


def _hp8_model(dev, dt, tree=None, batch_norm=False):
    info = {"input_n_feature": 5, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": 768}},
            "output_shape_info": {"dynamic": {"node": 768}}}
    model = UNetSpherical(
        info, "healpix", {"subdivisions": 8, "nest": True}, knn=8,
        increment_learning=True, dense_threshold=767, batch_norm=batch_norm,
        numeric_precision="bfloat16" if dt == "bf16" else "float32",
        device=dev)
    if tree is not None:
        model.load_state_dict(params_from_jax(tree))
    return model


def _hp8_tree(model, seed, increment=1.0):
    tree = seeded_params(model, seed)
    for blk in tree.values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    tree["res_increment"] *= increment
    return tree


def _hp8_batch(dev, indexer, seed=3):
    rng = np.random.default_rng(seed)
    W = indexer.window_size
    batch = {"dynamic": rng.standard_normal((2, W, 768, 2)),
             "bc": rng.standard_normal((2, W, 768, 1)),
             "static": rng.standard_normal((768, 2))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in batch.items()}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_batchnorm_step_matches_cpu(cuda, dt):
    # the BatchNorm flagship form at HEALPix-8 AR2 (level 0 block-sparse):
    # one with_norm_state loss (statistics collected, folded into the
    # running ones) and its gradients on the card against the CPU plain
    # path, the CPU taking the card's ReLU and max-pool decisions; 58 K1
    # launches. A norm bias whose output reaches another BatchNorm through
    # no activation is held against its block's norm scale
    # (`cancelling_norm_biases`): the H100 read
    # conv1.convblock1.norm_bias 0.37 of itself apart, its largest element
    # 2e-5.
    # bf16: BatchNorm's backward subtracts the mean of its incoming
    # gradient and of its product with the normalized input; deeper in the
    # network those terms cancel to a small remainder, which bf16 rounding
    # alone moves: the CPU's own bf16 step, on the same decisions, reads
    # up to about 1e-1 from its fp32 step (conv2's weights). So each bf16
    # gradient is held against the CPU's bf16 one to the larger of the bar
    # and that CPU rounding gap on its key; a fault of the card's path
    # reads far above both. The card's own bf16-vs-fp32 gap is printed
    # beside it.
    from deepsphere_weather_torch.engine import fold_running_stats

    indexer = ARIndexer.build([-3, -2, -1], [0], 1, 2)
    cpu = torch.device("cpu")
    # the card first (its decisions are taken by every other run), then
    # the CPU; in bf16 also both at fp32 on the same decisions
    plan = [(cuda, dt), (cpu, dt)]
    if dt == "bf16":
        plan += [(cpu, "fp32"), (cuda, "fp32")]
    tree, pinned, runs = None, None, []
    for dev, prec in plan:
        model = _hp8_model(dev, prec, batch_norm=True)
        tree = tree or _hp8_tree(model, 5)
        model.load_state_dict(params_from_jax(tree))
        decisions, _ = steer(model, pinned)
        sums = term_sums(model)
        area_w = AreaWeights(model.geometry.samplings[0], device=dev)
        before = dict(launch_counts)
        kernel = "ell_spmm" if prec == "fp32" else "bcsr_super_spmm"
        total, (per_iter, stats) = make_ar_loss_fn(
            model, indexer, 3, collect_stats=True)(
            _hp8_batch(dev, indexer), np.ones(3, np.float32), area_w)
        total.backward()
        fold_running_stats(model.norm_state(), stats)
        pinned = pinned or decisions
        runs.append({"per_iter": per_iter.detach().cpu(),
                     "grads": _grads(model), "sums": sums,
                     "stats": {k: v.cpu() for k, v in
                               model.norm_state().items()},
                     "launches": launch_counts[kernel] - before[kernel]})
    card, ref = runs[:2]
    # every gradient's scale is the CPU's fp32 step's
    truth = runs[2] if dt == "bf16" else ref
    cancelling = cancelling_norm_biases(model)

    def gaps(got, want):
        out = {}
        for k, v in got["grads"].items():
            scale = truth["sums"].get(k, float(truth["grads"][k].abs().max()))
            if k in cancelling:
                scale = float(truth["grads"][cancelling[k]].abs().max())
            out[k] = float((v - want["grads"][k]).abs().max()) / scale
        return out

    assert card["launches"] == 3 * 10 + 3 * 10 - 2
    assert ref["launches"] == 0
    tol = TRAIN_TOL[dt]
    assert rel_err(card["per_iter"], ref["per_iter"]) <= tol
    for k, v in card["stats"].items():
        assert rel_err(v, ref["stats"][k]) <= tol, k
    err = gaps(card, ref)
    bar = dict.fromkeys(err, tol)
    if dt == "bf16":
        cpu_gap, card_gap = gaps(ref, runs[2]), gaps(card, runs[3])
        bar = {k: max(tol, cpu_gap[k]) for k in err}
        # every key above the bar 3e-2 (held to the CPU's gap), largest
        # first, and the one nearest its bar
        shown = sorted((k for k in err if err[k] > tol), key=err.get)[::-1]
        shown += [max(err, key=lambda k: err[k] / bar[k])]
        print("bf16 gradients, card vs CPU / CPU bf16 vs fp32 / card bf16 "
              "vs fp32: " + "; ".join(
                  f"{k} {err[k]:.3e} / {cpu_gap[k]:.3e} / {card_gap[k]:.3e}"
                  for k in shown))
    for k in err:
        assert err[k] <= bar[k], (k, err[k], bar[k])


def test_member_step_is_one_launch_per_product(cuda):
    # 2 members (bf16, HEALPix-8 AR2, level 0 block-sparse) in one member
    # step: as many K1 launches as one member's step (58), each at twice
    # the single widths but the two on the shared input; each member's
    # losses and clipped gradients at the bf16 bar of its own single step
    # on the card (member 1's increment x3: the clip, between the two
    # gradient norms, clips member 1 alone)
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack
    from deepsphere_weather_torch.ops import bcsr

    indexer = ARIndexer.build([-3, -2, -1], [0], 1, 2)
    model = _hp8_model(cuda, "bf16")
    trees = [_hp8_tree(model, 6 + m, 1.0 + 2 * m) for m in range(2)]
    data = _hp8_batch(cuda, indexer, 7)
    area_w = AreaWeights(model.geometry.samplings[0], device=cuda)
    w = np.ones(3, np.float32)
    widths, kernel = [], bcsr.bcsr_super_spmm

    def record(a, idx, x, nz=None):
        widths.append(x.shape[1])
        return kernel(a, idx, x, nz)

    single = []
    for tree in trees:
        model.load_state_dict(params_from_jax(tree))
        model.zero_grad()
        make_ar_loss_fn(model, indexer, 3)(data, w, area_w)[0].backward()
        single.append(float(torch.stack([p.grad.float().square().sum()
                                         for p in model.parameters()])
                            .sum().sqrt()))
    clip = float(np.sqrt(single[0] * single[1]))
    runs = []
    for m, tree in enumerate(trees):
        model.load_state_dict(params_from_jax(tree))
        opt = Adam(model.parameters(), 1e-4, gradient_clipping=clip)
        bcsr.bcsr_super_spmm = record
        try:
            widths.clear()
            _, per_iter = make_train_step(model, indexer, opt, 3)(
                data, w, area_w)
        finally:
            bcsr.bcsr_super_spmm = kernel
        runs.append((per_iter.cpu(), _grads(model), list(widths)))
    stack = MemberStack.from_states(model, [params_from_jax(t)
                                            for t in trees])
    opt = Adam(stack.parameters(), 1e-4, gradient_clipping=clip,
               member_axis=True)
    before = launch_counts["bcsr_super_spmm"]
    bcsr.bcsr_super_spmm = record
    try:
        widths.clear()
        _, per_iter = make_member_train_step(stack, indexer, opt, 3)(
            data, w, area_w)
    finally:
        bcsr.bcsr_super_spmm = kernel
    assert launch_counts["bcsr_super_spmm"] - before == 58 == len(widths)
    one = runs[0][2]
    assert widths[:2] == one[:2] and widths[2:] == [2 * x for x in one[2:]]
    grads = {k: p.grad.double().cpu() for k, p in stack.named_parameters()}
    for m, (single_iter, single_grads, _) in enumerate(runs):
        assert rel_err(per_iter[m], single_iter) <= TRAIN_TOL["bf16"]
        scale = max(float(v.abs().max()) for v in single_grads.values())
        for k, v in single_grads.items():
            denom = scale if v.numel() == 1 else float(v.abs().max())
            err = float((grads[k][m] - v).abs().max()) / denom
            assert err <= TRAIN_TOL["bf16"], (m, k, err)


# one bf16 rounding step, relative: the spacing of bf16 values at x is at
# most 2^-7 |x|
BF16_STEP = 2.0 ** -7


def _widened_cheb_conv(op, x, weight, abs_l):
    """`cheb_conv`'s node-major branches (no bias) as written with
    fp32-widened channel mixes: x, the basis and the weight copied to fp32,
    fp32 GEMMs, each mix rounded once to x's dtype; every other operation
    as `cheb_conv` orders it. Returns the output and, per element, how far
    a form whose mixes sum in another fp32 order may lie from it: each mix
    one bf16 step of its element (and its fp32 order's least slack, 2 n
    2^-24 of its terms' magnitudes), and every rounding after a mix one
    step of its result, carried through |L| (`abs_l`, fp32 CSR)."""
    cdt = x.dtype
    B, V, Fin = x.shape
    _, K, Fout = weight.shape
    w32 = weight.to(cdt).float()

    def mv(h):
        return op.matvec(h.reshape(V, -1)).reshape(h.shape).to(cdt)

    def amv(e):
        return (abs_l @ e.reshape(V, -1)).reshape(e.shape)

    def step(t):
        return BF16_STEP * t.float().abs()

    def mix(spec, a, n):
        out = torch.einsum(spec, a.float(), w32).to(cdt)
        slack = torch.einsum(spec, a.float().abs(), w32.abs())
        return out, step(out) + 2 * n * 2.0 ** -24 * slack

    x = x.permute(1, 0, 2).contiguous()
    if Fout >= Fin:
        xs = [x, mv(x)]
        for _ in range(2, K):
            xs.append(2.0 * mv(xs[-1]) - xs[-2])
        out, e = mix("kvbf,fko->vbo", torch.stack(xs), K * Fin)
        return out.permute(1, 0, 2), e.permute(1, 0, 2)
    z, ez = mix("vbf,fko->kvbo", x, Fin)
    b1, b2, e1, e2 = z[K - 1], torch.zeros_like(z[0]), ez[K - 1], 0.0
    for k in range(K - 2, 0, -1):
        m = mv(b1)
        em = amv(e1) + step(m)
        s = z[k] + 2.0 * m
        es = ez[k] + 2.0 * em + step(s)
        b1, b2, e1, e2 = s - b2, b1, es + e2 + step(s - b2), e1
    m = mv(b1)
    s = z[0] + m
    out = s - b2
    e = ez[0] + amv(e1) + step(m) + step(s) + e2 + step(out)
    return out.permute(1, 0, 2), e.permute(1, 0, 2)


# HEALPix-64's level 0 at the shipped batch: conv1's widening conv (input
# side, 64 -> 128) and uconv1's narrowing one (Clenshaw, 256 -> 128)
@pytest.mark.parametrize("fin,fout", [(64, 128), (256, 128)],
                         ids=["input_side", "clenshaw"])
def test_bf16_channel_mixes_differ_from_widened_only_in_summation_order(
        cuda, fin, fout):
    # cheb_conv contracts bf16 operands on the tensor cores (fp32
    # accumulation, one rounding); the fp32-widened form multiplies the
    # same bf16 values exactly and adds them in fp32. So the outputs lie
    # within the bound `_widened_cheb_conv` carries (one step of each
    # mix), and the weight's gradient, a sum over batch x nodes = 786432
    # rows that cuBLAS splits, within 1e-3 (norm) of the widened form's: a
    # split-K whose partials were added in bf16 would round them again.
    # The flag that forbids that is set by building a bf16 model.
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        _hp8_model(cuda, "bf16")
        assert not (torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
        L = _knn(64)
        op = ChebOperator(bcsr=BlockSparseOperator.from_scipy(
            L, dtype=torch.bfloat16, device=cuda))
        a = abs(L).tocsr().astype(np.float32)
        abs_l = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr).long(), torch.from_numpy(a.indices).long(),
            torch.from_numpy(a.data), a.shape).to(cuda)
        rng = np.random.default_rng(fin)
        B, V, K = 16, L.shape[0], 3
        x = torch.from_numpy(rng.standard_normal((B, V, fin)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        w0 = torch.from_numpy((rng.standard_normal((fin, K, fout))
                               * np.sqrt(2.0 / (fin * K))).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((B, V, fout)).astype(
            np.float32)).to(cuda, torch.bfloat16)

        def run(fn):
            weight = w0.to(cuda).requires_grad_()
            y, *rest = fn(weight)
            y.backward(g)
            return y.detach(), weight.grad, [t.detach() for t in rest]

        y, gw, _ = run(lambda w: (cheb_conv(op, x, w),))
        ref, ref_gw, (bound,) = run(
            lambda w: _widened_cheb_conv(op, x, w, abs_l))
        torch.cuda.synchronize()
        assert y.dtype == ref.dtype == torch.bfloat16
        gap = (y.float() - ref.float()).abs()
        assert bool((gap <= bound).all()), float((gap / bound).max())
        gw_gap = float((gw - ref_gw).norm() / ref_gw.norm())
        assert gw_gap <= 1e-3
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        _, gw_reduced, _ = run(lambda w: (cheb_conv(op, x, w),))
        reduced_gap = float((gw_reduced - ref_gw).norm() / ref_gw.norm())
        print(f"{fin}->{fout}: outputs apart {int((gap > 0).sum())} of "
              f"{gap.numel()}, worst {float((gap / bound).max()):.3g} of the "
              f"bound; weight gradient {gw_gap:.3g} (norm), with bf16 "
              f"reductions allowed {reduced_gap:.3g}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            flag)
