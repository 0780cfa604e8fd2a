"""The probe that tells the plain-BCSR kernel's two regimes of fp32 A
against bf16 x apart (`tests/torch_split_probe.py`), on the CPU.

K4's function (the JAX package's interpreter kernel `_spmm_kernel`, which
widens both operands to fp32) keeps fp32 A; `round_a=True` (K3's compiled
regime) rounds A to bf16 first. On the probe's product, whose exact output
is about 0, the JAX interpreter and the port's plain version of K4 must read
under `SPLIT_BAR`, and the plain version with A rounded above it, so that
the card's hi + lo split is held to the one and its hi pass to the other.
HEALPix-8 (k 8) and HEALPix-16 (the flagship's knn-20); the JAX side runs
its Pallas operator in interpret mode, as its own tests do."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    _bcsr_matmul,
    bcsr_from_scipy as jbcsr_from_scipy,
)

from deepsphere_weather_torch.models.geometry import cached_graph_laplacian  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    bcsr_spmm,
    bcsr_spmm_reference,
    bcsr_spmm_rows_reference,
    plain_nonzero_slots,
)
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402
from torch_split_probe import SPLIT_BAR, split_probe  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WIDTH = 128


@pytest.fixture(scope="module", params=["hp8", "hp16"])
def lap(request):
    if request.param == "hp16":
        return cached_graph_laplacian(
            "healpix", {"subdivisions": 16, "nest": True}, 20, "knn")[1]
    return build_graph("healpix", {"subdivisions": 8, "nest": True},
                       k=8).L.tocsr()


def _probe(lap):
    A, x_np, reading = split_probe(lap, WIDTH, 5)
    op = BlockSparseOperator.from_scipy(A, rows_per_super=0, device="cpu")
    x = torch.nn.functional.pad(torch.from_numpy(x_np),
                                (0, 0, 0, op.rows - A.shape[0]))
    return A, x_np, reading, op, x.bfloat16()


def test_probe_cancels_on_the_laplacian_pattern(lap):
    A, x_np, reading, op, x = _probe(lap)
    # the same block pattern as L, so the kernel walks the same slots
    L_op = BlockSparseOperator.from_scipy(lap, rows_per_super=0, device="cpu")
    assert torch.equal(op.nz, L_op.nz) and torch.equal(op.cols, L_op.cols)
    assert torch.equal(op.nz, plain_nonzero_slots(op.vals))
    # x is exact in bf16, and A x cancels to fp32 A's own storage error
    assert torch.equal(x[:A.shape[0]].float(), torch.from_numpy(x_np))
    assert reading(np.zeros_like(x_np)) < 2.0 ** -20


def test_probe_tells_fp32_a_from_a_rounded(lap):
    A, x_np, reading, op, x = _probe(lap)
    vals, cols, _ = jbcsr_from_scipy(A)
    yj = _bcsr_matmul(jnp.asarray(vals), jnp.asarray(cols),
                      jnp.asarray(x.float().numpy(), jnp.bfloat16),
                      m_tile=WIDTH, interpret=True)
    assert reading(np.asarray(yj, np.float32)) < SPLIT_BAR
    a, idx, nz = op.vals, op.cols, op.nz
    got = {}
    for round_a in (False, True):
        y = bcsr_spmm_reference(a, idx, x, nz, round_a=round_a)
        assert y.dtype == torch.bfloat16
        # the CPU wrappers and the row range run the same plain version
        assert torch.equal(bcsr_spmm(a, idx, x, nz, round_a=round_a), y)
        assert torch.equal(bcsr_spmm_rows_reference(
            a, idx, x, 1, a.shape[0], nz, round_a=round_a), y[128:])
        got[round_a] = reading(y.float().numpy())
    assert got[False] < SPLIT_BAR < got[True], got
