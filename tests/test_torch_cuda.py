"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. This file imports neither JAX nor the JAX package, so it also runs on
a card machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: `tests/conftest.py` sets JAX up.) Tolerance: max abs error
/ max abs of the plain version, fp32 1e-5, bf16 1e-2 (summation order and
one bf16 output rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    launch_counts,
)
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402

pytestmark = pytest.mark.cuda

DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 1e-2}


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
