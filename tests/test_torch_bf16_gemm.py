"""The channel mixes' operand types: a bf16 model contracts bf16 operands
(the tensor cores' GEMM on the card, fp32 accumulation), an fp32 model
fp32 operands, and both launch the same GEMMs.

One forward and backward of a small UNetSpherical whose every level is
block-sparse, so that every `cheb_conv` runs a node-major branch (the
Clenshaw form where a block narrows, the stacked basis where it widens),
beside the ResBlock projections. A `TorchDispatchMode` records each
`aten.mm`/`bmm`/`addmm`/`baddbmm` it sees: the registered SpMM ops reach
it as one op each, so the GEMMs recorded are the model's own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402

GEMMS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm}
# HEALPix-8: 768 / 192 / 48 nodes; a dense threshold under the smallest
# level keeps every level block-sparse
SUBDIV, V, DENSE_THRESHOLD = 8, 768, 47
# the GEMMs of one forward and backward, as many as the fp32-widened form
# launched: 11 cheb_conv forwards (one each) and 21 of their backward (the
# weight's gradient each, the input's but at the first conv), 5 ResBlock
# projections and 9 of their backward (no input gradient at conv1's)
N_GEMMS = 46


class _Gemms(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in GEMMS:
            self.seen.append(tuple((t.dtype, tuple(t.shape)) for t in args
                                   if isinstance(t, torch.Tensor)))
        return func(*args, **(kwargs or {}))


def _gemms(precision):
    info = {"input_n_feature": 5, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}
    model = UNetSpherical(
        info, "healpix", {"subdivisions": SUBDIV, "nest": True}, knn=8,
        increment_learning=True, numeric_precision=precision,
        dense_threshold=DENSE_THRESHOLD, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert all(op.dense is None for op in model.geometry.cheb_ops)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, V, 5)).astype(np.float32))
    with _Gemms() as mode:
        model(x).square().sum().backward()
    return mode.seen


@pytest.mark.parametrize("precision,dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32)])
def test_channel_mixes_contract_in_the_compute_dtype(precision, dtype):
    seen = _gemms(precision)
    assert len(seen) == N_GEMMS
    assert {dt for operands in seen for dt, _ in operands} == {dtype}
