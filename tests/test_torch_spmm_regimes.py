"""The block layouts' regimes on the CPU: which kernel body a CUDA launch
runs for each A/x dtype pair (`spmm_regime`) and the widths it takes
(`spmm_col_tile`), the wrappers' argument checks for every pair, and the
plain versions of every regime against the JAX package's kernels on the
same layout arrays: `_bcsr_super_matmul` (K1 over the whole layout with
its slot schedule, K2 over a range of super-rows) and `_bcsr_matmul` (K3,
whole and a row slice, the compiled path). The JAX side runs its Pallas
kernels in interpret mode on the CPU: `pl.pallas_call` is given
`interpret=True` for the test, as the JAX package's interpreter tests run
its kernels. Its precision is the one its operator picks (HIGHEST for
fp32 x, the default for bf16 x, which rounds fp32 A to bf16).

Tolerance: max abs error / max abs of the JAX result, 1e-5 for every
regime (fp32 x: summation order only; bf16 x: the same fp32 sums rounded
once to bf16, equal here).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops import pallas_spmm as jps  # noqa: E402
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.ops import (  # noqa: E402
    bcsr_spmm,
    bcsr_spmm_reference,
    bcsr_spmm_rows,
    bcsr_spmm_rows_reference,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    bcsr_super_spmm_rows,
    bcsr_super_spmm_rows_reference,
    launch_counts,
    plain_nonzero_slots,
    spmm_col_tile,
    spmm_regime,
    super_nonzero_slots,
)

T = {"fp32": torch.float32, "bf16": torch.bfloat16}
J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
PAIRS = [("fp32", "fp32"), ("bf16", "fp32"), ("fp32", "bf16"),
         ("bf16", "bf16")]
TOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=[4, 8], ids=["hp4", "hp8"])
def layouts(request):
    """The JAX package's super-row (R = 4) and plain layouts of HEALPix-n's
    knn-8 Laplacian, its slot schedule, and an x over the layouts' rows."""
    g = jbuild_graph("healpix", {"subdivisions": request.param,
                                 "nest": True}, k=8)
    svals, _use, _wait, ucols, _count, sched, n_pad = \
        jps.bcsr_super_from_scipy(g.L)
    vals, cols, _ = jps.bcsr_from_scipy(g.L)
    rows = svals.shape[0] * svals.shape[1] * svals.shape[2]
    x = np.random.default_rng(request.param).standard_normal(
        (rows, 256)).astype(np.float32)
    return {"svals": svals, "ucols": ucols, "sched": sched, "vals": vals,
            "cols": cols, "n_pad": n_pad, "x": x}


@pytest.fixture
def interpret(monkeypatch):
    """The JAX kernels' pallas_call in interpret mode (the CPU has no TPU)."""
    monkeypatch.setattr(jps.pl, "pallas_call",
                        functools.partial(jps.pl.pallas_call, interpret=True))


def _precision(x_dt):
    # the JAX operator's choice (`BlockSparseOperator.matvec`)
    return (jax.lax.Precision.HIGHEST if x_dt == "fp32"
            else jax.lax.Precision.DEFAULT)


# (a_dt, x_dt, super layout, round_a) -> body
REGIMES = [
    ("fp32", "fp32", True, True, "gather"),
    ("bf16", "fp32", True, True, "gather"),
    ("fp32", "bf16", True, True, "tensor cores, A rounded"),
    ("bf16", "bf16", True, True, "tensor cores"),
    ("fp32", "fp32", False, True, "gather"),
    ("bf16", "fp32", False, True, "gather"),
    ("fp32", "fp32", False, False, "gather"),
    ("fp32", "bf16", False, True, "tensor cores, A rounded"),
    ("fp32", "bf16", False, False, "tensor cores, A split"),
    ("bf16", "bf16", False, True, "tensor cores"),
]


@pytest.mark.parametrize("a_dt,x_dt,super_layout,round_a,body", REGIMES)
def test_regime_and_column_tile_by_operand_types(layouts, a_dt, x_dt,
                                                 super_layout, round_a, body):
    assert spmm_regime(T[a_dt], T[x_dt], super_layout, round_a) == body
    # the widths a launch takes: the tensor-core bodies 256/128/64 by M,
    # at most 128 with fp32 A; the gather body 64
    want = {64: 64, 128: 128, 192: 64, 256: 256, 320: 64, 384: 128,
            2048: 256, 96: 0, 100: 0}
    for M, tile in want.items():
        if body == "gather":
            tile = 64 if M % 64 == 0 else 0
        elif a_dt == "fp32":
            tile = min(tile, 128)
        assert spmm_col_tile(M, T[a_dt], T[x_dt]) == tile, M
    # on the CPU the wrapper runs the plain version: nothing is launched,
    # the output follows x
    if super_layout:
        a = torch.from_numpy(layouts["svals"]).to(T[a_dt])
        idx = torch.from_numpy(layouts["ucols"])
        nz = super_nonzero_slots(a)
        x = torch.from_numpy(layouts["x"]).to(T[x_dt])
        before = dict(launch_counts)
        y = bcsr_super_spmm(a, idx, x, nz)
        ref = bcsr_super_spmm_reference(a, idx, x, nz)
    else:
        a = torch.from_numpy(layouts["vals"]).to(T[a_dt])
        idx = torch.from_numpy(layouts["cols"])
        nz = plain_nonzero_slots(a)
        x = torch.from_numpy(layouts["x"][:layouts["n_pad"]]).to(T[x_dt])
        before = dict(launch_counts)
        y = bcsr_spmm(a, idx, x, nz, round_a=round_a)
        ref = bcsr_spmm_reference(a, idx, x, nz, round_a=round_a)
    assert launch_counts == before
    assert y.dtype == T[x_dt] and y.shape == (x.shape[0], 256)
    assert torch.equal(y, ref)


ENTRIES = ["bcsr_super_spmm", "bcsr_super_spmm_rows", "bcsr_spmm",
           "bcsr_spmm_rows"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("a_dt,x_dt", PAIRS)
def test_wrappers_reject_bad_arguments(layouts, entry, a_dt, x_dt):
    super_layout = "super" in entry
    a = torch.from_numpy(layouts["svals" if super_layout else "vals"]).to(
        T[a_dt])
    idx = torch.from_numpy(layouts["ucols" if super_layout else "cols"])
    rows = (a.shape[0] * a.shape[1] * a.shape[2] if super_layout
            else a.shape[0] * a.shape[2])
    x = torch.from_numpy(layouts["x"][:rows]).to(T[x_dt])
    fn = {"bcsr_super_spmm": bcsr_super_spmm,
          "bcsr_super_spmm_rows": bcsr_super_spmm_rows,
          "bcsr_spmm": bcsr_spmm, "bcsr_spmm_rows": bcsr_spmm_rows}[entry]
    ranged = entry.endswith("_rows")
    span = (0, a.shape[0]) if ranged else ()

    def call(a_, idx_, x_, *rng, nz=None):
        return fn(a_, idx_, x_, *(rng or span), nz=nz)

    before = dict(launch_counts)
    assert call(a, idx, x).dtype == T[x_dt]
    with pytest.raises(TypeError):                 # A neither fp32 nor bf16
        call(a.half(), idx, x)
    with pytest.raises(TypeError):                 # x neither
        call(a, idx, x.double())
    with pytest.raises(TypeError):                 # int64 block-columns
        call(a, idx.long(), x)
    with pytest.raises(ValueError):                # A of another shape
        call(a[..., :64], idx, x)
    bad_nz = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot list"):
        call(a, idx, x, nz=bad_nz)
    if ranged:
        n = a.shape[0]
        for b, e in ((-1, 1), (0, 0), (1, 0), (0, n + 1)):
            with pytest.raises(ValueError, match="range"):
                call(a, idx, x, b, e)
        with pytest.raises(ValueError, match="whole"):   # x not 128-row blocks
            call(a, idx, x[:-1])
    else:
        with pytest.raises(ValueError, match="rows"):    # x of another height
            call(a, idx, x[:-128])
    assert launch_counts == before


@pytest.mark.parametrize("a_dt,x_dt", PAIRS)
def test_super_plain_version_matches_jax_kernels(layouts, interpret, a_dt,
                                                 x_dt):
    sv, uc, x = layouts["svals"], layouts["ucols"], layouts["x"]
    a = torch.from_numpy(sv).to(T[a_dt])
    idx = torch.from_numpy(uc)
    nz = super_nonzero_slots(a)
    xt = torch.from_numpy(x).to(T[x_dt])
    ja, jx = jnp.asarray(sv, J[a_dt]), jnp.asarray(x, J[x_dt])
    # K1: the whole layout, the JAX kernel walking its slot schedule
    yj = jps._bcsr_super_matmul(ja, jnp.asarray(layouts["sched"]), jx, 128,
                                precision=_precision(x_dt), scheduled=True)
    y = bcsr_super_spmm_reference(a, idx, xt, nz)
    assert y.dtype == T[x_dt] and y.shape == yj.shape
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL
    # K2: a range of super-rows against the whole x (the JAX row slice of
    # `rowsharded_fn`)
    n_s = sv.shape[0]
    s0, s1 = n_s // 2, n_s
    yj = jps._bcsr_super_matmul(ja[s0:s1], jnp.asarray(uc[s0:s1]), jx, 128,
                                precision=_precision(x_dt), scheduled=False)
    y = bcsr_super_spmm_rows_reference(a, idx, xt, s0, s1, nz)
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL


@pytest.mark.parametrize("a_dt,x_dt", PAIRS)
def test_plain_layout_plain_version_matches_jax_kernel(layouts, interpret,
                                                       a_dt, x_dt):
    vals, cols = layouts["vals"], layouts["cols"]
    x = layouts["x"][:layouts["n_pad"]]
    a = torch.from_numpy(vals).to(T[a_dt])
    idx = torch.from_numpy(cols)
    nz = plain_nonzero_slots(a)
    xt = torch.from_numpy(x).to(T[x_dt])
    ja, jx = jnp.asarray(vals, J[a_dt]), jnp.asarray(x, J[x_dt])
    # K3, its compiled path (fp32 A rounded to bf16 against bf16 x)
    yj = jps._bcsr_matmul(ja, jnp.asarray(cols), jx, 128,
                          precision=_precision(x_dt))
    y = bcsr_spmm_reference(a, idx, xt, nz)
    assert y.dtype == T[x_dt] and y.shape == yj.shape
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL
    # its row slice against the whole x
    n_rb = vals.shape[0]
    r0, r1 = n_rb // 2, n_rb
    yj = jps._bcsr_matmul(ja[r0:r1], jnp.asarray(cols[r0:r1]), jx, 128,
                          precision=_precision(x_dt))
    y = bcsr_spmm_rows_reference(a, idx, xt, r0, r1, nz)
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL
