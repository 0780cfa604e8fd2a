"""A product that tells fp32 A split into bf16 hi + lo from A rounded to bf16.

Against bf16 x, the plain-BCSR kernel's `round_a=False` regime (K4's
function) multiplies fp32 A as two bf16 passes, hi = bf16(a) and
lo = bf16(a - hi); `round_a=True` multiplies hi alone. Held against a plain
version at the bf16 bar the two look alike: the bf16 output rounding (2^-9
of |y|) is as large as hi's own error (2^-9 of |a|). This probe cancels the
output instead. A's diagonal is moved so that A x0 = 0 for a row-varying
x0 that bf16 holds exactly, and each column of x is x0 times a signed power
of two, so the exact product is only what A's fp32 storage leaves. The
reading max |y - A x| / max (|A| |x|) (fp64, over A's rows) is then about
2^-10 with hi alone and about 2^-18 with hi + lo: `SPLIT_BAR` lies between.
Used by the card tests and by chip_smoke.py (a helper module, not a test)."""

import numpy as np
from scipy import sparse

SPLIT_BAR = 2.0 ** -14


def split_probe(L, width, seed):
    """(A, x, reading): A fp32 CSR, L with its diagonal moved so that A x = 0
    in exact arithmetic (the sums in fp64); x [n, width] float32, exact in
    bf16; reading(y) gives max |y - A x| / max (|A| |x|) for a product y
    with at least A's rows (padding rows beyond them are ignored)."""
    rng = np.random.default_rng(seed)
    n = L.shape[0]
    x0 = 1.0 + rng.integers(0, 8, n) / 8.0             # 1 .. 1.875
    scale = rng.choice([-1.0, 1.0], width) * 2.0 ** rng.integers(-2, 3, width)
    L64 = sparse.csr_matrix(L, dtype=np.float64)
    A = (L64 - sparse.diags(L64 @ x0 / x0)).tocsr().astype(np.float32)
    x = (x0[:, None] * scale[None, :]).astype(np.float32)
    A64, x64 = A.astype(np.float64), x.astype(np.float64)
    exact = A64 @ x64
    magnitude = float((abs(A64) @ abs(x64)).max())

    def reading(y):
        y = np.asarray(y, np.float64)[:n]
        return float(np.abs(y - exact).max() / magnitude)

    return A, x, reading
