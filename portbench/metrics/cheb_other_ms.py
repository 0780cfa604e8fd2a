"""cheb_other_ms.<kind>: device ms a step (training) or a lead (forecasts)
of the operations tied to the span `dsw.cheb_conv`, forward and backward
(`portbench.spans`), less those launched under aten::mm, addmm, bmm or
baddbmm or the ops deepsphere_weather_torch::spmm*: the Chebyshev
convolution's work besides its products (the Clenshaw recurrence's
elementwise work, its zero-filled gradients, the fp32 widening casts and
the node-major layout copies)."""

from portbench import spans


def _product(name):
    return name in spans.GEMM or name.startswith(spans.SPMM)


def read(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    products = {id(e) for e in r.trace.under(_product)}
    return spans.ms_per_time(
        r, kind,
        lambda d, t: t.under("dsw.cheb_conv") and id(d) not in products)
