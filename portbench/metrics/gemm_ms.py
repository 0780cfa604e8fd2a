"""gemm_ms.<kind>: device ms a step (training) or a lead (forecasts) of
the operations launched under aten::mm, addmm, bmm or baddbmm (the
channel mixes, projections and dense products), tied to them by the
trace's launch correlation."""

GEMM = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"}


def read(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    ops = r.trace.under(GEMM.__contains__)
    if not ops:
        return None
    return 1e3 * r.trace.seconds_of(ops) / (r.stretch_units * r.per_time)
