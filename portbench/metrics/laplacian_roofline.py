"""laplacian_roofline.<kind>: the least time of the Laplacian products the
profiled units needed (`counts.laplacian_least_s` of the operator,
whatever the kernel's layout) over the device time of the operations
launched under the ops deepsphere_weather_torch::spmm*, in %.

The products counted are those of the levels whose products the spmm ops
ran: the one set of levels whose count of products a unit equals the
ops' calls a unit. No such set, no reading."""

from itertools import combinations

PREFIX = "deepsphere_weather_torch::spmm"


def read(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    ops = r.trace.under(lambda n: n.startswith(PREFIX))
    calls = r.trace.op_count(lambda n: n.startswith(PREFIX))
    if not ops or calls % r.stretch_units:
        return None
    levels = range(r.levels)
    sets = [list(c) for k in range(1, r.levels + 1)
            for c in combinations(levels, k)
            if r.laplacian_products(list(c)) * r.stretch_units == calls]
    if len(sets) != 1:
        return None
    least = r.laplacian_least_s(sets[0]) * r.stretch_units
    return 100.0 * least / r.trace.seconds_of(ops)
