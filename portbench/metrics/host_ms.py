"""host_ms.<kind>: the median host time of one unit's call, from call to
return with no synchronisation (the enqueue, any wait the call makes on
the device and, for a forecast, its copy to the host), in ms a step
(training) or a lead (forecasts)."""

import statistics


def read(r, kind):
    if r.kind != kind or not r.spans:
        return None
    return 1e3 * statistics.median(r.spans) / r.per_time
