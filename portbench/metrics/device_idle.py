"""device_idle.<kind>: the share of the profiled stretch of the kind's
units in which no operation ran on the device (1 - the union of the
device operations' intervals over the stretch), in %."""


def read(r, kind):
    if r.kind != kind or r.trace is None or r.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_seconds() / r.trace.seconds)
