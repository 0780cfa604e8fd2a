"""forecast_mfu: the model operations of the window's forecasts (one
forward a lead step) over the window's time, as a share of the
configuration's peak, in %."""


def read(r):
    if r.kind != "forecast" or r.units == 0:
        return None
    return 100.0 * r.unit_flops * r.units / r.seconds / r.peak_flops
