"""train_mfu: the model operations of the window's training steps
(`counts.forward_flops`, a backward twice its forward) over the window's
time, as a share of the configuration's peak, in %."""


def read(r):
    if r.kind != "train" or r.units == 0:
        return None
    return 100.0 * r.unit_flops * r.units / r.seconds / r.peak_flops
