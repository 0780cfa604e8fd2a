"""The scale of a one-element gradient in the port's UNetSpherical.

A ReZero weight or the increment scale w multiplies a whole tensor z, so
its gradient dL/dw = sum_i z_i g_i is one sum whose terms cancel: its
rounding error is a fraction of sum_i |z_i g_i|, not of |dL/dw|. Tests
hold such a gradient against that sum (a helper module, not a test)."""

from deepsphere_weather_torch.models import ResBlock


def term_sums(model):
    """{parameter name: sum_i |z_i g_i|} for each one-element parameter w
    of `model` whose gradient is dL/dw = sum_i z_i g_i, w scaling z: the
    ReZero weights (z the branch of their block) and the increment scale
    (z the network's output). Filled in by the backward, from
    dL/dz = w g."""
    sums = {}

    def watch(module, key, w):
        def hook(_, __, z):
            if z.requires_grad:
                wz = float(w.detach().to(z.dtype))
                assert wz != 0.0, f"{key} is 0: no terms to sum"
                z.register_hook(lambda gz: sums.__setitem__(key, sums.get(
                    key, 0.0) + float((z.detach().double() * gz.double())
                                      .abs().sum()) / abs(wz)))
        module.register_forward_hook(hook)

    for name, blk in model.named_children():
        if isinstance(blk, ResBlock):
            watch(blk.get_submodule(f"convblock{blk.n_blocks}"),
                  f"{name}.rezero_weight", blk.rezero_weight)
    if getattr(model, "increment_learning", False):
        watch(model.uconv1_final, "res_increment", model.res_increment)
    return sums
