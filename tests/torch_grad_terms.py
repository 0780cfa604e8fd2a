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


def cancelling_norm_biases(model):
    """{bias name: scale name} for each norm bias of `model` whose output
    reaches the next ConvBlock's BatchNorm through no activation (the
    graph convolution between them maps a per-channel constant to one):
    the next norm removes any per-channel constant the bias adds, so its
    gradient cancels to a remainder about a thousandth of its block's, of
    which rounding makes a large share. Compare it against the gradient of
    its block's norm scale (the name given). A bias with a ReLU on the way
    (norm before this block's activation, or the next block's activation
    before its norm) does not cancel and is held at its own scale."""
    out = {}
    for name in getattr(model, "BLOCKS", ()):
        res = getattr(model, name)
        if not isinstance(res, ResBlock):
            continue
        for i in range(1, res.n_blocks):
            blk = getattr(res, f"convblock{i}")
            nxt = getattr(res, f"convblock{i + 1}")
            if blk.norm_kind != "batch" or nxt.norm_kind != "batch":
                continue
            act_after = blk.act and blk.norm_before_act
            act_before = nxt.act and not nxt.norm_before_act
            if not (act_after or act_before):
                key = f"{name}.convblock{i}.norm_bias"
                out[key] = key.replace("norm_bias", "norm_scale")
    return out
