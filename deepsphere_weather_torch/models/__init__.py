"""Architectures and their build-time geometry."""

from .geometry import (  # noqa: F401
    ModelGeometry,
    build_model_geometry,
    shard_geometry,
)
from .layers import ConvBlock, ResBlock, get_activation  # noqa: F401
from .unet import UNetSpherical  # noqa: F401

# the JAX package's architectures (`deepsphere_weather_tpu/models`); only
# UNetSpherical is ported
_NOT_PORTED = ("ResNetSpherical", "EPDNetSpherical", "ConvNetSpherical",
               "DownscalingNetSpherical")


def get_model(architecture_name: str, tensor_info, **model_kwargs):
    """Instantiate an architecture by name, dropping the settings its
    constructor does not take (the JAX package's `get_model`; reference
    get_pytorch_model, modules/utils_config.py:349-372)."""
    import inspect

    if architecture_name in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {architecture_name!r} is not ported yet (ROADMAP "
            "Queue 1 item 7); the port builds UNetSpherical")
    if architecture_name != "UNetSpherical":
        raise ValueError(f"unknown architecture {architecture_name!r}")
    sig = inspect.signature(UNetSpherical.__init__)
    accepted = {k: v for k, v in model_kwargs.items() if k in sig.parameters}
    return UNetSpherical(tensor_info=tensor_info, **accepted)
