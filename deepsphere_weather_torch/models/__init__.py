"""Architectures and their build-time geometry."""

from .geometry import (  # noqa: F401
    ModelGeometry,
    build_model_geometry,
    shard_geometry,
)
from .layers import (  # noqa: F401
    ConvBlock,
    ResBlock,
    block_has_batch_norm,
    get_activation,
)
from .members import MemberStack  # noqa: F401
from .unet import SphericalModel, UNetSpherical  # noqa: F401
from .variants import (  # noqa: F401
    ConvNetSpherical,
    DownscalingNetSpherical,
    EPDNetSpherical,
    ResNetSpherical,
)

ARCHITECTURES = {
    "UNetSpherical": UNetSpherical,
    "ResNetSpherical": ResNetSpherical,
    "EPDNetSpherical": EPDNetSpherical,
    "ConvNetSpherical": ConvNetSpherical,
    "DownscalingNetSpherical": DownscalingNetSpherical,
}


def get_model(architecture_name: str, tensor_info, **model_kwargs):
    """Instantiate an architecture by name (the JAX package's `get_model`;
    reference get_pytorch_model, modules/utils_config.py:349-372). A
    constructor with `**kwargs` (the variants) sees every setting and
    ignores those it does not use; any other gets the settings it names."""
    import inspect

    if architecture_name not in ARCHITECTURES:
        raise ValueError(
            f"unknown architecture {architecture_name!r}; "
            f"available: {sorted(ARCHITECTURES)}")
    cls = ARCHITECTURES[architecture_name]
    sig = inspect.signature(cls.__init__)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        accepted = dict(model_kwargs)
    else:
        accepted = {k: v for k, v in model_kwargs.items()
                    if k in sig.parameters}
    return cls(tensor_info=tensor_info, **accepted)
