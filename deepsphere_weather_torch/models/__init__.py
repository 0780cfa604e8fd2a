"""Architectures and their build-time geometry."""

from .geometry import (  # noqa: F401
    ModelGeometry,
    build_model_geometry,
    shard_geometry,
)
from .layers import ConvBlock, ResBlock, get_activation  # noqa: F401
from .unet import UNetSpherical  # noqa: F401
