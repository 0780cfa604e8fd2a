"""Architectures and their build-time geometry."""

from .geometry import ModelGeometry, build_model_geometry  # noqa: F401
from .layers import ConvBlock, ResBlock, get_activation  # noqa: F401
from .unet import UNetSpherical  # noqa: F401
