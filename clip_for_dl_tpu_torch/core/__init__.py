from .config import (
    CLIP_MEAN,
    CLIP_STD,
    DISEASE_LABELS,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ModelConfig,
    ZeroShotConfig,
    get_preset,
)
from .device import cast_in_forward, cast_matmul_weights, require_cuda, resolve_device

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "DISEASE_LABELS",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ModelConfig",
    "ZeroShotConfig",
    "get_preset",
    "cast_in_forward",
    "cast_matmul_weights",
    "require_cuda",
    "resolve_device",
]
