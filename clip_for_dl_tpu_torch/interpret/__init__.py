from .attention_viz import save_attention_weights
from .gradcam import gradcam, jet_colormap, overlay_cam, upsample_cam
from .rollout import attention_rollout, fuse_heads, vit_rollout

__all__ = [
    "save_attention_weights",
    "gradcam",
    "jet_colormap",
    "overlay_cam",
    "upsample_cam",
    "attention_rollout",
    "fuse_heads",
    "vit_rollout",
]
