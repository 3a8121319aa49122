from .contrastive import (
    asymmetric_loss,
    bce_with_logits_loss,
    clip_self_distill_loss,
    focal_loss,
    info_nce_loss,
    multilabel_contrastive_loss,
    siglip_loss,
    soft_cross_entropy,
)
from .global_batch import (
    global_clip_self_distill_loss,
    global_info_nce_loss,
    global_multilabel_contrastive_loss,
    global_siglip_loss,
    local_clip_self_distill_loss,
    local_info_nce_loss,
    make_global,
    ring_siglip_loss,
)

__all__ = [
    "asymmetric_loss",
    "bce_with_logits_loss",
    "clip_self_distill_loss",
    "focal_loss",
    "global_clip_self_distill_loss",
    "global_info_nce_loss",
    "global_multilabel_contrastive_loss",
    "global_siglip_loss",
    "local_clip_self_distill_loss",
    "local_info_nce_loss",
    "make_global",
    "ring_siglip_loss",
    "info_nce_loss",
    "multilabel_contrastive_loss",
    "siglip_loss",
    "soft_cross_entropy",
]
