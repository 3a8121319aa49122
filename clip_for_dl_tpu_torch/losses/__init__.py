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

__all__ = [
    "asymmetric_loss",
    "bce_with_logits_loss",
    "clip_self_distill_loss",
    "focal_loss",
    "info_nce_loss",
    "multilabel_contrastive_loss",
    "siglip_loss",
    "soft_cross_entropy",
]
