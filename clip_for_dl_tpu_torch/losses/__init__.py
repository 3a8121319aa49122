from .contrastive import bce_with_logits_loss, clip_self_distill_loss, soft_cross_entropy

__all__ = ["bce_with_logits_loss", "clip_self_distill_loss", "soft_cross_entropy"]
