from .contrastive import clip_self_distill_loss, soft_cross_entropy

__all__ = ["clip_self_distill_loss", "soft_cross_entropy"]
