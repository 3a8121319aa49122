"""Contrastive losses (counterpart of ``clip_for_dl_tpu.losses.contrastive``).

Ported so far: the ``pretrain_clip`` and ``adapter`` presets' losses. Every
reduction runs in fp32 whatever the input dtype, as in the JAX package.

- ``soft_cross_entropy``      0425/train.py:117-124
- ``clip_self_distill_loss``  0425/train.py:126-151 (notebook T=2 variant)
- ``bce_with_logits_loss``    the adapter's BCE (02 nb cell 29)
"""

from __future__ import annotations

import torch


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                       reduction: str = "none") -> torch.Tensor:
    """CE against soft target rows: (-targets * log_softmax(logits)).sum(-1)."""
    logits, targets = logits.float(), targets.float()
    loss = -(targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    return loss.mean() if reduction == "mean" else loss


def clip_self_distill_loss(
    text_features: torch.Tensor,
    image_features: torch.Tensor,
    temperature: float = 2.0,
    mode: str = "train",
) -> torch.Tensor:
    """CLIP loss with self-distillation targets on the raw (not normalized)
    features: targets = softmax((img·imgᵀ + txt·txtᵀ)/2 · T); symmetric
    soft-CE on (txt·imgᵀ)/T. ``mode="eval"`` returns the logits."""
    txt, img = text_features.float(), image_features.float()
    logits = (txt @ img.T) / temperature
    if mode == "eval":
        return logits
    img_sim = img @ img.T
    txt_sim = txt @ txt.T
    targets = torch.softmax((img_sim + txt_sim) / 2.0 * temperature, dim=-1)
    texts_loss = soft_cross_entropy(logits, targets)
    images_loss = soft_cross_entropy(logits.T, targets.T)
    return ((texts_loss + images_loss) / 2.0).mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         reduction: str = "mean") -> torch.Tensor:
    """torch BCEWithLogitsLoss semantics in fp32 with the JAX package's safe
    form: max(x, 0) − x·t + log1p(exp(−|x|))."""
    logits, targets = logits.float(), targets.float()
    loss = torch.clamp_min(logits, 0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
