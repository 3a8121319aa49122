"""Contrastive and classification losses (counterpart of
``clip_for_dl_tpu.losses.contrastive``). Every reduction runs in fp32
whatever the input dtype, as in the JAX package.

- ``soft_cross_entropy``          0425/train.py:117-124
- ``clip_self_distill_loss``      0425/train.py:126-151 (notebook T=2 variant)
- ``info_nce_loss``               0425/train.py:153-175
- ``siglip_loss``                 SigLIP's pairwise sigmoid loss
- ``multilabel_contrastive_loss`` 0425/train.py:177-229 (clamp ±50, eps 1e-8)
- ``asymmetric_loss``             multimodal_attention/train.py:233-268
- ``bce_with_logits_loss``        the adapter's BCE (02 nb cell 29)
- ``focal_loss``                  02 nb cell 33 (γ=2, α=0.25)
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..ops.similarity import l2_normalize

Scalar = Union[float, torch.Tensor]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                       reduction: str = "none") -> torch.Tensor:
    """CE against soft target rows: (-targets * log_softmax(logits)).sum(-1)."""
    logits, targets = logits.float(), targets.float()
    loss = -(targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    return loss.mean() if reduction == "mean" else loss


def clip_self_distill_loss(
    text_features: torch.Tensor,
    image_features: torch.Tensor,
    temperature: Scalar = 2.0,
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


def info_nce_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    temperature: Scalar = 1.0,
    labels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Symmetric InfoNCE on the raw features, arange labels by default."""
    img, txt = image_features.float(), text_features.float()
    logits = (img @ txt.T) / temperature
    if labels is None:
        labels = torch.arange(logits.shape[0], device=logits.device)
    one_hot = F.one_hot(labels, logits.shape[1]).float()
    loss_i = soft_cross_entropy(logits, one_hot).mean()
    loss_t = soft_cross_entropy(logits.T, one_hot.T).mean()
    return (loss_i + loss_t) / 2.0


def siglip_loss(
    text_features: torch.Tensor,
    image_features: torch.Tensor,
    logit_scale: Scalar = 10.0,
    logit_bias: Scalar = -10.0,
) -> torch.Tensor:
    """SigLIP (Zhai et al. 2023): ``1/B · Σᵢⱼ softplus(-zᵢⱼ (s·xᵢ·yⱼ + b))``
    with z = +1 on the diagonal and -1 off it, on L2-normalized features;
    the paper's init s = 10, b = -10 by default."""
    txt = l2_normalize(text_features.float())
    img = l2_normalize(image_features.float())
    logits = img @ txt.T * logit_scale + logit_bias
    n = logits.shape[0]
    z = 2.0 * torch.eye(n, device=logits.device) - 1.0
    return F.softplus(-z * logits).sum() / n


def multilabel_contrastive_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    temperature: Scalar = 1.0,
    eps: float = 1e-8,
    clamp: float = 50.0,
) -> torch.Tensor:
    """Sigmoid multi-label contrastive: both sides L2-normalized, sims/T
    clamped to ±clamp, positive and negative log-probability sums normalized
    by the label counts. ``log(p + eps)`` as the reference computes it, not
    log-sigmoid, so the values agree at the clamp too."""
    img = l2_normalize(image_features.float())
    txt = l2_normalize(text_features.float())
    labels = labels.float()
    sims = torch.clamp((img @ txt.T) / temperature, -clamp, clamp)
    p = torch.sigmoid(sims)
    pos = -(torch.log(p + eps) * labels).sum() / (labels.sum() + eps)
    neg = -(torch.log(1.0 - p + eps) * (1.0 - labels)).sum() / ((1.0 - labels).sum() + eps)
    return (pos + neg) / 2.0


def asymmetric_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma_pos: float = 0.0,
    gamma_neg: float = 4.0,
    clip: float = 0.05,
    eps: float = 1e-8,
    reduction: str = "mean",
) -> torch.Tensor:
    """ASL for multi-label: shifted negative probabilities and asymmetric
    focusing (down-weights easy negatives)."""
    logits, targets = logits.float(), targets.float()
    probs = torch.sigmoid(logits)
    probs_neg = 1.0 - probs
    if clip and clip > 0:
        probs_neg = torch.clamp_max(probs_neg + clip, 1.0)
    pos = targets * torch.log(torch.clamp_min(probs, eps))
    neg = (1.0 - targets) * torch.log(torch.clamp_min(probs_neg, eps))
    if gamma_pos > 0:
        pos = pos * (1.0 - probs) ** gamma_pos
    if gamma_neg > 0:
        neg = neg * probs ** gamma_neg
    return _reduce(-(pos + neg), reduction)


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         reduction: str = "mean") -> torch.Tensor:
    """torch BCEWithLogitsLoss semantics in fp32 with the JAX package's safe
    form: max(x, 0) − x·t + log1p(exp(−|x|))."""
    logits, targets = logits.float(), targets.float()
    loss = torch.clamp_min(logits, 0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    return _reduce(loss, reduction)


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: float = 0.25,
    reduction: str = "mean",
) -> torch.Tensor:
    """Binary focal loss on sigmoid probabilities."""
    logits, targets = logits.float(), targets.float()
    p = torch.sigmoid(logits)
    ce = bce_with_logits_loss(logits, targets, reduction="none")
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return _reduce(alpha_t * (1.0 - p_t) ** gamma * ce, reduction)
