"""ViT attention rollout from the tower's per-layer attention probabilities
(counterpart of ``clip_for_dl_tpu.interpret.rollout``).

The ViT tower returns its layers' softmax probabilities with
``sow_weights=True`` (models/vit.py); heads are fused (mean, max or min),
and the rollout folds R ← ((A_l + I) / rowsum) · R from layer 0 upward and
reads the CLS → patch row as a g × g saliency mask, divided by its maximum
(vit nb cell 34 AttentionRollout).

``discard_ratio`` does what the JAX function's comment says it does
(rollout.py:48, "zero the k smallest entries per row, never the CLS
column"): k = int((N − 1) · ratio) entries of each row are zeroed, taken
from columns 1..N−1 by a stable ascending sort, so ties fall by column
index. The JAX function builds its threshold row with the wrong width and
raises ``TypeError`` for any k ≥ 1 (ROADMAP C9); the port does not copy
that.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def fuse_heads(attn: torch.Tensor, head_fusion: str = "mean") -> torch.Tensor:
    """[.., H, N, N] → [.., N, N]."""
    if head_fusion == "mean":
        return attn.mean(dim=-3)
    if head_fusion == "max":
        return attn.amax(dim=-3)
    if head_fusion == "min":
        return attn.amin(dim=-3)
    raise ValueError(f"unknown head fusion {head_fusion!r}")


def discard_lowest(fused: torch.Tensor, discard_ratio: float) -> torch.Tensor:
    """Zero the k = int((N − 1) · ratio) smallest entries of each row of
    ``fused`` [.., N, N] among columns 1..N−1 (stable: ties by column)."""
    n = fused.shape[-1]
    k = int((n - 1) * discard_ratio)
    if k <= 0:
        return fused
    order = torch.sort(fused[..., 1:], dim=-1, stable=True).indices[..., :k] + 1
    return fused.scatter(-1, order, 0.0)


def attention_rollout(
    attentions: Sequence[torch.Tensor],
    head_fusion: str = "mean",
    discard_ratio: float = 0.0,
) -> torch.Tensor:
    """Per-layer attention [B, H, N, N] list → CLS→patch mask [B, g, g] fp32."""
    stacked = torch.stack([fuse_heads(a.float(), head_fusion) for a in attentions])
    stacked = discard_lowest(stacked, discard_ratio)  # [L, B, N, N]
    _, b, n, _ = stacked.shape
    eye = torch.eye(n, device=stacked.device)
    aug = stacked + eye
    aug = aug / aug.sum(dim=-1, keepdim=True)
    rollout = eye.expand(b, n, n)
    for layer in aug:
        rollout = torch.bmm(layer, rollout)
    g = math.isqrt(n - 1)
    mask = rollout[:, 0, 1:].reshape(b, g, g)
    mx = mask.amax(dim=(1, 2), keepdim=True)
    return mask / torch.clamp(mx, min=1e-8)


@torch.no_grad()
def vit_rollout(model, images: torch.Tensor, head_fusion: str = "mean",
                discard_ratio: float = 0.0) -> torch.Tensor:
    """Run the ViT tower (``models.vit.ViT``) with its attention
    probabilities and fold the rollout."""
    _, attns = model(images, sow_weights=True)
    return attention_rollout(attns, head_fusion, discard_ratio)
