"""Projection heads, multi-view fusion and adapter classifiers.

Counterparts of ``clip_for_dl_tpu.models.heads``, with the reference's
state-dict names (``models/torch_export.py`` emits the same):

- ImageProjection / TextProjection: p = W1 x; LayerNorm(p + Dropout(W2 gelu(p)))
  (linear attribute ``image_projection`` / ``text_projection``, then ``fc``
  and ``layer_norm``; exact-erf GELU; LayerNorm in fp32, eps 1e-5)
- MultiViewFusion: concat(frontal, lateral) → Linear → ReLU → Dropout → Linear
  (``fusion.0`` and ``fusion.3``; dropout 0.2, fixed as in JAX)
- CAdapter: Linear(shared_dim → num_classes) (``classifier``)
- SharedEmbeddingAdapter: Linear(2·shared_dim → num_classes) over
  concat(image, text) (``classifier``)

Every head computes in the dtype of its weights. In train mode every
dropout of the port's models (the heads', the fusion's and BERT's) draws its
mask from the generator the step passes down (:func:`dropout`), as flax
draws each from the step's key; torch's global generator only when none is
given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dropout(layer: nn.Dropout, x: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``layer``'s dropout (its rate, in train mode only) on ``x``, the mask
    drawn from ``generator`` (torch's global generator when None): kept
    entries scaled by 1 / (1 − rate), the rest zero."""
    if not layer.training or layer.p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= layer.p
    return torch.where(keep, x / (1.0 - layer.p), torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


class ResidualProjection(nn.Module):
    proj_attr = "projection"

    def __init__(self, in_dim: int, out_dim: int = 512, dropout: float = 0.1):
        super().__init__()
        setattr(self, self.proj_attr, nn.Linear(in_dim, out_dim))
        self.fc = nn.Linear(out_dim, out_dim)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() > 2:
            x = x.flatten(1)  # pooled conv maps
        proj_layer = getattr(self, self.proj_attr)
        dt = proj_layer.weight.dtype
        proj = proj_layer(x.to(dt))
        h = dropout(self.dropout, self.fc(F.gelu(proj)), generator)
        return self.layer_norm((h + proj).float()).to(dt)


class ImageProjection(ResidualProjection):
    """Pooled tower features (2048-d for ResNet-50) → shared space."""

    proj_attr = "image_projection"


class TextProjection(ResidualProjection):
    """768-d BERT CLS features → shared space."""

    proj_attr = "text_projection"


class MultiViewFusion(nn.Module):
    def __init__(self, dim: int = 512, dropout: float = 0.2):
        super().__init__()
        self.fusion = nn.Sequential(
            nn.Linear(2 * dim, dim), nn.ReLU(), nn.Dropout(dropout), nn.Linear(dim, dim)
        )

    def forward(self, frontal: torch.Tensor, lateral: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode the dropout's mask is drawn from ``generator`` (the
        train step's stream, as flax draws it from the step's key; torch's
        global generator when None)."""
        x = torch.cat([frontal, lateral], dim=-1)
        fc1, _, drop, fc2 = self.fusion
        return fc2(dropout(drop, F.relu(fc1(x.to(fc1.weight.dtype))), generator))


class CAdapter(nn.Module):
    def __init__(self, dim: int = 512, num_classes: int = 16):
        super().__init__()
        self.classifier = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(x.to(self.classifier.weight.dtype))


class SharedEmbeddingAdapter(nn.Module):
    def __init__(self, dim: int = 512, num_classes: int = 16):
        super().__init__()
        self.classifier = nn.Linear(2 * dim, num_classes)

    def forward(self, image_proj: torch.Tensor, text_proj: torch.Tensor) -> torch.Tensor:
        x = torch.cat([image_proj, text_proj], dim=-1)
        return self.classifier(x.to(self.classifier.weight.dtype))
