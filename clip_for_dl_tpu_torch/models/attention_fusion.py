"""Cross-modal attention fusion modules (counterparts of
``clip_for_dl_tpu.models.attention_fusion``).

- :class:`AdditiveMultiModalAttention`: the variant wired into training and
  zero-shot prediction (multimodal_attention/train.py:1069-1110): additive
  (Bahdanau-style) attention of each image over the per-class text
  features. State-dict names ``image_proj``, ``text_proj``, ``attention``,
  ``output_proj``, as ``models/torch_export.py export_additive_attention``
  writes them.
- :class:`TorchStyleMHA`, :class:`CrossModalTransformerFusion` and
  :class:`MLDAdapterBlock`: the alternatives the reference defines but no
  path calls, ported forward for completeness.

Every module computes in the dtype of its weights (the compute dtype under
``core.device.cast_in_forward`` or ``cast_matmul_weights``): softmax in
fp32, attention-weighted sums accumulated in fp32 and cast back, LayerNorm
in fp32, as the flax modules do. The attention runs over class axes of 16,
plain batched products; no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _weighted_sum(spec: str, weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """einsum of ``weights`` (cast to the values' dtype) and ``values``,
    accumulated in fp32, returned in the values' dtype (flax's
    ``preferred_element_type=float32`` followed by the cast)."""
    dt = values.dtype
    return torch.einsum(spec, weights.to(dt).float(), values.float()).to(dt)


class AdditiveMultiModalAttention(nn.Module):
    """enhanced = W_o(W_i·img + Σ_c softmax_c(v·tanh(W_i·img + W_t·txt_c))·W_t·txt_c)"""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.image_proj = nn.Linear(dim, dim)
        self.text_proj = nn.Linear(dim, dim)
        self.attention = nn.Linear(dim, 1)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, image_features: torch.Tensor,
                text_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_features [B, D], text_features [C, D] → (enhanced [B, D] in
        the compute dtype, attention weights [B, C] in fp32)."""
        dt = self.image_proj.weight.dtype
        img = self.image_proj(image_features.to(dt))
        txt = self.text_proj(text_features.to(dt))
        # [B, 1, D] + [1, C, D] -> additive scores [B, C]
        scores = self.attention(torch.tanh(img[:, None, :] + txt[None, :, :]))[..., 0]
        weights = torch.softmax(scores.float(), dim=-1)
        attended = _weighted_sum("bc,cd->bd", weights, txt)
        return self.output_proj(img + attended), weights


class TorchStyleMHA(nn.Module):
    """Multi-head attention with ``torch.nn.MultiheadAttention`` semantics
    (separate q/k/v projections, head-averaged weights returned)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """query [B, Lq, D], key and value [B, Lk, D] → (out [B, Lq, D],
        weights [B, Lq, Lk] averaged over heads)."""
        dt = self.q_proj.weight.dtype
        d, h = self.dim, self.num_heads
        hd = d // h

        def split(x):  # [B, L, D] -> [B, h, L, hd]
            return x.reshape(*x.shape[:-1], h, hd).transpose(1, 2)

        q = split(self.q_proj(query.to(dt)))
        k = split(self.k_proj(key.to(dt)))
        v = split(self.v_proj(value.to(dt)))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / hd ** 0.5
        probs = self.dropout(torch.softmax(logits, dim=-1))
        out = _weighted_sum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(*query.shape[:-1], d)
        return self.out_proj(out), probs.mean(dim=1)


class CrossModalTransformerFusion(nn.Module):
    """Image-query / text-key-value transformer block + concat fusion. The
    output projection takes the concat's real width, image_dim + dim (the
    torch original's Linear(dim * 2, dim) only fits when image_dim == dim)."""

    def __init__(self, image_dim: int = 2048, text_dim: int = 768, dim: int = 512,
                 num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.image_projection = nn.Linear(image_dim, dim)
        self.text_projection = nn.Linear(text_dim, dim)
        self.multihead_attn = TorchStyleMHA(dim, num_heads, dropout)
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.ff1 = nn.Linear(dim, dim * 4)
        self.ff2 = nn.Linear(dim * 4, dim)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.output_projection = nn.Linear(image_dim + dim, dim)

    def forward(self, image_features: torch.Tensor,
                text_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_features [B, image_dim], text_features [C, text_dim] →
        (fused [B, dim], attention weights [B, 1, C])."""
        dt = self.image_projection.weight.dtype
        img = self.image_projection(image_features.to(dt))
        txt = self.text_projection(text_features.to(dt))
        q = img[:, None, :]
        kv = txt[None].expand(img.shape[0], *txt.shape)
        attn_out, attn_w = self.multihead_attn(q, kv, kv)
        x = self.layer_norm1((q + attn_out).float()).to(dt)[:, 0, :]
        h = self.dropout(F.gelu(self.ff1(x)))
        h = self.dropout(self.ff2(h))
        x = self.layer_norm2((x + h).float()).to(dt)
        fused = torch.cat([image_features.to(dt), x], dim=-1)
        return self.output_projection(fused), attn_w


class MLDAdapterBlock(nn.Module):
    """Multi-label decoder: per-label text queries attend into image tokens,
    one logit per label."""

    def __init__(self, dim: int = 512, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.cross_attn = TorchStyleMHA(dim, num_heads)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.dropout = nn.Dropout(dropout)
        self.fc = nn.Linear(dim, 1)

    def forward(self, text_embeddings: torch.Tensor,
                image_embeddings: torch.Tensor) -> torch.Tensor:
        """text_embeddings [B, labels, D], image_embeddings [B, tokens, D] →
        logits [B, labels]."""
        dt = self.fc.weight.dtype
        img = image_embeddings.to(dt)
        attn_out, _ = self.cross_attn(text_embeddings.to(dt), img, img)
        x = self.norm((attn_out + text_embeddings).float()).to(dt)
        return self.fc(self.dropout(x))[..., 0]
