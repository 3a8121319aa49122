"""ViT image tower (torchvision ``vit_b_16`` geometry), CLS-pooled.

Counterpart of ``clip_for_dl_tpu.models.vit``, with torchvision's state-dict
names (``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_N.{ln_1, self_attention.in_proj_weight,
self_attention.in_proj_bias, self_attention.out_proj, ln_2, mlp.0, mlp.3}``,
``encoder.ln``): the names the JAX ``import_torchvision_vit_b16`` reads.
Images are NHWC. Patchify is a reshape plus one product over
(P, P, C)-ordered patch pixels with ``conv_proj``'s weight, as the JAX tower
does it. LayerNorm (eps 1e-6) runs in fp32; the matmuls run in the dtype of
the weights.

Two switches mirror the JAX layer:

- ``flash``: the packed q|k|v product (``in_proj``, already in the kernel's
  q-heads | k-heads | v-heads order) feeds
  ``ops.flash_attention.flash_attention_packed`` with no key bias (kernel
  B3);
- ``fused_mlp``: in eval mode, in bf16, with both widths multiples of 128
  (vit.py:191-208 in the JAX package), the MLP half runs as
  ``ops.mlp_block.fused_mlp_block_trainable`` (kernel B9), whose biases stay
  fp32 (``core.device`` keeps the names in ``fp32_params``); otherwise the
  plain LayerNorm → Linear → GELU → Linear → residual.

The tower has no dropout: the JAX ``CXRClip`` builds it at rate 0. Attention
rollout (``sow_weights``, ROADMAP A9) is not ported and raises.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops import mlp_block


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return ln(x.float()).to(dtype)


class MultiheadSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj``,
    ``out_proj``) and a self-attention forward."""

    compute_dtype_params = ("in_proj_weight", "in_proj_bias")

    def __init__(self, hidden: int, heads: int, flash: bool = False):
        super().__init__()
        self.heads, self.flash = heads, flash
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        B, N, hidden = y.shape
        qkv = F.linear(y, self.in_proj_weight, self.in_proj_bias)
        if self.flash:
            attn = fa.flash_attention_packed(qkv, self.heads)
        else:
            h, hd = self.heads, hidden // self.heads
            q, k, v = qkv.view(B, N, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
            probs = torch.softmax(logits, dim=-1)
            attn = torch.matmul(probs.to(y.dtype).float(), v.float()).to(y.dtype)
            attn = attn.transpose(1, 2).reshape(B, N, hidden)
        return self.out_proj(attn)


class ViTEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, gelu_approximate: bool = False,
                 fused_mlp: bool = False, flash: bool = False):
        super().__init__()
        self.hidden, self.mlp_dim = hidden, mlp_dim
        self.gelu_approximate, self.fused_mlp = gelu_approximate, fused_mlp
        self.ln_1 = nn.LayerNorm(hidden, eps=1e-6)
        self.self_attention = MultiheadSelfAttention(hidden, heads, flash)
        self.ln_2 = nn.LayerNorm(hidden, eps=1e-6)
        # the two Linear layers of torchvision's MLPBlock, at its indices
        self.mlp = nn.ModuleDict({"0": nn.Linear(hidden, mlp_dim),
                                  "3": nn.Linear(mlp_dim, hidden)})
        # B9 takes its biases in fp32, as the JAX fused_mlp_block hands them over
        self.fp32_params = ("mlp.0.bias", "mlp.3.bias") if fused_mlp else ()

    def _use_fused_mlp(self, dtype: torch.dtype) -> bool:
        return (
            self.fused_mlp
            and not self.training
            and self.hidden % 128 == 0
            and self.mlp_dim % 128 == 0
            and dtype == torch.bfloat16
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x + self.self_attention(_layer_norm(self.ln_1, x, dt))
        fc1, fc2 = self.mlp["0"], self.mlp["3"]
        if self._use_fused_mlp(dt):
            return mlp_block.fused_mlp_block_trainable(
                x, self.ln_2.weight, self.ln_2.bias, fc1.weight, fc1.bias, fc2.weight,
                fc2.bias, eps=1e-6, gelu_approximate=self.gelu_approximate,
            )
        y = F.linear(_layer_norm(self.ln_2, x, dt), fc1.weight, fc1.bias.to(dt))
        y = F.gelu(y, approximate="tanh" if self.gelu_approximate else "none")
        return x + F.linear(y, fc2.weight, fc2.bias.to(dt))


class _Encoder(nn.Module):
    """torchvision's ``Encoder`` container: position embedding, layers, ln."""

    compute_dtype_params = ("pos_embedding",)

    def __init__(self, seq_len: int, hidden: int, layers: int, heads: int, mlp_dim: int,
                 **layer_kw):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_len, hidden).normal_(std=0.02))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", ViTEncoderLayer(hidden, heads, mlp_dim, **layer_kw))
            for i in range(layers)
        ))
        self.ln = nn.LayerNorm(hidden, eps=1e-6)


class ViT(nn.Module):
    """NHWC images [B, H, W, 3] → CLS features [B, hidden] (torchvision's
    ``heads.head = Identity`` contract); ViT-B/16 by default."""

    compute_dtype_params = ("class_token",)

    def __init__(self, image_size: int = 224, patch: int = 16, hidden: int = 768,
                 layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 gelu_approximate: bool = False, fused_mlp: bool = False, flash: bool = False):
        super().__init__()
        self.patch, self.out_dim = patch, hidden
        self.conv_proj = nn.Conv2d(3, hidden, patch, stride=patch)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.encoder = _Encoder((image_size // patch) ** 2 + 1, hidden, layers, heads, mlp_dim,
                                gelu_approximate=gelu_approximate, fused_mlp=fused_mlp,
                                flash=flash)

    def forward(self, images: torch.Tensor, *, sow_weights: bool = False) -> torch.Tensor:
        if sow_weights:
            raise NotImplementedError("attention rollout (sow_weights) is not ported yet "
                                      "(ROADMAP A9)")
        dt = self.conv_proj.weight.dtype
        b, hgt, wdt, c = images.shape
        p = self.patch
        gh, gw = hgt // p, wdt // p
        x = images.to(dt).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        # conv_proj's [hidden, C, P, P] kernel as a Dense over (P, P, C) pixels
        w = self.conv_proj.weight.permute(0, 2, 3, 1).flatten(1)
        x = F.linear(x, w, self.conv_proj.bias)
        x = torch.cat([self.class_token.expand(b, -1, -1), x], dim=1)
        x = x + self.encoder.pos_embedding
        for layer in self.encoder.layers:
            x = layer(x)
        # LayerNorm is per row, so only the CLS row is normalized
        return _layer_norm(self.encoder.ln, x[:, 0], dt)
