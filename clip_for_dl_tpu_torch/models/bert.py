"""BERT text tower (Bio_ClinicalBERT geometry), CLS-pooled.

Counterpart of ``clip_for_dl_tpu.models.bert``, with HF ``BertModel``
state-dict names (``embeddings.*``, ``encoder.layer.N.*``) so real clinical
weights load unchanged. Matmuls run in the dtype of the weights; LayerNorm
(eps 1e-12) and the attention softmax run in fp32.

Two switches mirror the JAX tower and route to the port's kernels:

- ``flash``: the three q/k/v projections run as one packed [H, 3H]
  product whose output feeds ``ops.flash_attention.flash_attention_packed``
  (bert.py:86-127 in the JAX package);
- ``fused_mlp``: the MLP runs as ``ops.mlp_train.dense_gelu_dense`` when the
  compute dtype is bf16 and both widths are 128-aligned, the same gate as
  bert.py:205-212; otherwise the plain Dense → GELU → Dense.

In train mode the flash attention drops probabilities inside the kernel,
with per-batch-row seeds drawn from the ``generator`` passed to ``forward``
(one draw per layer, as each JAX layer takes its own dropout key); every
other dropout is an ``nn.Dropout``. Both kernels take their backward when a
gradient is required.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops import mlp_train


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return ln(x.float()).to(dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_position: int = 512,
                 type_vocab: int = 2, dropout: float = 0.1):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_position, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(_layer_norm(self.LayerNorm, x, x.dtype))


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float = 0.1,
                 flash: bool = False):
        super().__init__()
        self.heads = heads
        self.flash = flash
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, N, hidden]; bias [B, N] fp32 additive key bias or None;
        ``generator`` seeds the flash kernel's dropout in train mode."""
        B, N, hidden = x.shape
        h, hd = self.heads, hidden // self.heads
        if self.flash:
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            qkv = F.linear(x, w, b)
            rate = self.dropout.p if self.training else 0.0
            seeds = fa.dropout_seeds(generator, B, x.device) if rate > 0.0 else None
            return fa.flash_attention_packed(qkv, h, bias, dropout_rate=rate,
                                             dropout_seeds=seeds)
        q, k, v = (
            t.view(B, N, h, hd).transpose(1, 2)
            for t in (self.query(x), self.key(x), self.value(x))
        )
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
        if bias is not None:
            logits = logits + bias[:, None, None, :]
        probs = self.dropout(torch.softmax(logits, dim=-1))
        out = torch.matmul(probs.to(x.dtype).float(), v.float()).to(x.dtype)
        return out.transpose(1, 2).reshape(B, N, hidden)


class _DenseNorm(nn.Module):
    """HF ``BertSelfOutput`` / ``BertOutput`` parameter container."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=1e-12)


class _Attention(nn.Module):
    """HF ``BertAttention`` container: ``self`` and ``output``."""

    def __init__(self, hidden: int, heads: int, dropout: float, flash: bool):
        super().__init__()
        self.self = BertSelfAttention(hidden, heads, dropout, flash)
        self.output = _DenseNorm(hidden, hidden)


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dropout: float = 0.1, flash: bool = False, fused_mlp: bool = False):
        super().__init__()
        self.hidden, self.intermediate_dim = hidden, intermediate
        self.fused_mlp = fused_mlp
        self.attention = _Attention(hidden, heads, dropout, flash)
        self.intermediate = _Intermediate(hidden, intermediate)
        self.output = _DenseNorm(intermediate, hidden)
        self.dropout = nn.Dropout(dropout)

    def _use_fused_mlp(self, dtype: torch.dtype) -> bool:
        return (
            self.fused_mlp
            and self.hidden % 128 == 0
            and self.intermediate_dim % 128 == 0
            and dtype == torch.bfloat16
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = x.dtype
        attn = self.attention.self(x, bias, generator)
        attn = self.dropout(self.attention.output.dense(attn))
        x = _layer_norm(self.attention.output.LayerNorm, x + attn, dt)
        if self._use_fused_mlp(dt):
            h = mlp_train.dense_gelu_dense(
                x, self.intermediate.dense.weight, self.intermediate.dense.bias,
                self.output.dense.weight, self.output.dense.bias,
            )
        else:
            h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        h = self.dropout(h)
        return _layer_norm(self.output.LayerNorm, x + h, dt)


class BertEncoder(nn.Module):
    """bert-base geometry by default (Bio_ClinicalBERT: 12L/12H/768)."""

    def __init__(self, vocab_size: int = 28996, hidden: int = 768, layers: int = 12,
                 heads: int = 12, intermediate: int = 3072, max_position: int = 512,
                 dropout: float = 0.1, flash: bool = False, fused_mlp: bool = False):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_position, dropout=dropout)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, heads, intermediate, dropout, flash, fused_mlp)
            for _ in range(layers)
        )

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids [B, L] → last_hidden_state [B, L, hidden]."""
        x = self.embeddings(input_ids, token_type_ids)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask > 0, 0.0, -1e10).to(torch.float32)
        for layer in self.encoder.layer:
            x = layer(x, bias, generator)
        return x
