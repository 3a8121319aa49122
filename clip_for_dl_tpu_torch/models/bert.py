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
other dropout draws its mask from the same generator
(``models.heads.dropout``; the ``nn.Dropout`` modules keep the rate). Both
kernels take their backward when a gradient is required.

A layer runs through :func:`layer_shares` with its ``tp`` context
(``parallel/tp.py``; :data:`~clip_for_dl_tpu_torch.parallel.tp.UNSHARDED`
unless ``tensor_parallel_`` gave it a shard). Under tensor parallelism the
packed q|k|v product runs on the rank's three column shards, so its qkv is
[B, L, 3·H/tp] and B3 runs at heads/tp with ``head_offset`` (the unsharded
layer's dropout masks); ``attention.output.dense`` and ``output.dense``
are row-parallel, their partial products summed in fp32 over the model
group and their biases added once; the MLP runs through B4/B8 on the
rank's slice of the hidden with b2 = 0 (``--bert-fused-mlp``) or the plain
pair. The seeds and every mask are drawn once a layer, so the ranks of a
data slice, their generators in lockstep, draw the same.
:func:`layer_shares` also runs every rank's share in one process, the
partial products summed there. Unsharded, the biases go into the products
and no collective runs.

``moe_experts`` E > 0 (``BertEncoder``: every ``moe_every``-th layer, i %
moe_every == moe_every − 1, as bert.py:293-297 in the JAX package) swaps
the layer's MLP for ``models.moe.SwitchMoEMLP`` under ``moe_mlp``: such a
layer has ``moe_mlp`` and ``output.LayerNorm`` and no ``intermediate`` or
``output.dense``, its token mask read off the attention bias (bias > −1e4),
and the MoE wins over ``fused_mlp``. The MoE is replicated under tensor
parallelism (the JAX ``tp_spec`` shards no ``moe_mlp`` leaf), so it runs
once on the layer's whole input, outside the sum over shares; under
sequence parallelism on the gathered sequence (``TPContext.replicated``).

``bf16_probs`` (``--bf16-attention-probs``, bert.py:144-145 in the JAX
package) rounds the plain route's softmax output to bf16 before the
dropout and P·V, and keeps only bf16 probabilities for the backward
(``models/bf16_probs.py``); under ``flash`` it warns with the JAX text
and changes nothing. ``remat`` runs each layer through
``models/remat.py remat_call`` under ``remat_policy`` (bert.py:287-291),
the layer's generator carried into the recompute.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops import mlp_train
from ..parallel.tp import UNSHARDED
from .bf16_probs import attend_bf16
from .heads import dropout
from .moe import SwitchMoEMLP
from .remat import remat_call


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
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, start: int = 0) -> torch.Tensor:
        """``start``: the position of the first token (a slice of the
        sequence under sequence parallelism)."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(start, start + input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)[None]
             + self.token_type_embeddings(token_type_ids))
        return dropout(self.dropout, _layer_norm(self.LayerNorm, x, x.dtype), generator)


class BertSelfAttention(nn.Module):
    """HF ``BertSelfAttention``'s parameters and the attention dropout's
    rate; :meth:`BertLayer._attention_share` runs them."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.1,
                 flash: bool = False, bf16_probs: bool = False):
        super().__init__()
        self.heads = heads
        self.flash, self.bf16_probs = flash, bf16_probs
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.dropout = nn.Dropout(dropout)


class _DenseNorm(nn.Module):
    """HF ``BertSelfOutput`` / ``BertOutput`` parameter container."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=1e-12)


class _Attention(nn.Module):
    """HF ``BertAttention`` container: ``self`` and ``output``."""

    def __init__(self, hidden: int, heads: int, dropout: float, flash: bool,
                 bf16_probs: bool = False):
        super().__init__()
        self.self = BertSelfAttention(hidden, heads, dropout, flash, bf16_probs)
        self.output = _DenseNorm(hidden, hidden)


class _Norm(nn.Module):
    """A MoE layer's ``output``: its LayerNorm alone."""

    def __init__(self, hidden: int):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class BertLayer(nn.Module):
    tp = UNSHARDED  # its parallel.tp.TPContext

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dropout: float = 0.1, flash: bool = False, fused_mlp: bool = False,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25,
                 bf16_probs: bool = False):
        super().__init__()
        self.hidden, self.intermediate_dim = hidden, intermediate
        self.fused_mlp = fused_mlp
        self.attention = _Attention(hidden, heads, dropout, flash, bf16_probs)
        if moe_experts:
            self.moe_mlp = SwitchMoEMLP(hidden, intermediate, moe_experts, moe_capacity_factor)
            self.output = _Norm(hidden)
        else:
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

    def _attention_share(self, x: torch.Tensor, bias: Optional[torch.Tensor], seeds, keep,
                         rate: float) -> torch.Tensor:
        """This share's partial product of ``attention.output.dense`` over
        its heads (with the bias when unsharded): [B, N, hidden]. ``seeds``
        drive the flash kernel's dropout, ``keep`` [B, heads, N, N] the
        plain one's."""
        sa = self.attention.self
        h, h0 = self.tp.heads(sa.heads)
        hd = self.hidden // sa.heads
        if sa.flash:
            if sa.bf16_probs:
                fa.warn_bf16_probs_ignored()
            w = torch.cat([sa.query.weight, sa.key.weight, sa.value.weight])
            b = torch.cat([sa.query.bias, sa.key.bias, sa.value.bias])
            out = self.tp.attend(
                lambda qkv: fa.flash_attention_packed(qkv, h, bias, dropout_rate=rate,
                                                      dropout_seeds=seeds, head_offset=h0),
                F.linear(x, w, b))
        else:
            def attend(q, k, v):
                B, N, _ = q.shape
                q, k, v = (t.view(B, N, h, hd).transpose(1, 2) for t in (q, k, v))
                logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
                if bias is not None:
                    logits = logits + bias[:, None, None, :]
                mask = None if keep is None else keep[:, h0:h0 + h]
                if sa.bf16_probs:
                    out = attend_bf16(logits, v, mask, rate)
                else:
                    probs = torch.softmax(logits, dim=-1)
                    if mask is not None:
                        probs = torch.where(mask, probs / (1.0 - rate), torch.zeros(
                            (), dtype=probs.dtype, device=probs.device))
                    out = torch.matmul(probs.to(x.dtype).float(), v.float()).to(x.dtype)
                return out.transpose(1, 2).reshape(B, N, h * hd)

            out = self.tp.attend(attend, sa.query(x), sa.key(x), sa.value(x))
        dense = self.attention.output.dense
        return F.linear(out, dense.weight, dense.bias if self.tp.size == 1 else None)

    def _mlp_share(self, x: torch.Tensor) -> torch.Tensor:
        """This share's partial product of ``output.dense`` over its slice
        of the hidden (with b2 at tp = 1)."""
        inter, out = self.intermediate.dense, self.output.dense
        if self._use_fused_mlp(x.dtype):
            b2 = out.bias if self.tp.size == 1 else torch.zeros_like(out.bias)
            return mlp_train.dense_gelu_dense(x, inter.weight, inter.bias, out.weight, b2)
        return F.linear(F.gelu(inter(x)), out.weight, out.bias if self.tp.size == 1 else None)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return layer_shares([self], x, bias, generator)


def layer_shares(shares, x: torch.Tensor, bias: Optional[torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A BERT layer over ``shares``: [the layer] with its context (over its
    model group under tensor parallelism), or every rank's share (each
    sharded with ``tensor_parallel_(..., share=r)``) in one process. The
    seeds and masks are drawn once, as by the unsharded layer."""
    lead = shares[0]
    ctx, sa, dt = lead.tp, lead.attention.self, x.dtype
    B, N, _ = x.shape
    rate = sa.dropout.p if lead.training else 0.0
    seeds = keep = None
    if rate > 0.0 and sa.flash:
        seeds = fa.dropout_seeds(generator, B, x.device)
    elif rate > 0.0:
        keep = torch.rand((B, sa.heads, N, N), generator=generator, device=x.device) >= rate
    xin = ctx.enter(x)
    attn = ctx.row_output([s._attention_share(xin, bias, seeds, keep, rate) for s in shares],
                          lead.attention.output.dense.bias, dt)
    attn = dropout(lead.dropout, attn, generator)
    x = _layer_norm(lead.attention.output.LayerNorm, x + attn, dt)
    if hasattr(lead, "moe_mlp"):
        mask = None if bias is None else bias > -1e4
        h = ctx.replicated(lambda v: lead.moe_mlp(v, mask), x)
    else:
        xin = ctx.enter(x)
        h = ctx.row_output([s._mlp_share(xin) for s in shares], lead.output.dense.bias, dt)
    h = dropout(lead.dropout, h, generator)
    return _layer_norm(lead.output.LayerNorm, x + h, dt)


class BertEncoder(nn.Module):
    """bert-base geometry by default (Bio_ClinicalBERT: 12L/12H/768)."""

    def __init__(self, vocab_size: int = 28996, hidden: int = 768, layers: int = 12,
                 heads: int = 12, intermediate: int = 3072, max_position: int = 512,
                 dropout: float = 0.1, flash: bool = False, fused_mlp: bool = False,
                 moe_experts: int = 0, moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 remat: bool = False, remat_policy: str = "full", bf16_probs: bool = False):
        super().__init__()
        # the policy each layer runs under (models/remat.py)
        self.remat_policy = remat_policy if remat else "none"
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_position, dropout=dropout)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, heads, intermediate, dropout, flash, fused_mlp,
                      moe_experts if moe_experts and i % moe_every == moe_every - 1 else 0,
                      moe_capacity_factor, bf16_probs)
            for i in range(layers)
        )

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids [B, L] → last_hidden_state [B, L, hidden]."""
        x = self.embeddings(input_ids, token_type_ids, generator)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask > 0, 0.0, -1e10).to(torch.float32)
        for layer in self.encoder.layer:
            x = remat_call(layer, self.remat_policy, x, bias, generator, generator=generator)
        return x
