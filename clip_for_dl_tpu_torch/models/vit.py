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
  fp32 (``core.device`` keeps the names in ``fp32_params``);
- ``fused_mlp_train``: otherwise, in bf16, with both widths multiples of
  128 and no MLP dropout (the tower has none; vit.py:224-250), the
  LayerNorm in fp32 and then ``ops.mlp_train.dense_gelu_dense`` (kernels B4
  forward, B8 backward) with the biases cast to bf16 and the layer's GELU
  form; with both switches on, eval mode takes B9 and train mode B4/B8, as
  the JAX layer orders them;
- otherwise the plain LayerNorm → Linear → GELU → Linear → residual.

The tower has no dropout: the JAX ``CXRClip`` builds it at rate 0.

``sow_weights=True`` (attention rollout) also returns each layer's softmax
probabilities, [B, H, N, N] fp32, taken before the cast for PV, as the JAX
tower sows them (vit.py:165-176); as in JAX it turns ``flash`` off for that
call, since the kernel keeps no probabilities. The MLP switches are
untouched: a ``fused_mlp`` tower in eval mode and bf16 still runs B9.

A layer runs through :func:`layer_shares` with its ``tp`` context
(``parallel/tp.py``; unsharded unless ``tensor_parallel_`` gave it a
shard). Under tensor parallelism rank r holds its rows of each third of the
packed ``in_proj`` (its heads' q | k | v, B3 at heads/tp with
``head_offset``), the columns of ``out_proj`` and ``mlp.3`` for them
(row-parallel, partial products summed in fp32 over the model group, the
biases added once) and its rows of ``mlp.0``; the MLP runs through B4/B8
on that slice with b2 = 0 (``fused_mlp_train``) or the plain pair. B9
takes no shard (``--fused-mlp`` is refused under tp > 1, as in the JAX
CLI). :func:`layer_shares` also runs every rank's share in one process, as
``models.bert.layer_shares`` does.

``bf16_probs`` and ``remat`` as in ``models/bert.py`` (vit.py:128-131,
177, 314-318 in the JAX package); the sown probabilities stay fp32, taken
before the cast, as JAX sows them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops import mlp_block, mlp_train
from ..parallel.tp import UNSHARDED
from .bf16_probs import attend_bf16
from .remat import remat_call


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return ln(x.float()).to(dtype)


class MultiheadSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj``,
    ``out_proj``) and a self-attention forward."""

    compute_dtype_params = ("in_proj_weight", "in_proj_bias")

    def __init__(self, hidden: int, heads: int, flash: bool = False, bf16_probs: bool = False):
        super().__init__()
        self.heads, self.flash, self.bf16_probs = heads, flash, bf16_probs
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, y: torch.Tensor, sown: Optional[List[torch.Tensor]] = None,
                tp=UNSHARDED) -> torch.Tensor:
        """Over the heads of ``tp`` (the layer's ``parallel.tp.TPContext``):
        their attention and the partial product of ``out_proj`` (with its
        bias when unsharded). With ``sown`` (a list), the plain branch runs
        and appends its fp32 probabilities [B, heads, N, N] to it."""
        B, N, hidden = y.shape
        h, h0 = tp.heads(self.heads)
        qkv = F.linear(y, self.in_proj_weight, self.in_proj_bias)
        if self.flash and sown is None:
            if self.bf16_probs:
                fa.warn_bf16_probs_ignored()
            attn = fa.flash_attention_packed(qkv, h, head_offset=h0)
        else:
            hd = hidden // self.heads
            q, k, v = qkv.view(B, N, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
            if self.bf16_probs and sown is None:
                attn = attend_bf16(logits, v)
            else:
                probs = torch.softmax(logits, dim=-1)
                if sown is not None:
                    sown.append(probs)
                if self.bf16_probs:
                    probs = probs.to(torch.bfloat16)
                attn = torch.matmul(probs.to(y.dtype).float(), v.float()).to(y.dtype)
            attn = attn.transpose(1, 2).reshape(B, N, h * hd)
        return F.linear(attn, self.out_proj.weight, self.out_proj.bias if tp.size == 1 else None)


class ViTEncoderLayer(nn.Module):
    tp = UNSHARDED  # its parallel.tp.TPContext

    def __init__(self, hidden: int, heads: int, mlp_dim: int, gelu_approximate: bool = False,
                 fused_mlp: bool = False, flash: bool = False, fused_mlp_train: bool = False,
                 bf16_probs: bool = False):
        super().__init__()
        self.hidden, self.mlp_dim = hidden, mlp_dim
        self.gelu_approximate, self.fused_mlp = gelu_approximate, fused_mlp
        self.fused_mlp_train = fused_mlp_train
        self.ln_1 = nn.LayerNorm(hidden, eps=1e-6)
        self.self_attention = MultiheadSelfAttention(hidden, heads, flash, bf16_probs)
        self.ln_2 = nn.LayerNorm(hidden, eps=1e-6)
        # the two Linear layers of torchvision's MLPBlock, at its indices
        self.mlp = nn.ModuleDict({"0": nn.Linear(hidden, mlp_dim),
                                  "3": nn.Linear(mlp_dim, hidden)})
        # B9 takes its biases in fp32, as the JAX fused_mlp_block hands them over
        self.fp32_params = ("mlp.0.bias", "mlp.3.bias") if fused_mlp else ()

    def _kernel_widths(self, dtype: torch.dtype) -> bool:
        """The JAX gate shared by both MLP kernels: both widths multiples of
        128, bf16 compute."""
        return self.hidden % 128 == 0 and self.mlp_dim % 128 == 0 and dtype == torch.bfloat16

    def _use_fused_mlp(self, dtype: torch.dtype) -> bool:
        return self.fused_mlp and not self.training and self._kernel_widths(dtype)

    def _use_fused_mlp_train(self, dtype: torch.dtype) -> bool:
        # the MLP's dropout rate is 0: the CLIP ViT is built without dropout
        return self.fused_mlp_train and self._kernel_widths(dtype)

    def _mlp_share(self, y: torch.Tensor) -> torch.Tensor:
        """This share's partial product of ``mlp.3`` over its slice of the
        hidden, from the normalized ``y`` (with b2 when unsharded)."""
        fc1, fc2 = self.mlp["0"], self.mlp["3"]
        dt = y.dtype
        b2 = fc2.bias.to(dt) if self.tp.size == 1 else None
        if self._use_fused_mlp_train(dt):
            return mlp_train.dense_gelu_dense(
                y, fc1.weight, fc1.bias.to(dt), fc2.weight,
                torch.zeros_like(fc2.bias, dtype=dt) if b2 is None else b2,
                approximate=self.gelu_approximate)
        g = F.gelu(F.linear(y, fc1.weight, fc1.bias.to(dt)),
                   approximate="tanh" if self.gelu_approximate else "none")
        return F.linear(g, fc2.weight, b2)

    def forward(self, x: torch.Tensor, sown: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        return layer_shares([self], x, sown)


def layer_shares(shares, x: torch.Tensor, sown: Optional[List[torch.Tensor]] = None
                 ) -> torch.Tensor:
    """A ViT layer over ``shares``: [the layer] with its context (over its
    model group under tensor parallelism), or every rank's share in one
    process. ``sown`` as :meth:`MultiheadSelfAttention.forward` takes it,
    unsharded only."""
    lead = shares[0]
    ctx, dt = lead.tp, x.dtype
    if sown is not None and ctx.size > 1:
        raise ValueError("the attention probabilities are not sown under tensor parallelism")
    y = ctx.enter(_layer_norm(lead.ln_1, x, dt))
    x = x + ctx.row_output([s.self_attention(y, sown, s.tp) for s in shares],
                           lead.self_attention.out_proj.bias, dt)
    if lead._use_fused_mlp(dt):  # B9, unsharded only (refused under tp > 1)
        fc1, fc2 = lead.mlp["0"], lead.mlp["3"]
        return mlp_block.fused_mlp_block_trainable(
            x, lead.ln_2.weight, lead.ln_2.bias, fc1.weight, fc1.bias, fc2.weight,
            fc2.bias, eps=1e-6, gelu_approximate=lead.gelu_approximate,
        )
    y = ctx.enter(_layer_norm(lead.ln_2, x, dt))
    return x + ctx.row_output([s._mlp_share(y) for s in shares], lead.mlp["3"].bias, dt)


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
                 gelu_approximate: bool = False, fused_mlp: bool = False, flash: bool = False,
                 fused_mlp_train: bool = False, remat: bool = False, remat_policy: str = "full",
                 bf16_probs: bool = False):
        super().__init__()
        self.patch, self.out_dim = patch, hidden
        # the policy each layer runs under (models/remat.py)
        self.remat_policy = remat_policy if remat else "none"
        self.conv_proj = nn.Conv2d(3, hidden, patch, stride=patch)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.encoder = _Encoder((image_size // patch) ** 2 + 1, hidden, layers, heads, mlp_dim,
                                gelu_approximate=gelu_approximate, fused_mlp=fused_mlp,
                                flash=flash, fused_mlp_train=fused_mlp_train,
                                bf16_probs=bf16_probs)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """The stem: NHWC images → the class token and the patches' tokens
        with their position embeddings [B, N, hidden]."""
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
        return x + self.encoder.pos_embedding

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's tokens → CLS features [B, hidden]."""
        # LayerNorm is per row, so only the CLS row is normalized
        return _layer_norm(self.encoder.ln, x[:, 0], self.conv_proj.weight.dtype)

    def forward(self, images: torch.Tensor, *, sow_weights: bool = False):
        """CLS features [B, hidden]; with ``sow_weights``, (features, the
        layers' attention probabilities in order, each [B, H, N, N] fp32)."""
        x = self.embed(images)
        sown = [] if sow_weights else None
        for layer in self.encoder.layers:
            x = remat_call(layer, self.remat_policy, x, sown)
        feats = self.head(x)
        return (feats, sown) if sow_weights else feats
