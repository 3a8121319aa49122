"""CXRClip — the composite dual-encoder model.

Counterpart of ``clip_for_dl_tpu.models.clip.CXRClip``: one ``nn.Module``
holding the image tower (ResNet-50, or the ViT with ``image_tower="vit_b16"``),
the text tower and every head, so that a converted
JAX checkpoint (``models/convert.py``) loads into it completely. The ported
entry points are ``encode_image``, ``encode_text``, ``adapter_logits`` and
the joint ``forward`` of the pretrain step; ``.train()`` / ``.eval()``
switch BatchNorm statistics and dropout as flax's ``train=True`` does.

Parameters are created in fp32. For serving,
``core.device.cast_matmul_weights`` casts the matmul, conv and embedding
weights to the compute dtype (bf16 on the GPU); for training,
``core.device.cast_in_forward`` keeps them fp32 and casts inside the
forward. Norms stay fp32 either way. :func:`init_weights` draws a full
model from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops.similarity import l2_normalize
from .bert import BertEncoder
from .heads import (
    CAdapter,
    ImageProjection,
    MultiViewFusion,
    SharedEmbeddingAdapter,
    TextProjection,
)
from .resnet import ResNet
from .vit import MultiheadSelfAttention, ViT


class CXRClip(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.use_multimodal_attention:
            raise NotImplementedError("multimodal attention is not ported yet")
        self.config = config
        if config.image_tower == "resnet50":
            self.image_tower = ResNet(config.resnet_stages, config.resnet_width)
        elif config.image_tower == "vit_b16":
            if config.vit_fused_mlp_train:
                raise NotImplementedError("the ViT training MLP (vit_fused_mlp_train) is not "
                                          "ported yet (ROADMAP A8)")
            self.image_tower = ViT(
                config.image_size, config.vit_patch, config.vit_hidden, config.vit_layers,
                config.vit_heads, config.vit_mlp_dim,
                gelu_approximate=config.vit_gelu_approximate, fused_mlp=config.vit_fused_mlp,
                flash=config.flash_attention,
            )
        else:
            raise ValueError(f"unknown image tower {config.image_tower!r}")
        self.text_tower = BertEncoder(
            vocab_size=config.vocab_size, hidden=config.text_embedding_dim,
            layers=config.text_layers, heads=config.text_heads,
            intermediate=config.text_intermediate_dim,
            max_position=config.text_max_position, dropout=config.dropout,
            flash=config.flash_attention, fused_mlp=config.bert_fused_mlp,
        )
        d = config.shared_embedding_dim
        self.image_projector = ImageProjection(self.image_tower.out_dim, d, config.dropout)
        self.text_projector = TextProjection(config.text_embedding_dim, d, config.dropout)
        self.view_fusion = MultiViewFusion(d)
        self.adapter = CAdapter(d, config.num_classes)
        self.shared_adapter = SharedEmbeddingAdapter(d, config.num_classes)

    def encode_image(self, images: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
        """NHWC images [B, H, W, 3] → shared-space features [B, D]."""
        feats = self.image_projector(self.image_tower(images))
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None, *,
                    normalize: bool = False) -> torch.Tensor:
        """Token ids [B, L] → CLS-pooled shared-space features [B, D]."""
        hidden = self.text_tower(input_ids, attention_mask)
        feats = self.text_projector(hidden[:, 0, :])
        return l2_normalize(feats) if normalize else feats

    def adapter_logits(self, image_features: torch.Tensor) -> torch.Tensor:
        """C-Adapter classification logits over (frozen) image features."""
        return self.adapter(image_features)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """Joint forward of the pretrain step: (image features, text
        features), neither normalized. ``generator`` seeds the attention
        kernel's dropout in train mode. The fusion and adapter heads take no
        part, so their gradients are zero, as in the JAX ``__call__``."""
        img = self.encode_image(images)
        hidden = self.text_tower(input_ids, attention_mask, generator=generator)
        return img, self.text_projector(hidden[:, 0, :])


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: linear, embedding, the ViT's packed attention
    projection and position embedding N(0, 0.02) (BERT's init), conv
    He-normal over fan-out (torchvision's), zero biases and class token, unit
    norms, BatchNorm running statistics mean 0 / variance 1. ``generator``
    must live on the parameters' device."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiheadSelfAttention):
            m.in_proj_weight.normal_(0.0, 0.02, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, ViT):
            m.class_token.zero_()
            m.encoder.pos_embedding.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
