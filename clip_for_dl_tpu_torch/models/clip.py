"""CXRClip — the composite dual-encoder model.

Counterpart of ``clip_for_dl_tpu.models.clip.CXRClip``: one ``nn.Module``
holding the image tower (ResNet-50, or the ViT with ``image_tower="vit_b16"``),
the text tower and every head, so that a converted
JAX checkpoint (``models/convert.py``) loads into it completely. The ported
entry points are ``encode_image``, ``encode_text``, ``encode_multiview``,
``enhance`` (the cross-modal attention of a model built with
``use_multimodal_attention``), the interpretability paths
``encode_image_with_stage4``, ``project_image_features`` (Grad-CAM) and
``encode_image_sowed`` (rollout), ``adapter_logits``, ``shared_adapter_logits``
and the joint ``forward`` of the pretrain step; ``.train()`` / ``.eval()``
switch BatchNorm statistics and dropout as flax's ``train=True`` does.
With ``config.learnable_temperature`` the model also holds the loss's two
0-dim fp32 calibration scalars, ``logit_scale`` (log s, from
``log(logit_scale_init or 1/temperature)``) and ``logit_bias`` (from
``logit_bias_init``); only the train and eval steps read them.

``CXRClip(config, fold_bn=True)`` builds the ResNet tower with its
BatchNorm folded into the convolutions (``models/resnet.py``), the
inference-only topology that ``tools/export_inference`` writes weights for,
as the JAX ``CXRClip(config, fold_bn=True)``; a ViT tower ignores it.

Parameters are created in fp32. For serving,
``core.device.cast_matmul_weights`` casts the matmul, conv and embedding
weights to the compute dtype (bf16 on the GPU); for training,
``core.device.cast_in_forward`` keeps them fp32 and casts inside the
forward. Norms stay fp32 either way. :func:`init_weights` draws a full
model from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops.similarity import l2_normalize
from .attention_fusion import AdditiveMultiModalAttention
from .bert import BertEncoder
from .moe import SwitchMoEMLP
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
    def __init__(self, config: ModelConfig, fold_bn: bool = False):
        super().__init__()
        self.config = config
        self.fold_bn = fold_bn
        if config.learnable_temperature:
            s0 = config.logit_scale_init or 1.0 / config.temperature
            self.logit_scale = nn.Parameter(torch.tensor(math.log(s0), dtype=torch.float32))
            self.logit_bias = nn.Parameter(torch.tensor(config.logit_bias_init,
                                                        dtype=torch.float32))
        if config.image_tower == "resnet50":
            self.image_tower = ResNet(config.resnet_stages, config.resnet_width, fold_bn,
                                      remat=config.remat_conv,
                                      remat_policy=config.remat_policy)
        elif config.image_tower == "vit_b16":
            self.image_tower = ViT(
                config.image_size, config.vit_patch, config.vit_hidden, config.vit_layers,
                config.vit_heads, config.vit_mlp_dim,
                gelu_approximate=config.vit_gelu_approximate, fused_mlp=config.vit_fused_mlp,
                flash=config.flash_attention, fused_mlp_train=config.vit_fused_mlp_train,
                remat=config.remat, remat_policy=config.remat_policy,
                bf16_probs=config.bf16_attention_probs,
            )
        else:
            raise ValueError(f"unknown image tower {config.image_tower!r}")
        self.text_tower = BertEncoder(
            vocab_size=config.vocab_size, hidden=config.text_embedding_dim,
            layers=config.text_layers, heads=config.text_heads,
            intermediate=config.text_intermediate_dim,
            max_position=config.text_max_position, dropout=config.dropout,
            flash=config.flash_attention, fused_mlp=config.bert_fused_mlp,
            moe_experts=config.text_moe_experts, moe_every=config.text_moe_every,
            moe_capacity_factor=config.moe_capacity_factor,
            remat=config.remat, remat_policy=config.remat_policy,
            bf16_probs=config.bf16_attention_probs,
        )
        d = config.shared_embedding_dim
        self.image_projector = ImageProjection(self.image_tower.out_dim, d, config.dropout)
        self.text_projector = TextProjection(config.text_embedding_dim, d, config.dropout)
        self.view_fusion = MultiViewFusion(d)
        self.adapter = CAdapter(d, config.num_classes)
        self.shared_adapter = SharedEmbeddingAdapter(d, config.num_classes)
        if config.use_multimodal_attention:
            self.multimodal_attention = AdditiveMultiModalAttention(d)

    def encode_image(self, images: torch.Tensor, *, normalize: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC images [B, H, W, 3] → shared-space features [B, D]; in train
        mode the projection's dropout draws from ``generator``."""
        feats = self.image_projector(self.image_tower(images), generator)
        return l2_normalize(feats) if normalize else feats

    def encode_image_with_stage4(self, images: torch.Tensor):
        """Grad-CAM path (ResNet tower only): (shared-space features, the
        tower's stage-4 activations NHWC [B, h, w, 2048])."""
        if not isinstance(self.image_tower, ResNet):
            raise ValueError(f"encode_image_with_stage4 needs the resnet50 image tower, not "
                             f"{self.config.image_tower!r}")
        pooled, stage4 = self.image_tower(images, capture_stage4=True)
        return self.image_projector(pooled), stage4

    def encode_image_sowed(self, images: torch.Tensor):
        """Rollout path (ViT tower only): (CLS features, the layers' attention
        probabilities, each [B, H, N, N] fp32)."""
        if not isinstance(self.image_tower, ViT):
            raise ValueError(f"encode_image_sowed needs the vit_b16 image tower, not "
                             f"{self.config.image_tower!r}")
        return self.image_tower(images, sow_weights=True)

    def project_image_features(self, pooled: torch.Tensor) -> torch.Tensor:
        """Tower-pooled features → shared space, in the model's dtype (the
        Grad-CAM head)."""
        return self.image_projector(pooled)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None, *,
                    normalize: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids [B, L] → CLS-pooled shared-space features [B, D]; in
        train mode every dropout draws from ``generator``."""
        hidden = self.text_tower(input_ids, attention_mask, generator=generator)
        feats = self.text_projector(hidden[:, 0, :], generator)
        return l2_normalize(feats) if normalize else feats

    def encode_multiview(self, images: torch.Tensor, *,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, 2, H, W, 3] (frontal, lateral) → fused features [B, D]: both
        views through ``encode_image`` in one call of 2B images (in train
        mode BatchNorm takes its statistics over all of them), then
        ``MultiViewFusion``; in train mode the projection's dropout and the
        fusion's draw from ``generator``."""
        b = images.shape[0]
        feats = self.encode_image(images.reshape(b * 2, *images.shape[2:]),
                                  generator=generator)
        feats = feats.reshape(b, 2, -1)
        return self.view_fusion(feats[:, 0], feats[:, 1], generator=generator)

    def enhance(self, image_features: torch.Tensor, text_features: torch.Tensor):
        """Cross-modal attention enhancement (the multimodal variant):
        (enhanced [B, D], attention weights [B, C])."""
        return self.multimodal_attention(image_features, text_features)

    def adapter_logits(self, image_features: torch.Tensor) -> torch.Tensor:
        """C-Adapter classification logits over (frozen) image features."""
        return self.adapter(image_features)

    def shared_adapter_logits(self, image_features: torch.Tensor,
                              text_features: torch.Tensor) -> torch.Tensor:
        """Shared-embedding adapter logits over concat(image, text) (03 nb)."""
        return self.shared_adapter(image_features, text_features)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """Joint forward of the pretrain step: (image features, text
        features), neither normalized. In train mode every dropout (the
        attention kernel's seeds among them) draws from ``generator``. The
        fusion, attention and adapter heads take no part, so their gradients
        are zero, as in the JAX ``__call__``."""
        img = self.encode_image(images, generator=generator)
        return img, self.encode_text(input_ids, attention_mask, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: linear, embedding, the ViT's packed attention
    projection and position embedding, the MoE experts' ``wi``/``wo``
    N(0, 0.02) (BERT's init), conv
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
        elif isinstance(m, SwitchMoEMLP):
            m.wi.normal_(0.0, 0.02, generator=generator)
            m.wo.normal_(0.0, 0.02, generator=generator)
            m.bi.zero_()
            m.bo.zero_()
        elif isinstance(m, ViT):
            m.class_token.zero_()
            m.encoder.pos_embedding.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
