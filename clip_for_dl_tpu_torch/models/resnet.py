"""ResNet-50 image tower (v1, torchvision state-dict names).

Counterpart of ``clip_for_dl_tpu.models.resnet.ResNet``: headless ResNet v1
returning pooled [B, 2048] features. Images arrive NHWC, as at every public
function of both packages; ``permute(0, 3, 1, 2)`` turns them into NCHW
tensors with channels_last strides without a copy, and the convolutions
(cuDNN on the GPU) run in that layout. Conv weights are in the compute
dtype; BatchNorm runs in fp32 (eps 1e-5) and its output is cast back, and
the residual add is fp32, as in the JAX tower.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9)``: in eval mode it
normalizes with the running statistics; in train mode with the batch
statistics, and the running statistics become ``0.9·old + 0.1·batch`` with
the biased batch variance (``nn.BatchNorm2d`` would use the unbiased one).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


# flax's BatchNorm momentum: the weight of the old running statistics
BN_MOMENTUM = 0.9


def _bn(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """BatchNorm in fp32, output in the input's dtype (flax semantics in
    train mode, see the module docstring)."""
    x = y.float()
    if not bn.training:
        return bn(x).to(y.dtype)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    out = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
    return out.to(y.dtype)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4, eps=1e-5),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.relu(_bn(self.bn2, self.conv2(y)))
        y = _bn(self.bn3, self.conv3(y))
        residual = x
        if self.downsample is not None:
            residual = _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(y.float() + residual.float()).to(x.dtype)


class ResNet(nn.Module):
    """ResNet v1 feature extractor without the FC head."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        inplanes = width
        for stage, blocks in enumerate(stage_sizes):
            planes = width * 2 ** stage
            layer = []
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                layer.append(Bottleneck(inplanes, planes, stride, downsample=block == 0))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)
        self.out_dim = inplanes
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor, *, capture_stage4: bool = False):
        """NHWC images [B, H, W, 3] → pooled features [B, out_dim]; with
        ``capture_stage4`` → (pooled, the last block's activations), the
        latter NHWC [B, h, w, out_dim] (7 × 7 at 224) in the compute dtype,
        as the JAX tower returns them: a view of the channels_last map."""
        x = images.permute(0, 3, 1, 2).to(
            dtype=self.conv1.weight.dtype, memory_format=torch.channels_last
        )
        x = F.relu(_bn(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        # global average pool in fp32 == torch AdaptiveAvgPool2d(1)
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype)
        if capture_stage4:
            return pooled, x.permute(0, 2, 3, 1)
        return pooled
