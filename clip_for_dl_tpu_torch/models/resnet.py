"""ResNet-50 image tower (v1, torchvision state-dict names).

Counterpart of ``clip_for_dl_tpu.models.resnet.ResNet``: headless ResNet v1
returning pooled [B, 2048] features. Images arrive NHWC, as at every public
function of both packages; ``permute(0, 3, 1, 2)`` turns them into NCHW
tensors with channels_last strides without a copy, and the convolutions
(cuDNN on the GPU) run in that layout. Conv weights are in the compute
dtype; BatchNorm runs in fp32 (eps 1e-5) and its output is cast back, and
the residual add is fp32, as in the JAX tower.

Inside :func:`batch_norm_context` with a process group, train mode takes
its statistics over every rank's rows (the JAX step's global batch on a
mesh), at every world size, one rank included: the per-channel sums of x
and x² and the count are all-reduced with their gradient, and the mean and
biased variance are flax's E[x] and E[x²] − E[x]², which the JAX package
computes (an exact two-pass combine departs from the JAX CLI's losses by
2e-3 after an epoch of the tiny pretrain; ``tests/test_torch_cli.py``).
``update_stats=False`` leaves the running statistics as they are
(GradCache's replayed forward, ``train/accum.py``).

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9)``: in eval mode it
normalizes with the running statistics; in train mode with the batch
statistics, and the running statistics become ``0.9·old + 0.1·batch`` with
the biased batch variance (``nn.BatchNorm2d`` would use the unbiased one).

``remat`` (the config's ``remat_conv``) runs each bottleneck block through
``models/remat.py remat_call`` under ``remat_policy`` (resnet.py:149-153
in the JAX package); its recompute leaves the running statistics as the
forward set them, and under a group runs the statistics' all-reduce again
at the same point of every rank's backward.

``fold_bn=True`` builds the inference topology of the JAX tower's
``fold_bn``: every convolution has a bias and no BatchNorm follows it; the
residual add and the ReLUs run in the compute dtype. :func:`fold_batchnorm`
turns a tower's state dict into its weights: per output channel
W' = W·γ/√(σ² + ε) and b' = β − μ·γ/√(σ² + ε), in fp32, as
``clip_for_dl_tpu.models.resnet.fold_batchnorm`` folds them. A folded
tower runs only in eval mode.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .remat import recomputing, remat_call


# flax's BatchNorm momentum: the weight of the old running statistics
BN_MOMENTUM = 0.9


# train mode's (process group, update the running statistics): set by
# batch_norm_context for the forwards inside it
_CONTEXT: contextvars.ContextVar = contextvars.ContextVar("batch_norm", default=(None, True))


@contextlib.contextmanager
def batch_norm_context(group=None, update_stats: bool = True):
    """Train-mode BatchNorm inside the block: with ``group``, statistics
    over every rank's rows (the global batch); with ``update_stats=False``,
    the running statistics left as they are (a replayed forward)."""
    token = _CONTEXT.set((group, update_stats))
    try:
        yield
    finally:
        _CONTEXT.reset(token)


def _global_bn(x: torch.Tensor, bn: nn.BatchNorm2d, group):
    """Normalization with the statistics of every rank's rows, as flax
    computes them over a batch: the fp32 per-channel sums of x and x² and
    the row count all-reduced with their gradient, the mean E[x] and the
    biased variance max(E[x²] − E[x]², 0) (flax's ``use_fast_variance``),
    and the output (x − E[x])·γ/√(σ² + ε) + β. Returns (out, mean, var)."""
    from ..parallel.collectives import all_reduce_sum

    c = x.shape[1]
    sums = all_reduce_sum(torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                                     x.new_full((1,), x.numel() // c)]), group)
    n = sums[2 * c].detach()
    mean = sums[:c] / n
    var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    out = torch.addcmul(bn.bias.view(1, c, 1, 1), x - mean.view(1, c, 1, 1),
                        scale.view(1, c, 1, 1))
    return out, mean, var


def _bn(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """BatchNorm in fp32, output in the input's dtype (flax semantics in
    train mode, see the module docstring)."""
    x = y.float()
    if not bn.training:
        return bn(x).to(y.dtype)
    group, update = _CONTEXT.get()
    # a remat'd block's recompute leaves the statistics as its forward set them
    update = update and not recomputing()
    if group is None:
        out = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        if update:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    else:
        out, mean, var = _global_bn(x, bn, group)
    if update:
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1.0 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1.0 - BN_MOMENTUM)
    return out.to(y.dtype)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fold_bn: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        # registered in torchvision's order (the seeded init draws in it)
        for i, (c_in, c_out, k, s, pad) in enumerate(
                ((inplanes, planes, 1, 1, 0), (planes, planes, 3, stride, 1),
                 (planes, planes * 4, 1, 1, 0)), start=1):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, c_out, k, s, pad, bias=fold_bn))
            if not fold_bn:
                self.add_module(f"bn{i}", nn.BatchNorm2d(c_out, eps=1e-5))
        layers = [nn.Conv2d(inplanes, planes * 4, 1, stride, bias=fold_bn)]
        if not fold_bn:
            layers.append(nn.BatchNorm2d(planes * 4, eps=1e-5))
        self.downsample = nn.Sequential(*layers) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold_bn:
            y = F.relu(self.conv1(x))
            y = F.relu(self.conv2(y))
            residual = x if self.downsample is None else self.downsample[0](x)
            return F.relu(self.conv3(y) + residual)
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.relu(_bn(self.bn2, self.conv2(y)))
        y = _bn(self.bn3, self.conv3(y))
        residual = x
        if self.downsample is not None:
            residual = _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(y.float() + residual.float()).to(x.dtype)


class ResNet(nn.Module):
    """ResNet v1 feature extractor without the FC head."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 fold_bn: bool = False, remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.fold_bn = fold_bn
        # the policy each bottleneck block runs under (models/remat.py)
        self.remat_policy = remat_policy if remat else "none"
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=fold_bn)
        if not fold_bn:
            self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        inplanes = width
        for stage, blocks in enumerate(stage_sizes):
            planes = width * 2 ** stage
            layer = []
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                layer.append(Bottleneck(inplanes, planes, stride, downsample=block == 0,
                                        fold_bn=fold_bn))
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
        if self.fold_bn and self.training:
            raise RuntimeError("a folded ResNet (fold_bn=True) runs in eval mode only")
        x = images.permute(0, 3, 1, 2).to(
            dtype=self.conv1.weight.dtype, memory_format=torch.channels_last
        )
        x = self.conv1(x)
        x = F.relu(x if self.fold_bn else _bn(self.bn1, x))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = remat_call(block, self.remat_policy, x)
        # global average pool in fp32 == torch AdaptiveAvgPool2d(1)
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype)
        if capture_stage4:
            return pooled, x.permute(0, 2, 3, 1)
        return pooled


def _fold_pair(conv_w: torch.Tensor, bn: Mapping[str, torch.Tensor], eps: float):
    """(W', b') of one convolution and the BatchNorm after it, computed in
    fp32 and returned in the convolution's dtype."""
    gamma, beta = bn["weight"].float(), bn["bias"].float()
    mean, var = bn["running_mean"].float(), bn["running_var"].float()
    scale = gamma / torch.sqrt(var + eps)
    return ((conv_w.float() * scale[:, None, None, None]).to(conv_w.dtype),
            (beta - mean * scale).to(conv_w.dtype))


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """A :class:`ResNet`'s state dict → the state dict of ``ResNet(...,
    fold_bn=True)``: each BatchNorm (``bn1``, ``bnK`` of a block,
    ``downsample.1``) folded into the convolution before it, which gains a
    bias; the BatchNorm entries are dropped. Counterpart of the JAX
    ``fold_batchnorm``."""
    out: Dict[str, torch.Tensor] = {}
    for name, w in state_dict.items():
        if not name.endswith(".weight") or w.dim() != 4:
            continue
        conv = name[: -len(".weight")]
        head, _, leaf = conv.rpartition(".")
        if leaf.startswith("conv"):
            bn = f"{head}.bn{leaf[4:]}" if head else f"bn{leaf[4:]}"
        elif leaf == "0" and head.endswith("downsample"):
            bn = f"{head}.1"
        else:
            raise ValueError(f"{name}: no BatchNorm follows this convolution")
        stats = {k: state_dict[f"{bn}.{k}"]
                 for k in ("weight", "bias", "running_mean", "running_var")}
        out[f"{conv}.weight"], out[f"{conv}.bias"] = _fold_pair(w, stats, eps)
    return out
