"""On-device train-time augmentation (counterpart of
``clip_for_dl_tpu.ops.augment``).

The reference augments on host workers with torchvision transforms:
RandomHorizontalFlip(0.5), RandomRotation(10°), RandomAffine(translate 0.1)
(0425/prepare_data.py:39-55). Here the whole batch augments where it lies,
in the train step: a flip, then one inverse affine warp per image (rotation
and translation about the image centre) with bilinear sampling and zeros
outside the image, in fp32, cast back to the input's dtype.

XLA did this work in the JAX package, not a Pallas kernel, so plain
PyTorch ops on tensors are the port. The sampling is split from the warp:
a ``torch.Generator`` cannot reproduce JAX's keys, so :func:`sample_augment`
draws the parameters from the same distributions as the JAX
``_affine_matrices`` and :func:`warp` applies given parameters with JAX's
arithmetic, so that the tests can hold it against the JAX warp on JAX's own
draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def sample_augment(
    batch: int,
    generator: Optional[torch.Generator],
    flip_prob: float = 0.5,
    degrees: float = 10.0,
    translate: float = 0.1,
    height: int = 224,
    width: int = 224,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip [B] bool, inverse rotation [B, 2, 2], translation [B, 2]) in
    fp32: flip ~ Bernoulli(flip_prob); angle ~ U(-degrees, degrees) in
    degrees, in radians; translation ~ U(-translate, translate) · (H, W).
    Drawn from ``generator`` (on ``device``, default its own)."""
    if generator is not None:
        device = generator.device
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    flip = torch.rand(batch, **kw) < flip_prob
    angles = (-degrees + torch.rand(batch, **kw) * (2.0 * degrees)) * (math.pi / 180.0)
    size = torch.tensor([height, width], dtype=torch.float32, device=device)
    trans = (-translate + torch.rand(batch, 2, **kw) * (2.0 * translate)) * size
    cos, sin = torch.cos(angles), torch.sin(angles)
    # inverse rotation (output coordinate -> input coordinate)
    inv = torch.stack([torch.stack([cos, sin], -1), torch.stack([-sin, cos], -1)], -2)
    return flip, inv, trans


def warp(images: torch.Tensor, flip: torch.Tensor, inv: torch.Tensor,
         trans: torch.Tensor) -> torch.Tensor:
    """NHWC images [B, H, W, C] → the same shape and dtype: each image with
    ``flip[b]`` flipped left-right, then inverse-warped, src = inv·(dst − c)
    − inv·trans + c about the centre c = ((H − 1)/2, (W − 1)/2), sampled
    bilinearly from the four taps around src, a tap outside the image
    reading 0. fp32 throughout; the products are written out elementwise, so
    no TF32 matmul can enter."""
    b, h, w, c = images.shape
    x = images.float()
    x = torch.where(flip.reshape(b, 1, 1, 1), x.flip(2), x)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=x.device) - cx
    gy, gx = ys.view(1, h, 1), xs.view(1, 1, w)
    inv = inv.float()
    trans = trans.float()
    a, bb = inv[:, 0, 0].view(b, 1, 1), inv[:, 0, 1].view(b, 1, 1)
    cc, d = inv[:, 1, 0].view(b, 1, 1), inv[:, 1, 1].view(b, 1, 1)
    off_y = (inv[:, 0, 0] * trans[:, 0] + inv[:, 0, 1] * trans[:, 1]).view(b, 1, 1)
    off_x = (inv[:, 1, 0] * trans[:, 0] + inv[:, 1, 1] * trans[:, 1]).view(b, 1, 1)
    src_y = (a * gy + bb * gx) - off_y + cy
    src_x = (cc * gy + d * gx) - off_x + cx

    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = src_y - y0, src_x - x0
    flat = x.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, h * w, 1).expand(b, h * w, c)
        vals = flat.gather(1, idx).reshape(b, h, w, c)
        return torch.where(valid[..., None], vals, torch.zeros((), device=x.device))

    out = (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + tap(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + tap(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + tap(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    return out.to(images.dtype)


def augment_batch(
    images: torch.Tensor,
    generator: Optional[torch.Generator],
    flip_prob: float = 0.5,
    degrees: float = 10.0,
    translate: float = 0.1,
) -> torch.Tensor:
    """The reference's train transform stack on a normalized NHWC batch:
    :func:`sample_augment` from ``generator``, then :func:`warp`."""
    b, h, w, _ = images.shape
    flip, inv, trans = sample_augment(b, generator, flip_prob, degrees, translate, h, w,
                                      device=images.device)
    return warp(images, flip, inv, trans)
