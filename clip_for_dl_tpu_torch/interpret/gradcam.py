"""Grad-CAM over the ResNet tower's stage-4 activations, every disease in one
batched backward (counterpart of ``clip_for_dl_tpu.interpret.gradcam``).

The conv tower runs forward once, outside autograd, and hands back its
stage-4 activations (``capture_stage4``; the image projector does not run
there). Autograd then runs over the head
only, as the JAX function differentiates it: fp32 stage-4 activations →
fp32 mean-pool → the image projector in the model's dtype → L2-normalize in
that dtype → product with the fp32-normalized text features (the product
in fp32, as JAX promotes bf16 @ fp32), or → the adapter's logits. One
backward with a batched cotangent, one-hot of class c over every image
(``torch.autograd.grad(..., is_grads_batched=True)``), gives the gradients
of all C classes at once, as JAX's ``vmap`` of one ``vjp`` does.

CAM math (the reference's): w_k = mean_hw ∂score/∂A_k;
CAM = ReLU(Σ_k w_k·A_k), min-max normalized per image.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.resnet import ResNet
from ..ops.image_prep import resize_bilinear
from ..ops.similarity import l2_normalize


def _cam_from_grads(stage4: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """stage4 [B, h, w, K], grads [..., B, h, w, K] → normalized CAM
    [..., B, h, w]."""
    weights = grads.mean(dim=(-3, -2), keepdim=True)
    cam = torch.relu((weights * stage4).sum(-1))
    lo = cam.amin(dim=(-2, -1), keepdim=True)
    hi = cam.amax(dim=(-2, -1), keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-8)


def _head_scores(model, stage4: torch.Tensor, text_features: Optional[torch.Tensor],
                 temperature: float, mode: str) -> torch.Tensor:
    """stage-4 activations → per-class scalar scores [B, C]."""
    pooled = stage4.float().mean(dim=(1, 2))
    feats = model.project_image_features(pooled)
    if mode == "similarity":
        feats = l2_normalize(feats)
        text = l2_normalize(text_features.float())
        return feats.float() @ text.T / temperature
    if mode == "adapter":
        return model.adapter_logits(feats)
    raise ValueError(mode)


def _class_grads(model, stage4: torch.Tensor, text_features: Optional[torch.Tensor],
                 temperature: float, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(∂ score[:, c] / ∂ stage4 for every class c, [C, B, h, w, K]; scores
    [B, C]) from fp32 stage-4 activations, in one batched backward."""
    stage4 = stage4.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = _head_scores(model, stage4, text_features, temperature, mode)
        num_classes = scores.shape[1]
        # cotangent c: one-hot of class c for every image
        cot = torch.eye(num_classes, dtype=scores.dtype, device=scores.device)
        cot = cot[:, None, :].expand(num_classes, *scores.shape)
        (grads,) = torch.autograd.grad(scores, stage4, cot, is_grads_batched=True)
    return grads, scores.detach().float()


def gradcam(
    model,
    images: torch.Tensor,
    text_features: Optional[torch.Tensor] = None,
    mode: str = "similarity",
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cams [C, B, h, w], scores [B, C]), both fp32.

    images: [B, H, W, 3] preprocessed floats on the model's device; model: a
    ``CXRClip`` with the ResNet tower, in eval mode. ``mode``:
    - "similarity": score = cos-sim to each disease's text feature / T (02 nb 47)
    - "adapter":    score = the adapter's logit per class (02 nb 49)
    """
    if not isinstance(model.image_tower, ResNet):
        raise ValueError(f"gradcam needs the resnet50 image tower, not "
                         f"{model.config.image_tower!r}")
    with torch.no_grad():
        _, stage4 = model.image_tower(images, capture_stage4=True)
    stage4 = stage4.float()
    grads, scores = _class_grads(model, stage4, text_features, temperature, mode)
    return _cam_from_grads(stage4, grads), scores


def upsample_cam(cam: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear CAM upsampling [B, h, w] → [B, height, width] (the cv2.resize
    of show_cam_on_image), by the same interpolation matrices as the plain
    image prep."""
    return resize_bilinear(cam[..., None], height, width)[..., 0]


def overlay_cam(image_01: torch.Tensor, cam: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """JET-colormapped CAM blended over the de-normalized image [H, W, 3] in
    [0, 1] (gradcam.py:101-141 show_cam_on_image semantics)."""
    heat = jet_colormap(cam)
    return torch.clamp(alpha * heat + (1 - alpha) * image_01, 0.0, 1.0)


def jet_colormap(x: torch.Tensor) -> torch.Tensor:
    """OpenCV-style JET colormap for x in [0, 1] → [..., 3] RGB."""
    x = torch.clamp(x, 0.0, 1.0)
    four = 4.0 * x
    r = torch.clamp(torch.minimum(four - 1.5, -four + 4.5), 0.0, 1.0)
    g = torch.clamp(torch.minimum(four - 0.5, -four + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(four + 0.5, -four + 2.5), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)
