"""Fused L2-normalize + similarity (kernel B1, ``csrc/similarity.cu``).

Counterpart of ``clip_for_dl_tpu.ops.similarity``: image features [B, D]
against text/class features [C, D] → fp32 logits [B, C] / T, at any D and
any C (the kernel stages the text block in tiles).

:func:`similarity` launches the CUDA kernel on CUDA tensors and runs
:func:`similarity_reference`, the plain PyTorch version of the same math,
on CPU tensors; there is no other route.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "cxr_similarity"
_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps), in x's dtype."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def similarity_reference(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Plain version of the kernel's math, in fp32:
    rows scaled by rsqrt(max(Σx², eps²)), then img_n · txt_nᵀ / T."""
    a = image_features.float()
    b = text_features.float()
    a = a * torch.rsqrt(torch.clamp((a * a).sum(-1, keepdim=True), min=_EPS * _EPS))
    b = b * torch.rsqrt(torch.clamp((b * b).sum(-1, keepdim=True), min=_EPS * _EPS))
    return (a @ b.T) * (1.0 / float(temperature))


def similarity(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Cosine-similarity logits: [B, D] x [C, D] → [B, C] fp32 / temperature."""
    if image_features.device.type == "cpu":
        return similarity_reference(image_features, text_features, temperature)
    return _kernel(image_features, text_features, temperature)


def _kernel(image_features, text_features, temperature):
    B, D = image_features.shape
    C = text_features.shape[0]
    dev = image_features.device
    _build.check_tensor(image_features, "image_features", torch.float32, (B, D))
    _build.check_tensor(text_features, "text_features", torch.float32, (C, D), dev)
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B and C:
        _build.launch(KERNEL, dev, image_features.data_ptr(), text_features.data_ptr(),
                      out.data_ptr(), B, C, D, 1.0 / float(temperature), _EPS)
    return out
