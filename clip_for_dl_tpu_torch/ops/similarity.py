"""Fused L2-normalize + similarity (kernel B1, ``csrc/similarity.cu``).

Counterpart of ``clip_for_dl_tpu.ops.similarity``: image features [B, D]
against text/class features [C, D] → fp32 logits [B, C] / T, at any D and
any C. Each side is fp32, bf16 or fp16 (:data:`TYPES`), on its own; the
kernel reads it in its type and widens it in registers, as the JAX kernel
casts inside itself. A view that is not contiguous is copied first.

:func:`similarity` launches the CUDA kernel on CUDA tensors and runs
:func:`similarity_reference`, the plain PyTorch version of the same math,
on CPU tensors; there is no other route.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "cxr_similarity"
_EPS = 1e-12
# feature type -> the C entry's type code and the name it is counted under
TYPES = {torch.float32: (0, "fp32"), torch.bfloat16: (1, "bf16"), torch.float16: (2, "fp16")}


def launch_key(img_dtype: torch.dtype, txt_dtype: torch.dtype) -> str:
    """The name :data:`_build.LAUNCHES` counts a launch under: KERNEL for fp32
    features on both sides, else KERNEL_<image type>_<text type>."""
    if img_dtype == txt_dtype == torch.float32:
        return KERNEL
    return f"{KERNEL}_{TYPES[img_dtype][1]}_{TYPES[txt_dtype][1]}"


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


def _features(t: torch.Tensor, name: str, shape, device=None) -> torch.Tensor:
    """``t`` checked for the kernel, or its contiguous copy if it is a view."""
    _build.check_device(t, name, device)
    if t.dtype not in TYPES:
        raise TypeError(f"{name}: expected one of {', '.join(map(str, TYPES))}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t if t.is_contiguous() else t.contiguous()


def _kernel(image_features, text_features, temperature):
    B, D = image_features.shape
    C = text_features.shape[0]
    dev = image_features.device
    img = _features(image_features, "image_features", (B, D))
    txt = _features(text_features, "text_features", (C, D), dev)
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B and C:
        _build.launch(KERNEL, dev, img.data_ptr(), txt.data_ptr(), out.data_ptr(), B, C, D,
                      1.0 / float(temperature), _EPS, TYPES[img.dtype][0], TYPES[txt.dtype][0],
                      key=launch_key(img.dtype, txt.dtype))
    return out
