"""Device and dtype policy (counterpart of ``clip_for_dl_tpu.core.dtypes``).

Precision follows DESIGN.md §2: parameters are created in fp32; matmul,
conv and embedding weights run in the compute dtype (bf16 on the GPU);
BatchNorm and LayerNorm keep fp32 parameters and normalize in fp32, and the
similarity and the losses run in fp32. Modules read their compute dtype from
their own weights, so one call on a model chooses it:

- :func:`cast_matmul_weights` (serving) stores those weights in the compute
  dtype;
- :func:`cast_in_forward` (training) keeps them as fp32 master parameters and
  casts them inside every forward, as flax's ``param_dtype=float32,
  dtype=bfloat16`` does, so their gradients arrive in fp32.

Parameters outside those layers that the JAX modules cast to the compute
dtype (the ViT's packed attention projection, class token and position
embedding) are named by their module's ``compute_dtype_params``; parameters
of those layers that stay fp32 (the biases the fused ViT MLP block takes in
fp32) are named, by path below the module, in its ``fp32_params``.

Both give the same forward numbers: the cast happens before any use of a
weight either way.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

# layers whose weights run in the compute dtype; norms stay fp32
_MATMUL_LAYERS = (nn.Linear, nn.Conv2d, nn.Embedding)
_PARAMETRIZED = re.compile(r"\.parametrizations\.([^.]+)\.original$")


def plain_name(name: str) -> str:
    """A parameter's name with :func:`cast_in_forward`'s parametrization
    taken out (``conv1.parametrizations.weight.original`` →
    ``conv1.weight``): its name in a model without it."""
    return _PARAMETRIZED.sub(r".\1", name)


def require_cuda(device=None) -> torch.device:
    """The CUDA device to run on; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA GPU is required (torch.cuda.is_available() is False)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"expected a CUDA device, got {dev}")
    return dev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (the CPU tests pass ``"cpu"``)."""
    if device is None or torch.device(device).type == "cuda":
        return require_cuda(device)
    return torch.device(device)


def to_device(images_u8, device: torch.device) -> torch.Tensor:
    """A batch of images as a tensor on ``device``: a tensor already there
    passes untouched (a batch gathered on the card by the device cache
    never returns to the host); a host array or tensor is staged in pinned
    memory and copied without blocking (from pageable memory the copy
    would wait for the whole stream)."""
    if isinstance(images_u8, torch.Tensor) and images_u8.device == device:
        return images_u8
    imgs = torch.as_tensor(np.ascontiguousarray(images_u8))
    if device.type == "cuda":
        imgs = imgs.pin_memory()
    return imgs.to(device, non_blocking=True)


def _compute_dtype_params(module: nn.Module):
    """[(owning module, name)] of every parameter that runs in the compute
    dtype: those of each Linear, Conv2d and Embedding and those a module
    lists in ``compute_dtype_params``, less any listed in ``fp32_params``."""
    keep = set()
    for prefix, m in module.named_modules():
        keep.update(f"{prefix}.{n}" if prefix else n for n in getattr(m, "fp32_params", ()))
    out = []
    for prefix, m in module.named_modules():
        if isinstance(m, _MATMUL_LAYERS):
            names = [n for n, _ in m.named_parameters(recurse=False)]
        else:
            names = getattr(m, "compute_dtype_params", ())
        out += [(m, n) for n in names if (f"{prefix}.{n}" if prefix else n) not in keep]
    return out


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every Linear, Conv2d and Embedding in ``module``,
    and the bare parameters named in ``compute_dtype_params``, to ``dtype``
    in place; normalization layers and ``fp32_params`` keep fp32."""
    for m, name in _compute_dtype_params(module):
        p = getattr(m, name)
        p.data = p.data.to(dtype)
    return module


class _Cast(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return w.to(self.dtype)


def cast_in_forward(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every Linear, Conv2d and Embedding of ``module`` in ``dtype`` while
    its parameters stay fp32 masters: each weight and bias becomes a
    parametrization (``torch.nn.utils.parametrize``) that casts the stored
    tensor on every access. The optimizer sees the fp32 tensors
    (``...parametrizations.weight.original``), and autograd casts their
    gradients back to fp32. The bare parameters named in
    ``compute_dtype_params`` are cast the same way; normalization layers and
    ``fp32_params`` keep fp32."""
    cast = _Cast(dtype)
    for m, name in _compute_dtype_params(module):
        if getattr(m, name).dtype != torch.float32:
            raise TypeError(f"{type(m).__name__}.{name} is {getattr(m, name).dtype}, not fp32")
        parametrize.register_parametrization(m, name, cast, unsafe=True)
    return module
