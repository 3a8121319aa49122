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

Both give the same forward numbers: the cast happens before any use of a
weight either way.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

# layers whose weights run in the compute dtype; norms stay fp32
_MATMUL_LAYERS = (nn.Linear, nn.Conv2d, nn.Embedding)


def require_cuda(device=None) -> torch.device:
    """The CUDA device to run on; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA GPU is required (torch.cuda.is_available() is False)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"expected a CUDA device, got {dev}")
    return dev


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every Linear, Conv2d and Embedding in ``module``
    to ``dtype`` in place; normalization layers keep fp32."""
    for m in module.modules():
        if isinstance(m, _MATMUL_LAYERS):
            for p in m.parameters(recurse=False):
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
    gradients back to fp32. Normalization layers keep fp32."""
    cast = _Cast(dtype)
    for m in module.modules():
        if isinstance(m, _MATMUL_LAYERS):
            for name, p in list(m.named_parameters(recurse=False)):
                if p.dtype != torch.float32:
                    raise TypeError(f"{type(m).__name__}.{name} is {p.dtype}, not fp32")
                parametrize.register_parametrization(m, name, cast, unsafe=True)
    return module
