"""Fused pre-LN transformer MLP block (kernel B9, ``csrc/mlp_block.cu``).

Counterpart of ``clip_for_dl_tpu.ops.mlp_block``: the MLP half of a ViT
encoder layer at inference,

    out = x + W2·gelu(W1·LN(x) + b1) + b2

LayerNorm in fp32 (the mean, then the mean of squared deviations), scale
and bias in fp32, cast to x's dtype; both products in x's dtype with fp32
accumulation; GELU in fp32 (exact erf, or tanh with ``gelu_approximate``),
cast; the second product plus b2 in fp32, cast; the residual added in x's
dtype. Weights are in ``nn.Linear`` layout (w1 [F, H], w2 [H, F]; the JAX
function takes them transposed) and are cast to x's dtype, while the
LayerNorm parameters and both biases stay as given, as ``fused_mlp_block``
passes them to its kernel. H and F must be multiples of 128, as in JAX.

B9 replaces the TPU kernel ``_mlp_block_kernel``
(``clip_for_dl_tpu/ops/mlp_block.py:78``) with three launches: a LayerNorm
row pass (memory-bound) that writes the bf16 y, then the two wgmma kernels
of ``csrc/mlp_fwd.cuh``, bound by tensor-core math: g = bf16(gelu(y·W1ᵀ +
b1)), then out = x + bf16(g·W2ᵀ + b2). y and g are scratch that the wrapper
allocates. The TPU kernel kept both on chip; on the card a fused kernel
would hold an fp32 [64, H] output accumulator a warpgroup (49,152
registers at H = 768, all 65,536 of an SM at H = 1024), so they pass
through device memory, rounded where the TPU kernel rounds them. The kernel
itself takes any H and F that are multiples of 64 (``check_widths``).

:func:`fused_mlp_block_trainable` runs the same forward inside
:class:`_MLPBlock`, which saves only its inputs; the backward is autograd
through :func:`fused_mlp_block_reference`, recomputed from them, as the JAX
custom VJP does. The JAX package has no backward kernel here, and neither
has the port.
"""

from __future__ import annotations

import torch
from torch.nn.functional import gelu

from . import _build, library
from .mlp_train import check_widths

KERNEL = "cxr_mlp_block"


def _check_shapes(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> None:
    H, F = x.shape[-1], w1.shape[0]
    if H % 128 or F % 128:
        raise ValueError(f"feature dims must be multiples of 128, got H={H} F={F}")
    if tuple(w1.shape) != (F, H) or tuple(w2.shape) != (H, F):
        raise ValueError(f"weight shapes {tuple(w1.shape)}/{tuple(w2.shape)} do not match "
                         f"H={H} F={F}")


def fused_mlp_block_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-6,
    gelu_approximate: bool = False,
) -> torch.Tensor:
    """Plain version of the kernel's math (the JAX ``mlp_block_reference``,
    in its dtype order)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(dt)
    h = torch.matmul(y.float(), w1.to(dt).float().T) + b1.float()
    g = gelu(h, approximate="tanh" if gelu_approximate else "none").to(dt)
    o = torch.matmul(g.float(), w2.to(dt).float().T) + b2.float()
    return x + o.to(dt)


def fused_mlp_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-6,
    gelu_approximate: bool = False,
) -> torch.Tensor:
    """x [..., H] → x + W2·gelu(W1·LN(x) + b1) + b2; leading dims are
    flattened to rows."""
    _check_shapes(x, w1, w2)
    x2 = x.reshape(-1, x.shape[-1])
    # the operator cxr::fused_mlp_block (ops/library.py): B9 on CUDA tensors,
    # the plain version on CPU ones
    out = _OP(x2, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, float(eps),
              bool(gelu_approximate))
    return out.reshape(x.shape)


def fused_mlp_block_trainable(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-6,
    gelu_approximate: bool = False,
) -> torch.Tensor:
    """:func:`fused_mlp_block` with a gradient: the kernel forward, and the
    backward of the plain version recomputed from the saved inputs."""
    inputs = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _MLPBlock.apply(eps, gelu_approximate, *inputs)
    return fused_mlp_block(*inputs, eps=eps, gelu_approximate=gelu_approximate)


class _MLPBlock(torch.autograd.Function):
    """Saves only the seven inputs, as ``_mlp_block_vjp_fwd`` does."""

    @staticmethod
    def forward(ctx, eps, gelu_approximate, *inputs):
        ctx.eps, ctx.gelu_approximate = eps, gelu_approximate
        ctx.save_for_backward(*inputs)
        return fused_mlp_block(*inputs, eps=eps, gelu_approximate=gelu_approximate)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = fused_mlp_block_reference(*inputs, eps=ctx.eps,
                                            gelu_approximate=ctx.gelu_approximate)
        return (None, None, *torch.autograd.grad(out, inputs, g))


def _kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps, gelu_approximate):
    R, H = x.shape
    F = w1.shape[0]
    check_widths(H, F)  # the public function holds JAX's stricter rule
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_tensor(x, "x", bf, align=16)
    _build.check_tensor(w1, "w1", bf, (F, H), dev, align=16)
    _build.check_tensor(w2, "w2", bf, (H, F), dev, align=16)
    # the LayerNorm parameters and biases enter the kernel in fp32
    ls, lb, b1, b2 = (t.float() for t in (ln_scale, ln_bias, b1, b2))
    for t, name, n in ((ls, "ln_scale", H), (lb, "ln_bias", H), (b1, "b1", F), (b2, "b2", H)):
        _build.check_tensor(t, name, f32, (n,), dev, align=4)
    out = torch.empty_like(x)
    if R:
        y = torch.empty_like(x)  # the LayerNorm pass's output
        g = torch.empty((R, F), dtype=bf, device=dev)  # GEMM-1's output
        _build.launch(KERNEL, dev, x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                      y.data_ptr(), g.data_ptr(), R, H, F, float(eps), int(gelu_approximate))
    return out


def _fake(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_approximate):
    return torch.empty_like(x)


_OP = library.define(
    "fused_mlp_block",
    "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, Tensor w2, Tensor b2,"
    " float eps, bool gelu_approximate) -> Tensor",
    lambda x, ls, lb, w1, b1, w2, b2, eps, approx: fused_mlp_block_reference(
        x, ls, lb, w1, b1, w2, b2, eps=eps, gelu_approximate=approx),
    lambda x, ls, lb, w1, b1, w2, b2, eps, approx: _kernel(
        x, ls, lb, w1, b1, w2, b2, eps=eps, gelu_approximate=approx),
    _fake)
