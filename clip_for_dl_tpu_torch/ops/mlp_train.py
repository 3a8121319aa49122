"""Fused Dense→GELU→Dense: forward (kernel B4, ``csrc/mlp_train.cu``) and
backward (kernel B8, ``csrc/mlp_train_bwd.cu``).

Counterpart of ``clip_for_dl_tpu.ops.mlp_train.dense_gelu_dense``:

    y = gelu(x @ w1.T + b1) @ w2.T + b2

with the weights in ``nn.Linear`` layout (w1 [F, H], w2 [H2, F]; the JAX
function takes them transposed). Both products accumulate in fp32, GELU is
exact erf in fp32 and its output is cast to x's dtype before the second
product.

B4 replaces the TPU kernel ``_fwd_kernel`` (``clip_for_dl_tpu/ops/
mlp_train.py:99``) and is two wgmma kernels fed by TMA
(``csrc/mlp_fwd.cuh``): ``g = bf16(gelu(x·W1ᵀ + b1))`` into a scratch
[rows, F] that the wrapper allocates, then ``y = g·W2ᵀ + b2``. Both are
bound by tensor-core math. The TPU kernel kept g on chip; on the card a
fused kernel would hold an fp32 [64, H] output accumulator a warpgroup
(49,152 registers at H = 768, all 65,536 of an SM at H = 1024), so g passes
through device memory, rounded where the TPU kernel rounds it.

When a gradient is required the call goes through :class:`_MLP`, which saves
only (x, w1, b1, w2, b2), as the JAX custom VJP does. Its backward runs B8,
which recomputes h from x and returns dx with the bf16 ``g = gelu(h)`` and
``dh = (dy·W2)⊙gelu′(h)``; the two weight gradients are then plain products
outside the kernel (``dW1 = dhᵀ·x``, ``dW2 = dyᵀ·g``), and the bias
gradients fp32 sums, as ``_mlp_bwd`` does. B8 is two wgmma kernels fed by
TMA too (g and dh, then dx = dh·W1). B4 and B8 take any hidden and
intermediate width that is a multiple of 64 (:func:`check_widths`).
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "cxr_mlp_fwd"
KERNEL_BWD = "cxr_mlp_bwd"
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * _INV_SQRT2))


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU′(h) = Φ(h) + h·φ(h)."""
    return 0.5 * (1.0 + torch.erf(h * _INV_SQRT2)) + h * torch.exp(-0.5 * h * h) * _INV_SQRT2PI


def dense_gelu_dense_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the forward kernel's math."""
    h = torch.matmul(x.float(), w1.float().T) + b1.float()
    g = _gelu(h).to(x.dtype)
    return (torch.matmul(g.float(), w2.float().T) + b2.float()).to(x.dtype)


def dense_gelu_dense_bwd_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    dy: torch.Tensor,
):
    """Plain version of the backward kernel's math (the JAX ``_bwd_kernel``):
    returns (dx, g, dh), all in x's dtype, with ``g = gelu(h)`` and
    ``dh = (dy·W2)⊙gelu′(h)`` rounded before ``dx = dh·W1``."""
    h = torch.matmul(x.float(), w1.float().T) + b1.float()
    g = _gelu(h).to(x.dtype)
    dg = torch.matmul(dy.float(), w2.float())
    dh = (dg * _gelu_grad(h)).to(x.dtype)
    dx = torch.matmul(dh.float(), w1.float()).to(x.dtype)
    return dx, g, dh


def dense_gelu_dense(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """x [..., H] → [..., H2]; leading dims are flattened to rows."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        out = _MLP.apply(x2, w1, b1, w2, b2)
    else:
        out = _forward(x2, w1, b1, w2, b2)
    return out.reshape(*lead, w2.shape[0])


def _forward(x, w1, b1, w2, b2):
    if x.device.type == "cpu":
        return dense_gelu_dense_reference(x, w1, b1, w2, b2)
    return _kernel(x, w1, b1, w2, b2)


class _MLP(torch.autograd.Function):
    """Saves only (x, w1, b1, w2, b2); the backward recomputes h in B8."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx, g, dh = dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)
        else:
            dx, g, dh = _kernel_bwd(x, w1, b1, w2, dy)
        # the weight gradients are two plain full-size products (fp32
        # accumulation, output in the weights' dtype), as in ``_mlp_bwd``
        dw1 = torch.matmul(dh.T, x).to(w1.dtype)
        dw2 = torch.matmul(dy.T, g).to(w2.dtype)
        db1 = dh.float().sum(dim=0).to(b1.dtype)
        db2 = dy.float().sum(dim=0).to(b2.dtype)
        return dx, dw1, db1, dw2, db2


def check_widths(H: int, F: int) -> None:
    """Raise unless the MLP kernels (B4, B8 and B9) take hidden ``H`` and
    intermediate ``F``: positive multiples of 64, their TMA box and
    k-step."""
    for name, n in (("hidden", H), ("intermediate", F)):
        if n <= 0 or n % 64:
            raise ValueError(f"{name} {n} must be a positive multiple of 64")


def _check_kernel_args(x, w1, b1, w2):
    """(R, H, F) once x, w1, b1 and w2 are what B4 and B8 take; the TMA
    loads want 16-byte aligned operands."""
    R, H = x.shape
    F = w1.shape[0]
    check_widths(H, F)
    dev = x.device
    bf = torch.bfloat16
    _build.check_tensor(x, "x", bf, align=16)
    _build.check_tensor(w1, "w1", bf, (F, H), dev, align=16)
    _build.check_tensor(b1, "b1", bf, (F,), dev, align=2)
    _build.check_tensor(w2, "w2", bf, (H, F), dev, align=16)
    return R, H, F


def _kernel(x, w1, b1, w2, b2):
    R, H, F = _check_kernel_args(x, w1, b1, w2)
    _build.check_tensor(b2, "b2", torch.bfloat16, (H,), x.device, align=2)
    y = torch.empty((R, H), dtype=torch.bfloat16, device=x.device)
    if R:
        g = torch.empty((R, F), dtype=torch.bfloat16, device=x.device)  # GEMM-1's output
        _build.launch(KERNEL, x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), y.data_ptr(), g.data_ptr(), R, H, F)
    return y


def _kernel_bwd(x, w1, b1, w2, dy):
    R, H, F = _check_kernel_args(x, w1, b1, w2)
    _build.check_tensor(dy, "dy", torch.bfloat16, (R, H), x.device, align=16)
    bf = torch.bfloat16
    dx = torch.empty((R, H), dtype=bf, device=x.device)
    g = torch.empty((R, F), dtype=bf, device=x.device)
    dh = torch.empty((R, F), dtype=bf, device=x.device)
    if R:
        _build.launch(KERNEL_BWD, x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), dy.data_ptr(), dx.data_ptr(), g.data_ptr(),
                      dh.data_ptr(), R, H, F)
    return dx, g, dh
