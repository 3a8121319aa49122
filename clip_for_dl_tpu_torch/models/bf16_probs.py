"""The plain attention route with bf16 probabilities
(``bf16_attention_probs``; ``clip_for_dl_tpu.models.bert`` and ``vit``
cast the softmax output to bf16 before the dropout).

A bare ``.to(torch.bfloat16)`` after ``torch.softmax`` would save nothing:
the softmax's autograd keeps its fp32 output, and a product in fp32 keeps
an fp32 copy of its operand. Here the residuals of the probabilities are
bf16 alone: :class:`_Softmax16` computes the softmax in fp32 and saves and
returns it as bf16, its backward taking the gradient in fp32 from that bf16
p (JAX's takes it from the fp32 softmax it keeps); the dropout keeps its boolean mask; :class:`_ProbsV` saves the bf16
(dropped) probabilities and v and computes p @ v with fp32 products, as the
JAX einsum's ``preferred_element_type`` does. No fp32 [B, H, N, N] tensor
outlives the forward.

The dropout runs on the bf16 probabilities, as flax's ``Dropout`` does on
a bf16 array: kept entries divided by 1 − rate rounded to bf16 (the
Python scalar takes the array's type in JAX), the quotient rounded to
bf16.
"""

from __future__ import annotations

from typing import Optional

import torch


class _Softmax16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits):
        p = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        # the bf16 p sum to 1 only within their rounding: the weighted mean
        # of g over p, not Σ g·p, keeps the gradient's rows summing to zero
        # (softmax is blind to a shift of its logits, a key's bias among them)
        (p,) = ctx.saved_tensors
        p, g = p.float(), g.float()
        return p * (g - (g * p).sum(-1, keepdim=True) / p.sum(-1, keepdim=True))


class _ProbsV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return torch.matmul(p.float(), v.float()).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        g = g.float()
        gp = gv = None
        if ctx.needs_input_grad[0]:
            gp = torch.matmul(g, v.float().transpose(-1, -2)).to(p.dtype)
        if ctx.needs_input_grad[1]:
            gv = torch.matmul(p.float().transpose(-1, -2), g).to(v.dtype)
        return gp, gv


def attend_bf16(logits: torch.Tensor, v: torch.Tensor, keep: Optional[torch.Tensor] = None,
                rate: float = 0.0) -> torch.Tensor:
    """softmax(logits) as bf16, dropped where ``keep`` [B, H, N, N] is
    false (at ``rate``), times v: logits [B, H, N, N] fp32, v [B, H, N, d]
    → [B, H, N, d] in v's dtype."""
    p = _Softmax16.apply(logits)
    if keep is not None:
        scale = float(torch.tensor(1.0 - rate, dtype=torch.bfloat16))
        p = torch.where(keep, p / scale, torch.zeros((), dtype=p.dtype, device=p.device))
    return _ProbsV.apply(p, v)
