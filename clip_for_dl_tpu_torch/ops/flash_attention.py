"""Packed-QKV fused attention: forward (kernel B3, ``csrc/flash_attention.cu``)
and backward (kernel B6, ``csrc/flash_attention_bwd.cu``).

Counterpart of ``clip_for_dl_tpu.ops.flash_attention.flash_attention_packed``:
qkv is one [B, N, 3·H·D] projection output (columns q-heads | k-heads |
v-heads), key_bias the [B, N] additive key-padding bias; the result is
[B, N, H·D]. Logits and softmax in fp32, probabilities normalized, then
dropped out (keep where ``uniform01 >= rate``, kept ones scaled by
1/(1 − rate)) and cast to the compute dtype before the PV product, fp32
accumulation.

Attention-probability dropout runs inside both kernels: the keep mask is the
JAX package's counter hash (:func:`uniform01`) over the absolute (query row,
key column) grid, seeded per batch row and head, so the backward regenerates
the forward's mask instead of storing it, and the bits equal the JAX
kernel's for the same seeds.

When a gradient is required the call goes through :class:`_FlashPacked`,
which saves only its inputs (qkv, bias, seeds) and recomputes the
probabilities in the backward, as the JAX custom VJP does. The bias and the
seeds get no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

KERNEL = "cxr_flash_fwd_packed"
KERNEL_BWD = "cxr_flash_bwd_packed"

# The kernels keep a query row's scores in registers, kMaxN / 32 per lane,
# and one head's K (and at D = 64 also V) in shared memory: 148 KB at
# N = 512 for D = 64 and 128, within a Hopper block's 227 KB. Longer
# sequences need a tiled-KV kernel.
MAX_SEQ_LEN = 512

_M32 = 0xFFFFFFFF


def _check_args(qkv: torch.Tensor, heads: int, key_bias, dropout_rate: float):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    B, N, HD3 = qkv.shape
    if N > MAX_SEQ_LEN:
        raise ValueError(
            f"flash attention supports sequence length ≤ {MAX_SEQ_LEN}; got N={N}"
        )
    if HD3 % (3 * heads):
        raise ValueError(f"last dim {HD3} not divisible by 3*heads")
    if key_bias is not None and tuple(key_bias.shape) != (B, N):
        raise ValueError(f"key_bias must be [B, N]={B, N}, got {tuple(key_bias.shape)}")
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    the product is split at bit 16, so each partial stays below 2^48."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def uniform01(seed, head, n_rows: int, n_cols: int) -> torch.Tensor:
    """Counter-based uniform [0, 1) grid, bit-equal to the JAX ``_uniform01``
    (murmur3 fmix32 over the (row, col) iota).

    ``seed`` and ``head`` are ints or integer tensors that broadcast against
    each other (for example seeds [B, 1] and heads [1, H]), on the seeds'
    device; the result has their shape followed by [n_rows, n_cols]. The
    arithmetic runs in int64 masked to 32 bits after every multiply, xor and
    shift, so torch's arithmetic ``>>`` acts as the logical shift of the
    uint32 hash."""
    seed = torch.as_tensor(seed).to(torch.int64) & _M32
    head = torch.as_tensor(head, dtype=torch.int64, device=seed.device)
    salt = (seed + _mul32(head & _M32, 0xC2B2AE3D)) & _M32
    dev = salt.device
    r = torch.arange(n_rows, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(n_cols, dtype=torch.int64, device=dev)[None, :]
    x = _mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77) ^ salt[..., None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dropout_seeds(generator: Optional[torch.Generator], batch: int,
                  device=None) -> torch.Tensor:
    """Per-batch-row int32 seeds [B, 1] on ``device`` for the in-kernel
    dropout hash (the counterpart of ``dropout_seeds_from_rng``), drawn from
    ``generator`` (the default generator of ``device`` when None)."""
    where = device if generator is None else generator.device
    seeds = torch.randint(-(2 ** 31), 2 ** 31, (batch, 1), dtype=torch.int32,
                          generator=generator, device=where)
    return seeds if device is None else seeds.to(device)


def _keep_mask(seeds: torch.Tensor, heads: int, n: int, rate: float) -> torch.Tensor:
    """[B, H, N, N] bool: keep where the hash is ≥ rate."""
    h = torch.arange(heads, device=seeds.device)[None, :]
    return uniform01(seeds.reshape(-1, 1), h, n, n) >= rate


# ---------------------------------------------------------------------------
# plain versions (the JAX _head_fwd / _head_bwd order)
# ---------------------------------------------------------------------------


def _split_heads(qkv: torch.Tensor, heads: int):
    B, N, HD3 = qkv.shape
    D = HD3 // (3 * heads)
    q, k, v = qkv.view(B, N, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v, D


def _probs(q, k, key_bias, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention_packed_reference(
    qkv: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the forward kernel's math (the JAX ``_head_fwd``)."""
    B, N, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, heads)
    p = _probs(q, k, key_bias, 1.0 / float(D) ** 0.5)
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seeds, heads, N, dropout_rate)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, N, heads * D)


def flash_attention_packed_bwd_reference(
    qkv: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the backward kernel's math (the JAX ``_head_bwd``):
    d(out) [B, N, H·D] → dqkv [B, N, 3·H·D] in qkv's dtype.

    s and p are recomputed in fp32; the dropped, scaled probabilities are
    cast to the compute dtype before ``dv = pdᵀ·do``; ``dp = do·vᵀ`` is
    masked and scaled; ``delta = rowsum(p ⊙ dp)`` from the fp32 p and dp;
    ``ds = p ⊙ (dp − delta)`` is cast before both ``dq = ds·k·scale`` and
    ``dk = dsᵀ·q·scale``."""
    B, N, _ = qkv.shape
    dt = qkv.dtype
    q, k, v, D = _split_heads(qkv, heads)
    scale = 1.0 / float(D) ** 0.5
    dof = do.reshape(B, N, heads, D).transpose(1, 2).float()
    p = _probs(q, k, key_bias, scale)
    dpd = torch.matmul(dof, v.float().transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seeds, heads, N, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dpd * inv, 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), dof)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dqkv = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], dim=2)  # [B, H, 3, N, D]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B, N, 3 * heads * D)


# ---------------------------------------------------------------------------
# entry point and autograd
# ---------------------------------------------------------------------------


def flash_attention_packed(
    qkv: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed-QKV attention: [B, N, 3·H·D] → [B, N, H·D]. ``dropout_rate > 0``
    needs ``dropout_seeds`` [B] or [B, 1] (int32, one stream per batch row;
    :func:`dropout_seeds` draws them)."""
    _check_args(qkv, heads, key_bias, dropout_rate)
    rate = float(dropout_rate)
    seeds = None
    if rate > 0.0:
        if dropout_seeds is None:
            raise ValueError("dropout_rate > 0 requires dropout_seeds")
        seeds = dropout_seeds.reshape(qkv.shape[0], 1).to(torch.int32)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashPacked.apply(qkv, key_bias, seeds, heads, rate)
    return _forward(qkv, heads, key_bias, rate, seeds)


def _forward(qkv, heads, key_bias, rate, seeds):
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(
            qkv, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds)
    return _kernel(qkv, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds)


class _FlashPacked(torch.autograd.Function):
    """Saves only (qkv, bias, seeds), as ``_flash_packed_fwd`` does; the
    backward recomputes s and p and regenerates the dropout mask."""

    @staticmethod
    def forward(ctx, qkv, key_bias, seeds, heads, rate):
        ctx.heads, ctx.rate = heads, rate
        ctx.save_for_backward(qkv, key_bias, seeds)
        return _forward(qkv, heads, key_bias, rate, seeds)

    @staticmethod
    def backward(ctx, do):
        qkv, key_bias, seeds = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        if qkv.device.type == "cpu":
            dqkv = flash_attention_packed_bwd_reference(
                qkv, do, ctx.heads, key_bias, dropout_rate=ctx.rate, dropout_seeds=seeds)
        else:
            dqkv = _kernel_bwd(qkv, do, ctx.heads, key_bias, dropout_rate=ctx.rate,
                               dropout_seeds=seeds)
        return dqkv, None, None, None, None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_args(qkv, heads, key_bias, dropout_rate, dropout_seeds):
    """Checks shared by both kernels; returns (D, bias, seeds) on the card."""
    B, N, HD3 = qkv.shape
    D = HD3 // (3 * heads)
    dev = qkv.device
    _build.check_tensor(qkv, "qkv", torch.bfloat16)
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported by the kernel (64 or 128)")
    if key_bias is None:
        key_bias = torch.zeros((B, N), dtype=torch.float32, device=dev)
    _build.check_tensor(key_bias, "key_bias", torch.float32, (B, N), dev, align=4)
    if dropout_rate > 0.0:
        if dropout_seeds is None:
            raise ValueError("dropout_rate > 0 requires dropout_seeds")
        _build.check_tensor(dropout_seeds, "dropout_seeds", torch.int32, (B, 1), dev,
                            align=4)
    else:
        dropout_seeds = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    return D, key_bias, dropout_seeds


def _kernel(qkv, heads, key_bias, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, _ = qkv.shape
    D, key_bias, seeds = _kernel_args(qkv, heads, key_bias, dropout_rate, dropout_seeds)
    out = torch.empty((B, N, heads * D), dtype=qkv.dtype, device=qkv.device)
    if B:
        _build.launch(KERNEL, qkv.device, qkv.data_ptr(), key_bias.data_ptr(),
                      seeds.data_ptr(), out.data_ptr(), B, N, heads, D,
                      1.0 / float(D) ** 0.5, float(dropout_rate),
                      1.0 / (1.0 - float(dropout_rate)))
    return out


def _kernel_bwd(qkv, do, heads, key_bias, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, HD3 = qkv.shape
    D, key_bias, seeds = _kernel_args(qkv, heads, key_bias, dropout_rate, dropout_seeds)
    dev = qkv.device
    _build.check_tensor(do, "do", torch.bfloat16, (B, N, heads * D), dev)
    dqkv = torch.empty_like(qkv)
    # per (batch row, head, query row): softmax max, sum and delta, fp32
    stats = torch.empty((3, B, heads, N), dtype=torch.float32, device=dev)
    if B:
        _build.launch(KERNEL_BWD, dev, qkv.data_ptr(), do.data_ptr(), key_bias.data_ptr(),
                      seeds.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N, heads, D,
                      1.0 / float(D) ** 0.5, float(dropout_rate),
                      1.0 / (1.0 - float(dropout_rate)))
    return dqkv
