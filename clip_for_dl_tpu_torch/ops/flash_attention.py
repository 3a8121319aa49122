"""Fused attention in two forms, each with a forward and a backward kernel.

- Packed qkv, counterpart of ``clip_for_dl_tpu.ops.flash_attention.
  flash_attention_packed``: one [B, N, 3·H·D] projection output (columns
  q-heads | k-heads | v-heads) → [B, N, H·D]; kernels B3 (forward,
  ``csrc/flash_attention.cu``) and B6 (backward,
  ``csrc/flash_attention_bwd.cu``). Both towers call this form.
- Split q/k/v, counterpart of ``flash_attention``: three tensors in
  ``layout`` "bnhd" ([B, N, H, D], the towers' bytes) or "bhnd"
  ([B, H, N, D]) → the output in the same layout; kernels B5 and B7, the
  same two kernel bodies as B3 and B6 with other strides (no transpose
  copy), so split q/k/v sliced from a packed qkv give the packed form's
  bits, dropout included.

key_bias is the [B, N] additive key-padding bias. Logits and softmax in
fp32, probabilities normalized, then dropped out (keep where ``uniform01 >=
rate``, kept ones scaled by 1/(1 − rate)) and cast to the compute dtype
before the PV product, fp32 accumulation. The JAX package pads N to a
multiple of 8 with bias −1e30 on the padded keys; here nothing is padded:
the kernels skip keys j ≥ N.

Attention-probability dropout runs inside every kernel: the keep mask is the
JAX package's counter hash (:func:`uniform01`) over the absolute (query row,
key column) grid, seeded per batch row and head, so the backward regenerates
the forward's mask instead of storing it, and the bits equal the JAX
kernel's for the same seeds.

``head_offset`` h0 (default 0) numbers the call's heads h0, h0 + 1, …
in that hash: a tensor-parallel rank that holds heads h0 … h0 + H − 1 of a
layer draws the masks those heads draw in the unsharded call. The hash
salts a head as ``seed + head · 0xC2B2AE3D`` (mod 2^32; ``csrc/common.cuh
dropout_salt``), so heads numbered from h0 under ``seed`` are heads
numbered from 0 under ``seed + h0 · 0xC2B2AE3D``: the wrappers hand the
kernels that seed (:func:`offset_seeds`), the kernels are unchanged, and
at h0 = 0 the seeds, and so the bits, are the ones before.

When a gradient is required the call goes through :class:`_FlashPacked` or
:class:`_Flash`, which save only their inputs (q/k/v or qkv, bias, seeds), as
the JAX custom VJPs do, and recompute the probabilities in the backward. The
bias and the seeds get no gradient.

Types: q, k and v (or qkv) of one type in :data:`DTYPES`, which the
outputs keep, as the JAX kernels build their outputs from q's dtype. bf16
and fp16 run the tensor-core bodies, the 16-bit type a template parameter
(probabilities and ds rounded to it before their products); fp32, the
parity mode (``--fp32``), runs CUDA-core bodies in fp32 FMAs, where that
rounding is a no-op. Each type has its own C entry points
(:data:`SUFFIXES`), so each counts its own launches.

Head dims: the 16-bit kernels are built for D ∈ :data:`HEAD_DIMS` (32, 64,
128) and, over 128, for every multiple of :data:`SLICE` (64), which they
run in 64-column slices of the output (one block a slice) with the
contractions over D taken in 64-column chunks. Any other D runs through the
next wider one (:func:`_kernel_dim`): the wrappers copy each head's q, k, v
(and d(out)) into zero-padded rows, which leaves q·kᵀ unchanged and gives
zero output (and gradient) columns, launch with the scale of the original D
and slice the result (:func:`_pad_heads`, :func:`_unpad_heads`). The pad is
a copy of the operands and of the result; no preset reaches it or D > 128
(they use D = 64). The fp32 kernels loop over any D in chunks and take it
as it is.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, library

KERNEL = "cxr_flash_fwd_packed"
KERNEL_BWD = "cxr_flash_bwd_packed"
KERNEL_SPLIT = "cxr_flash_fwd"
KERNEL_SPLIT_BWD = "cxr_flash_bwd"

# the operand types the kernels take, and the suffix of each one's entry
# points (KERNEL + suffix; bf16's are the names above)
SUFFIXES = {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}
DTYPES = tuple(SUFFIXES)


def entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel ``name`` (one of the four above) for
    operands of ``dtype``; raises TypeError for a type no kernel takes."""
    if dtype not in SUFFIXES:
        raise TypeError(f"the attention kernels take {', '.join(map(str, DTYPES))}, "
                        f"not {dtype}")
    return name + SUFFIXES[dtype]

LAYOUTS = ("bnhd", "bhnd")

# The kernels (B3, B5, B6, B7) stream 64-token tiles, so their shared
# memory does not grow with N but for one key-bias row (2 KB at 512); they
# keep the JAX package's bound.
MAX_SEQ_LEN = 512
# head dims the kernels are built for up to 128, and the width of a slice
# over 128 (any multiple of it is built); others are padded to the next
HEAD_DIMS = (32, 64, 128)
SLICE = 64

_M32 = 0xFFFFFFFF


def _check_common(B: int, N: int, key_bias, dropout_rate: float) -> None:
    if N > MAX_SEQ_LEN:
        raise ValueError(
            f"flash attention supports sequence length ≤ {MAX_SEQ_LEN}; got N={N}"
        )
    if key_bias is not None and tuple(key_bias.shape) != (B, N):
        raise ValueError(f"key_bias must be [B, N]={B, N}, got {tuple(key_bias.shape)}")
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")


def _check_args(qkv: torch.Tensor, heads: int, key_bias, dropout_rate: float):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    B, N, HD3 = qkv.shape
    _check_common(B, N, key_bias, dropout_rate)
    if HD3 % (3 * heads):
        raise ValueError(f"last dim {HD3} not divisible by 3*heads")


def _dims(t: torch.Tensor, layout: str) -> Tuple[int, int, int, int]:
    """(B, N, H, D) of a split operand in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if t.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D ({layout}), got {tuple(t.shape)}")
    B, a, b, D = t.shape
    return (B, a, b, D) if layout == "bnhd" else (B, b, a, D)


def _check_split(q, k, v, key_bias, dropout_rate: float, layout: str):
    B, N, H, D = _dims(q, layout)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must have one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_common(B, N, key_bias, dropout_rate)
    return B, N, H, D


def _seeds(dropout_seeds, batch: int, rate: float):
    """[B, 1] int32 seeds when ``rate > 0`` (required then), else None."""
    if rate <= 0.0:
        return None
    if dropout_seeds is None:
        raise ValueError("dropout_rate > 0 requires dropout_seeds")
    return dropout_seeds.reshape(batch, 1).to(torch.int32)


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


def warn_bf16_probs_ignored() -> None:
    """Both towers' flash route ignores ``bf16_attention_probs``, a
    residual-dtype switch of the plain route: the kernels keep no
    probabilities (the backward recomputes them). The JAX package's warning,
    word for word."""
    import warnings

    warnings.warn(
        "bf16_attention_probs is ignored when flash attention "
        "is enabled: the flash kernel saves no probability "
        "residual (its whole point); set one or the other",
        stacklevel=3,
    )


def _keep_mask(seeds: torch.Tensor, heads: int, n: int, rate: float,
               head_offset: int = 0) -> torch.Tensor:
    """[B, H, N, N] bool: keep where the hash of heads head_offset … is ≥ rate."""
    h = torch.arange(head_offset, head_offset + heads, device=seeds.device)[None, :]
    return uniform01(seeds.reshape(-1, 1), h, n, n) >= rate


_SALT = 0xC2B2AE3D  # the hash's per-head salt multiplier (csrc/common.cuh)


def offset_seeds(seeds: Optional[torch.Tensor], head_offset: int) -> Optional[torch.Tensor]:
    """int32 seeds under which head j hashes as head ``head_offset`` + j did
    under ``seeds``: seed + head_offset · 0xC2B2AE3D mod 2^32 (``seeds``
    itself at offset 0 or without seeds)."""
    if seeds is None or not head_offset:
        return seeds
    shift = (int(head_offset) * _SALT) & _M32
    wrapped = (seeds.to(torch.int64) + shift) & _M32
    return torch.where(wrapped >= 2 ** 31, wrapped - 2 ** 32, wrapped).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (the JAX _head_fwd / _head_bwd order), head-major
# ---------------------------------------------------------------------------


def _fp32(*ts):
    """fp32 contiguous copies: every layout then runs the same products, so
    the plain versions of the two forms and both layouts agree bit for bit."""
    return [t.float().contiguous() for t in ts]


def _split_heads(qkv: torch.Tensor, heads: int):
    B, N, HD3 = qkv.shape
    D = HD3 // (3 * heads)
    q, k, v = qkv.view(B, N, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v, D


def _probs(q, k, key_bias, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def _scale(D: int, scale: Optional[float]) -> float:
    return 1.0 / float(D) ** 0.5 if scale is None else scale


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Plain version of the forward kernels' math (the JAX ``_head_fwd``) on
    head-major q, k, v [B, H, N, D] → [B, H, N, D] in q's dtype; the
    counterpart of the JAX ``flash_attention_reference``. ``scale`` of the
    logits is 1/√D unless given (as the kernels get it for a padded D);
    ``head_offset`` numbers the heads from there in the dropout hash."""
    B, H, N, D = q.shape
    qf, kf, vf = _fp32(q, k, v)
    p = _probs(qf, kf, key_bias, _scale(D, scale))
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seeds, H, N, dropout_rate, head_offset)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    return torch.matmul(p.to(q.dtype).float(), vf).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    head_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels' math (the JAX ``_head_bwd``):
    head-major q, k, v and d(out) [B, H, N, D] → (dq, dk, dv) [B, H, N, D]
    in q's dtype; ``scale`` and ``head_offset`` as in
    :func:`flash_attention_reference`.

    s and p are recomputed in fp32; the dropped, scaled probabilities are
    cast to the compute dtype before ``dv = pdᵀ·do``; ``dp = do·vᵀ`` is
    masked and scaled; ``delta = rowsum(p ⊙ dp)`` from the fp32 p and dp;
    ``ds = p ⊙ (dp − delta)`` is cast before both ``dq = ds·k·scale`` and
    ``dk = dsᵀ·q·scale``."""
    B, H, N, D = q.shape
    dt = q.dtype
    qf, kf, vf, dof = _fp32(q, k, v, do)
    scale = _scale(D, scale)
    p = _probs(qf, kf, key_bias, scale)
    dpd = torch.matmul(dof, vf.transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seeds, H, N, dropout_rate, head_offset)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dpd * inv, 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), dof)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_packed_reference(
    qkv: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Plain version of B3: :func:`flash_attention_reference` over qkv's
    head slices, [B, N, 3·H·D] → [B, N, H·D]."""
    B, N, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, heads)
    out = flash_attention_reference(q, k, v, key_bias, dropout_rate=dropout_rate,
                                    dropout_seeds=dropout_seeds, scale=scale,
                                    head_offset=head_offset)
    return out.transpose(1, 2).reshape(B, N, heads * D)


def flash_attention_packed_bwd_reference(
    qkv: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Plain version of B6: d(out) [B, N, H·D] → dqkv [B, N, 3·H·D] in qkv's
    dtype, through :func:`flash_attention_bwd_reference`."""
    B, N, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, heads)
    grads = flash_attention_bwd_reference(
        q, k, v, do.reshape(B, N, heads, D).transpose(1, 2), key_bias,
        dropout_rate=dropout_rate, dropout_seeds=dropout_seeds, scale=scale,
        head_offset=head_offset)
    dqkv = torch.stack(grads, dim=2)  # [B, H, 3, N, D]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B, N, 3 * heads * D)


# A backward kernel's gradient against the plain version's, by operand type:
# (relative, absolute floor). Each (batch row, head) slice is held within
# two steps of the type (bf16 2^-6, fp16 2^-9) of that slice's own largest
# entry, plus an absolute floor for slices that are zero in exact arithmetic
# (with one key ds = p (dp − delta) = 0, which the kernels' two passes meet
# only to fp32 rounding); in fp32, whose kernels round nothing and differ
# from the plain version by summation order alone over at most 512 keys and
# the head dim, within 1e-4 of it plus 1e-6.
GRAD_TOL = {torch.bfloat16: (2.0 ** -6, 1e-5), torch.float16: (2.0 ** -9, 1e-5),
            torch.float32: (1e-4, 1e-6)}


def fwd_tolerance(want: torch.Tensor) -> float:
    """A forward kernel's tolerance (max abs) against the plain version's
    output ``want``, by its type: bf16 2e-2 (two bf16 steps at |o| ≤ 3: a
    summation-order flip of a probability's or of the output's rounding);
    fp16 the same two steps of fp16 at ``want``'s largest entry; fp32 1e-5
    (summation order alone)."""
    if want.dtype == torch.float32:
        return 1e-5
    if want.dtype == torch.float16:
        top = float(want.float().abs().max())
        return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 10) if top > 0 else 1e-7
    return 2e-2


def grad_slice_error(got: torch.Tensor, want: torch.Tensor, layout: str,
                     heads: Optional[int] = None,
                     dtype: torch.dtype = torch.bfloat16) -> Tuple[float, float]:
    """(largest |got − want|, largest ratio of a slice's max |got − want| to
    its tolerance) over the (batch row, head) slices of an attention
    gradient; the gradient passes when the ratio is ≤ 1. The tolerance is
    :data:`GRAD_TOL` of ``dtype``, the kernel's operand type.

    ``layout`` is "packed" (B6's dqkv [B, N, 3·H·D] with ``heads``; dq, dk
    and dv of a head are three slices), "bnhd" or "bhnd" (one of B7's
    gradients). The tolerance is set per slice because dk and dv scale like
    1/(the row's key count): one tolerance from the whole tensor's largest
    entry would be set by the shortest batch rows and pass a wrong gradient
    in the long ones."""
    got, want = got.float(), want.float()
    if layout == "packed":
        B, N, _ = want.shape
        got, want = (t.reshape(B, N, 3, heads, -1) for t in (got, want))
        dims = (1, 4)
    elif layout in LAYOUTS:
        dims = (1, 3) if layout == "bnhd" else (2, 3)
    else:
        raise ValueError(f"layout must be 'packed', 'bnhd' or 'bhnd', got {layout!r}")
    rel, floor = GRAD_TOL[dtype]
    err = (got - want).abs().amax(dims)
    tol = rel * want.abs().amax(dims) + floor
    return float(err.max()), float((err / tol).max())


def _head_major(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A split operand as [B, H, N, D] (a view), or back from it."""
    return t if layout == "bhnd" else t.transpose(1, 2)


# ---------------------------------------------------------------------------
# entry points and autograd
# ---------------------------------------------------------------------------


def flash_attention_packed(
    qkv: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Packed-QKV attention: [B, N, 3·H·D] → [B, N, H·D]. ``dropout_rate > 0``
    needs ``dropout_seeds`` [B] or [B, 1] (int32, one stream per batch row;
    :func:`dropout_seeds` draws them); ``head_offset`` numbers the heads
    in the dropout hash from there (a tensor-parallel rank's heads)."""
    _check_args(qkv, heads, key_bias, dropout_rate)
    rate = float(dropout_rate)
    seeds = offset_seeds(_seeds(dropout_seeds, qkv.shape[0], rate), head_offset)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashPacked.apply(qkv, key_bias, seeds, heads, rate)
    return _forward(qkv, heads, key_bias, rate, seeds)


def _forward(qkv, heads, key_bias, rate, seeds):
    """The packed forward through the operator ``cxr::flash_attention_packed``
    (``ops/library.py``): B3 on CUDA tensors, the plain version on CPU ones."""
    return _OP(qkv, heads, key_bias, rate, seeds)


def flash_attention_packed_bwd(
    qkv: torch.Tensor,
    do: torch.Tensor,
    heads: int,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Backward of :func:`flash_attention_packed`: d(out) [B, N, H·D] →
    dqkv [B, N, 3·H·D] (kernel B6; the plain version on CPU tensors)."""
    _check_args(qkv, heads, key_bias, dropout_rate)
    rate = float(dropout_rate)
    seeds = offset_seeds(_seeds(dropout_seeds, qkv.shape[0], rate), head_offset)
    do = do.to(qkv.dtype).contiguous()
    if qkv.device.type == "cpu":
        return flash_attention_packed_bwd_reference(
            qkv, do, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds)
    return _kernel_bwd(qkv, do, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds)


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
        dqkv = flash_attention_packed_bwd(qkv, do, ctx.heads, key_bias,
                                          dropout_rate=ctx.rate, dropout_seeds=seeds)
        return dqkv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    layout: str = "bhnd",
    head_offset: int = 0,
) -> torch.Tensor:
    """Split q/k/v attention over all heads of each batch row. ``layout``
    "bnhd" takes [B, N, H, D] (the towers' [B, N, H·D] projection outputs,
    viewed), "bhnd" head-major [B, H, N, D]; the output comes back in the
    same layout. ``key_bias`` [B, N] is the additive key-padding bias;
    ``dropout_rate > 0`` needs ``dropout_seeds`` [B] or [B, 1];
    ``head_offset`` as in :func:`flash_attention_packed`."""
    B = _check_split(q, k, v, key_bias, dropout_rate, layout)[0]
    rate = float(dropout_rate)
    seeds = offset_seeds(_seeds(dropout_seeds, B, rate), head_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, key_bias, seeds, layout, rate)
    return _forward_split(q, k, v, key_bias, rate, seeds, layout)


def _forward_split(q, k, v, key_bias, rate, seeds, layout):
    if q.device.type == "cpu":
        out = flash_attention_reference(
            *(_head_major(t, layout) for t in (q, k, v)), key_bias, dropout_rate=rate,
            dropout_seeds=seeds)
        return _head_major(out, layout).contiguous()
    return _kernel_split(q, k, v, key_bias, layout, dropout_rate=rate, dropout_seeds=seeds)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seeds: Optional[torch.Tensor] = None,
    layout: str = "bhnd",
    head_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_attention`: d(out) in ``layout`` → (dq, dk,
    dv) in ``layout`` (kernel B7; the plain version on CPU tensors)."""
    B = _check_split(q, k, v, key_bias, dropout_rate, layout)[0]
    if do.shape != q.shape:
        raise ValueError(f"d(out) must have q's shape {tuple(q.shape)}, got {tuple(do.shape)}")
    rate = float(dropout_rate)
    seeds = offset_seeds(_seeds(dropout_seeds, B, rate), head_offset)
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        grads = flash_attention_bwd_reference(
            *(_head_major(t, layout) for t in (q, k, v, do)), key_bias, dropout_rate=rate,
            dropout_seeds=seeds)
        return tuple(_head_major(g, layout).contiguous() for g in grads)
    return _kernel_split_bwd(q, k, v, do, key_bias, layout, dropout_rate=rate,
                             dropout_seeds=seeds)


class _Flash(torch.autograd.Function):
    """Saves only (q, k, v, bias, seeds), as ``_flash_fwd`` does; the
    backward recomputes s and p and regenerates the dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seeds, layout, rate):
        ctx.layout, ctx.rate = layout, rate
        ctx.save_for_backward(q, k, v, key_bias, seeds)
        return _forward_split(q, k, v, key_bias, rate, seeds, layout)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, seeds = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, key_bias, dropout_rate=ctx.rate,
                                         dropout_seeds=seeds, layout=ctx.layout)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_dim(D: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The head dim that runs head dim ``D`` in ``dtype``: in fp32, D itself;
    in a 16-bit type the narrowest of :data:`HEAD_DIMS` that holds it, or
    over 128 the next multiple of :data:`SLICE`."""
    if dtype == torch.float32:
        return D
    for width in HEAD_DIMS:
        if D <= width:
            return width
    return -(-D // SLICE) * SLICE


def _pad_heads(t: torch.Tensor, D: int, width: int) -> torch.Tensor:
    """``t`` with every run of ``D`` values along its last dim (the heads of
    a packed [B, N, k·H·D], or a split operand's [..., D]) zero-padded to
    ``width``: a new contiguous tensor, or ``t`` itself when D = width."""
    if D == width:
        return t
    lead = t.shape[:-1]
    runs = t.reshape(*lead, t.shape[-1] // D, D)
    return torch.nn.functional.pad(runs, (0, width - D)).reshape(*lead, -1)


def _unpad_heads(t: torch.Tensor, D: int, width: int) -> torch.Tensor:
    """The inverse of :func:`_pad_heads`: the first ``D`` of every ``width``
    values along the last dim, as a contiguous copy (``t`` when D = width)."""
    if D == width:
        return t
    lead = t.shape[:-1]
    return t.reshape(*lead, t.shape[-1] // width, width)[..., :D].reshape(*lead, -1)


def _side_args(B, N, dev, key_bias, dropout_rate, dropout_seeds):
    """Checks shared by every kernel; returns (bias, seeds) on the card."""
    if N > MAX_SEQ_LEN:
        raise ValueError(f"the kernel takes sequence length ≤ MAX_SEQ_LEN = {MAX_SEQ_LEN}; "
                         f"got N={N}")
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
    return key_bias, dropout_seeds


def _rate_args(D, dropout_rate):
    """(scale, rate, 1 / (1 − rate)) of a launch; the scale is that of the
    caller's head dim ``D``, also when the kernel runs a padded one."""
    return 1.0 / float(D) ** 0.5, float(dropout_rate), 1.0 / (1.0 - float(dropout_rate))


def _align(dtype) -> int:
    """Bytes the kernels of ``dtype`` ask of their operands' addresses: the
    16-bit bodies copy and store 16-byte pieces, the fp32 ones scalars."""
    return 4 if dtype == torch.float32 else 16


def _kernel(qkv, heads, key_bias, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, HD3 = qkv.shape
    name = entry(KERNEL, qkv.dtype)
    _build.check_tensor(qkv, "qkv", qkv.dtype, align=_align(qkv.dtype))
    D = HD3 // (3 * heads)
    W = _kernel_dim(D, qkv.dtype)
    key_bias, seeds = _side_args(B, N, qkv.device, key_bias, dropout_rate, dropout_seeds)
    qkv = _pad_heads(qkv, D, W)
    out = torch.empty((B, N, heads * W), dtype=qkv.dtype, device=qkv.device)
    if B:
        _build.launch(name, qkv.device, qkv.data_ptr(), key_bias.data_ptr(),
                      seeds.data_ptr(), out.data_ptr(), B, N, heads, W,
                      *_rate_args(D, dropout_rate))
    return _unpad_heads(out, D, W)


def _kernel_bwd(qkv, do, heads, key_bias, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, HD3 = qkv.shape
    dev = qkv.device
    name = entry(KERNEL_BWD, qkv.dtype)
    _build.check_tensor(qkv, "qkv", qkv.dtype, align=_align(qkv.dtype))
    D = HD3 // (3 * heads)
    W = _kernel_dim(D, qkv.dtype)
    key_bias, seeds = _side_args(B, N, dev, key_bias, dropout_rate, dropout_seeds)
    _build.check_tensor(do, "do", qkv.dtype, (B, N, heads * D), dev, align=_align(qkv.dtype))
    qkv, do = _pad_heads(qkv, D, W), _pad_heads(do, D, W)
    dqkv = torch.empty_like(qkv)
    # per (batch row, head, query row): softmax max, 1 / sum and delta, fp32
    stats = torch.empty((3, B, heads, N), dtype=torch.float32, device=dev)
    if B:
        _build.launch(name, dev, qkv.data_ptr(), do.data_ptr(), key_bias.data_ptr(),
                      seeds.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N, heads, W,
                      *_rate_args(D, dropout_rate))
    return _unpad_heads(dqkv, D, W)


def _strides_fit(t: torch.Tensor) -> bool:
    """The head dim contiguous and, for the 16-bit kernels, every other
    stride of a dim longer than 1 a multiple of 16 bytes and the data
    16-byte aligned (fp32: every stride a whole number of 32-bit words,
    which its element stride is)."""
    if t.stride(3) != 1:
        return False
    if t.dtype == torch.float32:
        return True
    el = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % el == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _operand(t: torch.Tensor, name: str, layout: str, device, width: int, dtype):
    """(tensor, its (batch, token, head) strides in 32-bit words) for a split
    kernel: ``dtype`` on ``device``; a head dim below ``width`` is
    zero-padded to it (:func:`_pad_heads`), and strides that the kernels
    cannot address (the head dim not contiguous, or for a 16-bit type
    strides or data off the 16-byte grid of their 16-byte copies and stores)
    get a contiguous copy."""
    _build.check_device(t, name, device)
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape[3] != width:
        t = _pad_heads(t, t.shape[3], width)
    elif not _strides_fit(t):
        t = t.clone(memory_format=torch.contiguous_format)
    el = t.element_size()
    sb, s1, s2 = (s * el // 4 if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3]))
    return t, ((sb, s1, s2) if layout == "bnhd" else (sb, s2, s1))


def _strides(*word_strides) -> ctypes.Array:
    flat = [s for triple in word_strides for s in triple]
    return (ctypes.c_longlong * len(flat))(*flat)


def _kernel_split(q, k, v, key_bias, layout, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, H, D = _dims(q, layout)
    dt, dev = q.dtype, q.device
    name = entry(KERNEL_SPLIT, dt)
    W = _kernel_dim(D, dt)
    (q, sq), (k, sk), (v, sv) = (_operand(t, n, layout, dev, W, dt)
                                 for t, n in ((q, "q"), (k, "k"), (v, "v")))
    key_bias, seeds = _side_args(B, N, dev, key_bias, dropout_rate, dropout_seeds)
    out, so = _operand(torch.empty(q.shape, dtype=dt, device=dev), "out", layout, dev, W, dt)
    if B:
        _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      key_bias.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                      _strides(sq, sk, sv, so), B, N, H, W, *_rate_args(D, dropout_rate))
    return _unpad_heads(out, D, W)


def _kernel_split_bwd(q, k, v, do, key_bias, layout, *, dropout_rate=0.0, dropout_seeds=None):
    B, N, H, D = _dims(q, layout)
    dt, dev = q.dtype, q.device
    name = entry(KERNEL_SPLIT_BWD, dt)
    W = _kernel_dim(D, dt)
    (q, sq), (k, sk), (v, sv), (do, sdo) = (
        _operand(t, n, layout, dev, W, dt)
        for t, n in ((q, "q"), (k, "k"), (v, "v"), (do, "do")))
    key_bias, seeds = _side_args(B, N, dev, key_bias, dropout_rate, dropout_seeds)
    (dq, sdq), (dk, sdk), (dv, sdv) = (
        _operand(torch.empty(q.shape, dtype=dt, device=dev), n, layout, dev, W, dt)
        for n in ("dq", "dk", "dv"))
    # per (batch row, head, query row): softmax max, 1 / sum and delta, fp32
    stats = torch.empty((3, B, H, N), dtype=torch.float32, device=dev)
    if B:
        _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), key_bias.data_ptr(), seeds.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                      _strides(sq, sk, sv, sdo, sdq, sdk, sdv), B, N, H, W,
                      *_rate_args(D, dropout_rate))
    return tuple(_unpad_heads(g, D, W) for g in (dq, dk, dv))


def _fake(qkv, heads, key_bias, dropout_rate, dropout_seeds):
    B, N, HD3 = qkv.shape
    return qkv.new_empty((B, N, HD3 // 3))


_OP = library.define(
    "flash_attention_packed",
    "(Tensor qkv, int heads, Tensor? key_bias, float dropout_rate, Tensor? dropout_seeds)"
    " -> Tensor",
    lambda qkv, heads, key_bias, rate, seeds: flash_attention_packed_reference(
        qkv, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds),
    lambda qkv, heads, key_bias, rate, seeds: _kernel(
        qkv, heads, key_bias, dropout_rate=rate, dropout_seeds=seeds),
    _fake)
