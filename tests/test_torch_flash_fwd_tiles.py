"""The tiled two-sweep algorithm of the attention forward kernels B3 and B5
(``clip_for_dl_tpu_torch/csrc/flash_attention.cu``), emulated with torch on
the CPU and held against the plain forward and the JAX package's kernel.

The emulation follows the kernels' arithmetic, not their threads: K and V
in 64-key tiles, zero-filled past token N, keys ≥ N scoring −inf; sweep 1
keeps the online row max m and sum l, rescaled whenever m moves; a row with
no finite score takes m = 0; sweep 2 forms s again, p = exp(s − m)·(1/l),
drops it out with the hash over absolute (row, key) coordinates and feeds
bf16(p) to o += p·V tile by tile. It also returns the PV operand, the
[B, H, N, keys] probabilities as they enter the product.

In fp32 every rounding is left out and the output must agree with the plain
version and with JAX's kernel in interpret mode within 1e-5; with ``bf16``
the inputs are bf16 and p and o are rounded where the kernels round them,
and the output must agree with both within 2e-2 (two bf16 steps at
|o| ≤ 3), and the PV operand with bf16 of the plain version's dropped-out
probabilities within one bf16 step. Planted faults, among them a one-sweep
online softmax that rounds the unnormalized p before the division, must
fail those checks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("clip_for_dl_tpu.ops.flash_attention")
from clip_for_dl_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

KEY_TILE = 64  # keys of a tile
SEEDS = np.array([[7], [-99]], np.int32)
NINF = float("-inf")


def _pad(t: torch.Tensor, value: float = 0.0, dim: int = -2) -> torch.Tensor:
    """Token dim ``dim`` padded to whole key tiles with ``value``: the
    zero-filled rows of a ragged tile."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = -(-n // KEY_TILE) * KEY_TILE - n
    return torch.cat([t, t.new_full(shape, value)], dim)


def tiled_fwd(q, k, v, bias, rate=0.0, seeds=None, bf16=False, fault=None):
    """(o [B, H, N, D], the PV operand [B, H, N, keys padded to whole tiles])
    in fp32 from fp32 head-major q, k, v and the [B, N] key bias, by the
    kernels' two-sweep algorithm; ``fault`` plants one of FAULTS."""
    B, H, N, D = q.shape
    scale = 1.0 / float(D) ** 0.5
    inv = 1.0 / (1.0 - rate)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    kp, vp = _pad(k), _pad(v)
    bp = _pad(bias, 0.0 if fault == "keys_past_n_unmasked" else NINF, -1)[:, None, None, :]
    tiles = range(0, kp.shape[-2], KEY_TILE)

    def scores(j0):
        kt = kp[..., j0:j0 + KEY_TILE, :]
        return q @ kt.transpose(-1, -2) * scale + bp[..., j0:j0 + KEY_TILE]

    def keep(j0):
        """The tile's keep mask, hashed at absolute (row, key) coordinates."""
        cols = j0 + KEY_TILE
        u = fa.uniform01(torch.from_numpy(seeds), torch.arange(H)[None], N, cols)
        u = u[..., j0:] if fault != "dropout_in_tile_coordinates" else u[..., :KEY_TILE]
        return u >= rate

    m = torch.full((B, H, N, 1), NINF)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, D)
    pv = []
    if fault == "p_rounded_before_the_division":  # one sweep, FlashAttention's online form
        for j0 in tiles:
            s = scores(j0)
            mt = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - mt)
            e = torch.exp(s - mt)
            if rate:
                e = torch.where(keep(j0), e * inv, 0.0)
            l = l * corr + torch.exp(s - mt).sum(-1, keepdim=True)
            pv.append(rnd(e))
            o = o * corr + pv[-1] @ vp[..., j0:j0 + KEY_TILE, :]
            m = mt
        return rnd(o / l), torch.cat(pv, -1)

    for j0 in tiles:  # sweep 1: online m and l
        s = scores(j0)
        mt = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mt == NINF, 0.0, mt)
        l = l * torch.exp(m - mu) + torch.exp(s - mu).sum(-1, keepdim=True)
        m = mt
    inv_l = 1.0 / l
    m = torch.where(m == NINF, 0.0, m)  # no finite score: exp(s - m) is 0, not NaN
    for j0 in tiles:  # sweep 2: normalized p, dropped out, rounded, into PV
        p = torch.exp(scores(j0) - m) * inv_l
        if rate:
            p = torch.where(keep(j0), p * inv, 0.0)
        pv.append(rnd(p))
        o = o + pv[-1] @ vp[..., j0:j0 + KEY_TILE, :]
    return rnd(o), torch.cat(pv, -1)


SLICE = 64  # columns of a head-dim chunk and of an output slice, over D = 128


def sliced_fwd(q, k, v, bias, rate=0.0, seeds=None):
    """(o [B, H, N, D], the (m, 1/l) of every slice) in fp32 by the sliced
    form the kernels run at D > 128: D zero-padded to a multiple of 64, one
    block per 64-column slice of o, each running both sweeps with
    s = Σ over 64-column chunks of q_c·k_cᵀ, V's slice alone in PV."""
    B, H, N, D = q.shape
    scale = 1.0 / float(D) ** 0.5
    inv = 1.0 / (1.0 - rate)
    W = -(-D // SLICE) * SLICE
    qp, kp, vp = (torch.nn.functional.pad(t, (0, W - D)) for t in (q, k, v))
    kp, vp = _pad(kp), _pad(vp)
    bp = _pad(bias, NINF, -1)[:, None, None, :]
    tiles = range(0, kp.shape[-2], KEY_TILE)
    chunks = range(0, W, SLICE)

    def scores(j0):
        s = torch.zeros(B, H, N, KEY_TILE)
        for c0 in chunks:
            s = s + qp[..., c0:c0 + SLICE] @ kp[..., j0:j0 + KEY_TILE, c0:c0 + SLICE].transpose(-1, -2)
        return s * scale + bp[..., j0:j0 + KEY_TILE]

    outs, stats = [], []
    for c0 in chunks:  # one block a slice
        m = torch.full((B, H, N, 1), NINF)
        l = torch.zeros(B, H, N, 1)
        for j0 in tiles:
            s = scores(j0)
            mt = torch.maximum(m, s.amax(-1, keepdim=True))
            mu = torch.where(mt == NINF, 0.0, mt)
            l = l * torch.exp(m - mu) + torch.exp(s - mu).sum(-1, keepdim=True)
            m = mt
        inv_l = 1.0 / l
        m = torch.where(m == NINF, 0.0, m)
        o = torch.zeros(B, H, N, SLICE)
        for j0 in tiles:
            p = torch.exp(scores(j0) - m) * inv_l
            if rate:
                u = fa.uniform01(torch.from_numpy(seeds), torch.arange(H)[None], N, j0 + KEY_TILE)
                p = torch.where(u[..., j0:] >= rate, p * inv, 0.0)
            o = o + p @ vp[..., j0:j0 + KEY_TILE, c0:c0 + SLICE]
        outs.append(o)
        stats.append((m, inv_l))
    return torch.cat(outs, -1)[..., :D], stats


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [160, 320])
@pytest.mark.parametrize("N", [13, 200])
def test_sliced_forward_matches_plain_and_jax_in_fp32(N, D, rate):
    """ROADMAP C4: the sliced form at D = 160 (padded to 192) and 320, fp32:
    within 1e-5 of the plain forward and of the JAX packed kernel in
    interpret mode, and every slice's row statistics equal bit for bit."""
    qkv_np, bias_np = _case(N, D, seed=N + D)
    qkv, bias = torch.from_numpy(qkv_np), torch.from_numpy(bias_np)
    kw = dict(dropout_rate=rate, dropout_seeds=torch.from_numpy(SEEDS)) if rate else {}
    jkw = dict(dropout_rate=rate, dropout_seeds=jnp.asarray(SEEDS)) if rate else {}
    o, stats = sliced_fwd(*_heads(qkv), bias, rate=rate, seeds=SEEDS)
    got = o.transpose(1, 2).reshape(2, N, -1)
    plain = fa.flash_attention_packed_reference(qkv, 2, bias, **kw)
    want_jax = np.asarray(jfa.flash_attention_packed(jnp.asarray(qkv_np), 2, jnp.asarray(bias_np),
                                                     interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5, rtol=0)
    assert all(torch.equal(a, b) for st in stats[1:] for a, b in zip(st, stats[0]))


FAULTS = ("p_rounded_before_the_division", "dropout_in_tile_coordinates",
          "keys_past_n_unmasked")


def _case(N, D, seed=0, masked_row=False):
    """Packed fp32 qkv [2, N, 3·2·D] (2 heads) and a [2, N] bias with padded
    keys in batch row 0 (or, with ``masked_row``, every key of batch row 1
    masked)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, N, 3 * 2 * D)).astype(np.float32)
    bias = np.zeros((2, N), np.float32)
    bias[0, N // 2 + 1:] = -1e10
    if masked_row:
        bias[1] = -1e10
    return qkv, bias


def _heads(qkv: torch.Tensor, H: int = 2):
    """Head-major fp32 q, k, v of a packed qkv."""
    B, N, _ = qkv.shape
    return [t.float() for t in qkv.view(B, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0)]


def _plain_pv(qkv: torch.Tensor, bias: torch.Tensor, rate: float) -> torch.Tensor:
    """bf16 of the plain version's dropped-out probabilities, as they enter
    PV, padded with zero columns to whole key tiles."""
    q, k, _ = _heads(qkv)
    p = fa._probs(q, k, bias, 1.0 / float(q.shape[-1]) ** 0.5)
    if rate:
        keep = fa._keep_mask(torch.from_numpy(SEEDS), 2, q.shape[2], rate)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return _pad(p.to(torch.bfloat16).float(), 0.0, -1)


def _check(qkv_np, bias_np, rate, bf16, fault=None):
    """The emulation's output against the plain forward and JAX's kernel in
    interpret mode on the same (bf16 or fp32) inputs, and in bf16 its PV
    operand against the plain version's; raises AssertionError on a miss."""
    dt = torch.bfloat16 if bf16 else torch.float32
    qkv = torch.from_numpy(qkv_np).to(dt)
    bias = torch.from_numpy(bias_np)
    B, N, _ = qkv.shape
    kw = dict(dropout_rate=rate, dropout_seeds=torch.from_numpy(SEEDS)) if rate else {}
    o, pv = tiled_fwd(*_heads(qkv), bias, rate=rate, seeds=SEEDS, bf16=bf16, fault=fault)
    got = o.transpose(1, 2).reshape(B, N, -1)
    plain = fa.flash_attention_packed_reference(qkv, 2, bias, **kw).float()
    jkw = dict(dropout_rate=rate, dropout_seeds=jnp.asarray(SEEDS)) if rate else {}
    jqkv = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16 if bf16 else jnp.float32)
    want_jax = np.asarray(jfa.flash_attention_packed(jqkv, 2, jnp.asarray(bias_np),
                                                     interpret=True, **jkw), np.float32)
    assert torch.isfinite(got).all()
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=tol, rtol=0)
    if bf16:
        want_pv = _plain_pv(qkv, bias, rate)
        np.testing.assert_allclose(pv.numpy(), want_pv.numpy(), rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("N", [1, 13, 64, 65, 200])
def test_tiled_forward_matches_plain_and_jax_in_fp32(N, D, rate):
    """fp32: within 1e-5 of the plain forward and of the JAX kernel in
    interpret mode; N below, at and above one key tile, and several tiles
    (m moves between them)."""
    _check(*_case(N, D, seed=N + D), rate, bf16=False)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [1, 13, 64, 65, 200])
def test_tiled_forward_in_bf16_matches_plain_and_jax(N, D, rate):
    """bf16 inputs, p and o rounded where the kernels round them: output
    within 2e-2 of the plain forward and the JAX kernel on the same bf16
    inputs, and the PV operand within one bf16 step of the plain version's
    bf16 probabilities (1/l multiplied, not divided, may flip a rounding)."""
    _check(*_case(N, D, seed=2 * N + D), rate, bf16=True)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tiled_forward_with_a_fully_masked_row(rate):
    """Every key of batch row 1 at bias −1e10: uniform p over the N keys in
    both references, which the online max must reproduce."""
    _check(*_case(65, 64, masked_row=True), rate, bf16=False)
    _check(*_case(65, 64, masked_row=True), rate, bf16=True)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_checks(fault):
    """Each planted fault, at N = 200 (ragged last tile, m moving) with
    dropout 0.1 in bf16, fails the checks the right algorithm passes: the
    one-sweep online softmax rounds exp(s − m) before the division (its PV
    operand is off by the factor l), hashing in tile coordinates drops other
    elements, and zero-filled keys that score 0 instead of −inf take
    probability from the real ones."""
    case = _case(200, 64, seed=5)
    _check(*case, 0.1, bf16=True)
    with pytest.raises(AssertionError):
        _check(*case, 0.1, bf16=True, fault=fault)


def test_tiles_rescale_and_zero_fill():
    """The cases above reach the paths they name: at N = 200 the online max
    moves after the first key tile for most rows, and the last tile is
    ragged."""
    qkv, bias = _case(200, 64)
    q, k, _ = _heads(torch.from_numpy(qkv))
    s = q @ k.transpose(-1, -2) / 8.0 + torch.from_numpy(bias)[:, None, None, :]
    first = s[..., :KEY_TILE].amax(-1)
    assert float((s.amax(-1) > first).float().mean()) > 0.5
    assert 200 % KEY_TILE
