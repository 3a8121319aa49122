"""The tiled two-pass algorithm of the attention backward kernels B6 and B7
(``clip_for_dl_tpu_torch/csrc/flash_attention_bwd.cu``), emulated with torch
on the CPU and held against the plain backward and JAX's gradient.

The emulation follows the kernels' arithmetic, not their threads:

- rows pass: 64-key tiles of K and V, zero-filled past token N (keys ≥ N
  score −inf); sweep 1 keeps the online row max m, sum l and
  Σ exp(s − m)·dp, rescaled whenever m moves, then delta = that / l;
  sweep 2 recomputes s and dp, forms ds = p (dp − delta) and accumulates
  dq += ds·K tile by tile (the kernel reuses ds's accumulators as the A
  operand);
- columns pass, in the transposed form: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over
  tiles of 64 query rows (32 at D = 128), zero-filled past N, with p from
  the rows pass's (m, 1/l, delta) and masked to 0 on rows ≥ N; then
  dv += pdᵀ·dO and dk += dsᵀ·Q.

In fp32 every rounding of the kernel is left out, and the result must agree
with both references to 1e-5 of each gradient's largest entry (only the
summation order differs). With ``bf16`` the inputs are bf16 and pd, ds and
the outputs are rounded where the kernels round them; then it must agree
with the plain backward on the same bf16 inputs within two bf16 steps at
each gradient's largest entry (summation order may flip one rounding of an
intermediate and one of the output).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("clip_for_dl_tpu.ops.flash_attention")
from clip_for_dl_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

KEY_TILE = 64  # keys of a rows-pass tile
SEEDS = np.array([[7], [-99]], np.int32)


def query_tile(D: int) -> int:
    """Query rows of a columns-pass tile."""
    return 32 if D == 128 else 64


def _pad(t: torch.Tensor, tile: int, value: float = 0.0, dim: int = -2) -> torch.Tensor:
    """Token dim ``dim`` padded to whole tiles with ``value``: the
    zero-filled rows of a ragged tile."""
    n = t.shape[dim]
    extra = -(-n // tile) * tile - n
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_full(shape, value)], dim)


def tiled_bwd(q, k, v, do, bias, rate=0.0, seeds=None, bf16=False):
    """(dq, dk, dv) [B, H, N, D] fp32 from fp32 head-major q, k, v, d(out)
    and the [B, N] key bias, by the kernels' tiled two-pass algorithm."""
    B, H, N, D = q.shape
    scale = 1.0 / float(D) ** 0.5
    inv = 1.0 / (1.0 - rate)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    keep = (fa.uniform01(torch.from_numpy(seeds), torch.arange(H)[None], N, N) >= rate
            if rate else None)
    ninf = float("-inf")

    # -- rows pass --------------------------------------------------------------
    kp, vp = _pad(k, KEY_TILE), _pad(v, KEY_TILE)
    bp = _pad(bias, KEY_TILE, ninf, -1)[:, None, None, :]
    keep_r = _pad(keep, KEY_TILE, True, -1) if rate else None

    def scores(j0):
        kt, vt = kp[..., j0:j0 + KEY_TILE, :], vp[..., j0:j0 + KEY_TILE, :]
        s = q @ kt.transpose(-1, -2) * scale + bp[..., j0:j0 + KEY_TILE]
        dp = do @ vt.transpose(-1, -2)
        if rate:
            dp = torch.where(keep_r[..., j0:j0 + KEY_TILE], dp * inv, 0.0)
        return s, dp, kt

    tiles = range(0, kp.shape[-2], KEY_TILE)
    m = torch.full((B, H, N, 1), ninf)
    l = torch.zeros(B, H, N, 1)
    pdp = torch.zeros(B, H, N, 1)
    for j0 in tiles:  # sweep 1: online m, l and sum exp(s - m) dp
        s, dp, _ = scores(j0)
        mt = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mt == ninf, 0.0, mt)
        corr = torch.exp(m - mu)
        x = torch.exp(s - mu)
        l = l * corr + x.sum(-1, keepdim=True)
        pdp = pdp * corr + (x * dp).sum(-1, keepdim=True)
        m = mt
    delta, inv_l = pdp / l, 1.0 / l
    m = torch.where(m == ninf, 0.0, m)
    dq = torch.zeros(B, H, N, D)
    for j0 in tiles:  # sweep 2: ds, reused for dq tile by tile
        s, dp, kt = scores(j0)
        ds = rnd(torch.exp(s - m) * inv_l * (dp - delta))
        dq = dq + ds @ kt

    # -- columns pass, transposed ----------------------------------------------
    QT = query_tile(D)
    qp, dop = _pad(q, QT), _pad(do, QT)
    mT, lT, dT = (_pad(x[..., 0], QT, 0.0, -1)[:, :, None, :] for x in (m, inv_l, delta))
    valid = _pad(torch.ones(N, dtype=torch.bool), QT, False, -1)
    keep_c = _pad(keep.transpose(-1, -2), QT, True, -1) if rate else None  # [B, H, keys, rows]
    kb = bias[:, None, :, None]
    dk = torch.zeros(B, H, N, D)
    dv = torch.zeros(B, H, N, D)
    for i0 in range(0, qp.shape[-2], QT):
        cols = slice(i0, i0 + QT)
        qt, ot = qp[..., cols, :], dop[..., cols, :]
        sT = k @ qt.transpose(-1, -2) * scale + kb  # [B, H, keys, QT rows]
        dpT = v @ ot.transpose(-1, -2)
        p = torch.where(valid[cols], torch.exp(sT - mT[..., cols]) * lT[..., cols], 0.0)
        if rate:
            kt_ = keep_c[..., cols]
            pd, dpT = torch.where(kt_, p * inv, 0.0), torch.where(kt_, dpT * inv, 0.0)
        else:
            pd = p
        dsT = p * (dpT - dT[..., cols])
        dv = dv + rnd(pd) @ ot
        dk = dk + rnd(dsT) @ qt
    return rnd(dq * scale), rnd(dk * scale), rnd(dv)


SLICE = 64  # columns of a head-dim chunk and of a gradient slice, over D = 128


def sliced_bwd(q, k, v, do, bias, rate=0.0, seeds=None):
    """(dq, dk, dv) [B, H, N, D] fp32 by the sliced form the kernels run at
    D > 128: D zero-padded to a multiple of 64; one block per 64-column
    slice of each gradient, each recomputing S and dP as sums over 64-column
    chunks of the head dim (rows pass over 64-key tiles, columns pass over
    64-row query tiles); the columns pass reads slice 0's row statistics.
    Also returns every slice's (m, 1/l, delta)."""
    B, H, N, D = q.shape
    scale = 1.0 / float(D) ** 0.5
    inv = 1.0 / (1.0 - rate)
    ninf = float("-inf")
    W = -(-D // SLICE) * SLICE
    q, k, v, do = (torch.nn.functional.pad(t, (0, W - D)) for t in (q, k, v, do))
    chunks = [slice(c0, c0 + SLICE) for c0 in range(0, W, SLICE)]
    keep = (fa.uniform01(torch.from_numpy(seeds), torch.arange(H)[None], N, N) >= rate
            if rate else None)

    def chunked(a, b):  # a·bᵀ summed over the chunks of the head dim
        out = 0
        for c in chunks:
            out = out + a[..., c] @ b[..., c].transpose(-1, -2)
        return out

    # -- rows pass, one block a slice ----------------------------------------------
    kp, vp = _pad(k, KEY_TILE), _pad(v, KEY_TILE)
    bp = _pad(bias, KEY_TILE, ninf, -1)[:, None, None, :]
    keep_r = _pad(keep, KEY_TILE, True, -1) if rate else None
    tiles = range(0, kp.shape[-2], KEY_TILE)

    def scores(j0):
        kt, vt = kp[..., j0:j0 + KEY_TILE, :], vp[..., j0:j0 + KEY_TILE, :]
        s = chunked(q, kt) * scale + bp[..., j0:j0 + KEY_TILE]
        dp = chunked(do, vt)
        if rate:
            dp = torch.where(keep_r[..., j0:j0 + KEY_TILE], dp * inv, 0.0)
        return s, dp, kt

    dq, stats = [], []
    for c in chunks:
        m = torch.full((B, H, N, 1), ninf)
        l = torch.zeros(B, H, N, 1)
        pdp = torch.zeros(B, H, N, 1)
        for j0 in tiles:
            s, dp, _ = scores(j0)
            mt = torch.maximum(m, s.amax(-1, keepdim=True))
            mu = torch.where(mt == ninf, 0.0, mt)
            corr = torch.exp(m - mu)
            x = torch.exp(s - mu)
            l = l * corr + x.sum(-1, keepdim=True)
            pdp = pdp * corr + (x * dp).sum(-1, keepdim=True)
            m = mt
        delta, inv_l = pdp / l, 1.0 / l
        m = torch.where(m == ninf, 0.0, m)
        acc = torch.zeros(B, H, N, SLICE)
        for j0 in tiles:
            s, dp, kt = scores(j0)
            acc = acc + torch.exp(s - m) * inv_l * (dp - delta) @ kt[..., c]
        dq.append(acc)
        stats.append((m, inv_l, delta))

    # -- columns pass, one block a slice, slice 0's statistics --------------------
    QT = 64
    qp, dop = _pad(q, QT), _pad(do, QT)
    mT, lT, dT = (_pad(x[..., 0], QT, 0.0, -1)[:, :, None, :] for x in stats[0])
    valid = _pad(torch.ones(N, dtype=torch.bool), QT, False, -1)
    keep_c = _pad(keep.transpose(-1, -2), QT, True, -1) if rate else None
    kb = bias[:, None, :, None]
    dk, dv = [], []
    for c in chunks:
        dka = torch.zeros(B, H, N, SLICE)
        dva = torch.zeros(B, H, N, SLICE)
        for i0 in range(0, qp.shape[-2], QT):
            rows = slice(i0, i0 + QT)
            qt, ot = qp[..., rows, :], dop[..., rows, :]
            sT = chunked(k, qt) * scale + kb
            dpT = chunked(v, ot)
            p = torch.where(valid[rows], torch.exp(sT - mT[..., rows]) * lT[..., rows], 0.0)
            if rate:
                kt_ = keep_c[..., rows]
                pd, dpT = torch.where(kt_, p * inv, 0.0), torch.where(kt_, dpT * inv, 0.0)
            else:
                pd = p
            dva = dva + pd @ ot[..., c]
            dka = dka + p * (dpT - dT[..., rows]) @ qt[..., c]
        dk.append(dka)
        dv.append(dva)
    grads = (torch.cat(dq, -1) * scale, torch.cat(dk, -1) * scale, torch.cat(dv, -1))
    return tuple(g[..., :D] for g in grads), stats


def _case(N, D, seed=0, masked_row=False):
    """Head-major fp32 q, k, v, d(out) [2, 2, N, D] and a [2, N] bias with
    padded keys in batch row 0 (or, with ``masked_row``, every key of batch
    row 1 masked)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, 2, N, D)).astype(np.float32) for _ in range(4))
    bias = np.zeros((2, N), np.float32)
    bias[0, N // 2 + 1:] = -1e10
    if masked_row:
        bias[1] = -1e10
    return q, k, v, do, bias


def _jax_grads(q, k, v, do, bias, rate):
    def f(q_, k_, v_):
        return jfa.flash_attention_reference(
            q_, k_, v_, jnp.asarray(bias), dropout_rate=rate,
            dropout_seeds=jnp.asarray(SEEDS) if rate else None)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _check_fp32(N, D, rate, masked_row=False):
    q, k, v, do, bias = _case(N, D, seed=N + D, masked_row=masked_row)
    ts = [torch.from_numpy(a) for a in (q, k, v, do, bias)]
    got = tiled_bwd(*ts, rate=rate, seeds=SEEDS if rate else None)
    plain = fa.flash_attention_bwd_reference(
        *ts[:4], ts[4], dropout_rate=rate,
        dropout_seeds=torch.from_numpy(SEEDS) if rate else None)
    want_jax = _jax_grads(q, k, v, do, bias, rate)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, want_jax):
        assert torch.isfinite(g).all(), name
        tol = 1e-5 * float(p.abs().max())
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=tol, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("N", [1, 13, 64, 65, 200])
def test_tiled_backward_matches_plain_and_jax_in_fp32(N, D, rate):
    """fp32: within 1e-5 of each gradient's largest entry of the plain
    backward and of jax.vjp through the JAX reference; N below, at and above
    one tile, and several tiles (m moves between them)."""
    _check_fp32(N, D, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [64, 128])
def test_tiled_backward_with_a_fully_masked_row(D, rate):
    """Every key of batch row 1 at bias −1e10: uniform p over N keys in
    both references; the online max must not give exp(−inf + inf)."""
    _check_fp32(65, D, rate, masked_row=True)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("N", [1, 13, 64, 65, 200])
def test_tiled_backward_in_bf16_within_two_steps_of_the_plain_version(N, D, rate):
    """bf16 inputs, pd and ds rounded before their products, outputs
    rounded once: within two bf16 steps at each gradient's largest entry of
    the plain backward on the same bf16 tensors."""
    q, k, v, do, bias = _case(N, D, seed=2 * N + D)
    ts = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    got = tiled_bwd(*(t.float() for t in ts), torch.from_numpy(bias), rate=rate,
                    seeds=SEEDS if rate else None, bf16=True)
    plain = fa.flash_attention_bwd_reference(
        *ts, torch.from_numpy(bias), dropout_rate=rate,
        dropout_seeds=torch.from_numpy(SEEDS) if rate else None)
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        _, worst = fa.grad_slice_error(g, p, "bhnd")
        assert worst <= 1.0, (name, worst)


def _jax_split_grads(q, k, v, do, bias, rate):
    """Gradients of q, k, v through the JAX split kernel (interpret mode)."""
    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, jnp.asarray(bias), dropout_rate=rate,
                                   dropout_seeds=jnp.asarray(SEEDS) if rate else None,
                                   layout="bhnd", interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [160, 320])
@pytest.mark.parametrize("N", [13, 200])
def test_sliced_backward_matches_plain_and_jax_in_fp32(N, D, rate):
    """ROADMAP C4: the sliced form at D = 160 (padded to 192) and 320, fp32:
    within 1e-5 of each gradient's largest entry of the plain backward and
    of jax.vjp through the JAX split kernel in interpret mode; every slice's
    row statistics equal bit for bit, so the one slice that writes them
    writes what every slice used."""
    q, k, v, do, bias = _case(N, D, seed=N + D)
    ts = [torch.from_numpy(a) for a in (q, k, v, do, bias)]
    got, stats = sliced_bwd(*ts, rate=rate, seeds=SEEDS if rate else None)
    plain = fa.flash_attention_bwd_reference(
        *ts[:4], ts[4], dropout_rate=rate,
        dropout_seeds=torch.from_numpy(SEEDS) if rate else None)
    want_jax = _jax_split_grads(q, k, v, do, bias, rate)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, want_jax):
        assert torch.isfinite(g).all(), name
        tol = 1e-5 * float(p.abs().max())
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=tol, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, atol=tol, rtol=0, err_msg=name)
    assert all(torch.equal(a, b) for st in stats[1:] for a, b in zip(st, stats[0]))


def _train_like_case(B=8, H=2, N=200, D=64, seed=3):
    """bf16 head-major q, k, v, d(out) and a key bias whose row lengths are
    drawn from 3..N as in chip_smoke.py's train shape, with one row of 3
    keys and one of all N; and the lengths."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    lengths = rng.integers(3, N + 1, B)
    lengths[0], lengths[1] = 3, N
    bias = torch.from_numpy(np.where(np.arange(N)[None] < lengths[:, None], 0.0, -1e10)
                            .astype(np.float32))
    return (q, k, v, do), bias, lengths


def _dq_share_of_keys(q, k, v, do, bias, keys):
    """The part of the exact dq that the keys ``keys`` contribute."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale + bias[:, None, None, :], -1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return ds[..., keys] @ k[..., keys, :] * scale


@pytest.mark.parametrize("fault", ["dq_without_the_last_key_tile",
                                   "dk_dv_10_percent_off_in_rows_over_150_keys"])
def test_slice_tolerance_fails_a_planted_fault(fault):
    """grad_slice_error, the rule the GPU tests and chip_smoke.py hold B6 and
    B7 to, passes the bf16 emulation and fails each planted fault on
    train-like rows (3 to 200 keys): dk and dv scale like 1/(key count), so
    a tolerance from the whole tensor's largest entry, set by the 3-key
    row, would let a fault in the long rows through."""
    ops, bias, lengths = _train_like_case()
    got = list(tiled_bwd(*(t.float() for t in ops), bias, bf16=True))
    plain = [p.float() for p in fa.flash_attention_bwd_reference(*ops, bias)]
    for g, p in zip(got, plain):
        assert fa.grad_slice_error(g, p, "bhnd")[1] <= 1.0
    if fault == "dq_without_the_last_key_tile":
        last = slice((ops[0].shape[2] - 1) // KEY_TILE * KEY_TILE, None)
        bad = {0: (got[0] - _dq_share_of_keys(*ops, bias, last)).bfloat16().float()}
    else:
        long_rows = torch.from_numpy(lengths > 150)[:, None, None, None]
        bad = {i: torch.where(long_rows, got[i] * 1.1, got[i]) for i in (1, 2)}
        for i, b in bad.items():  # within 2^-6 of the whole tensor's largest entry
            assert (b - plain[i]).abs().max() <= 2.0 ** -6 * plain[i].abs().max(), i
    for i, b in bad.items():
        assert fa.grad_slice_error(b, plain[i], "bhnd")[1] > 1.0, i


def test_tiles_rescale_and_zero_fill():
    """The cases above reach the paths they name: at N = 200 the online max
    moves after the first key tile for most rows, and the last key tile and
    the last query tile are ragged."""
    q, k, _, _, bias = _case(200, 64)
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) / 8.0
    s = s + torch.from_numpy(bias)[:, None, None, :]
    first = s[..., :KEY_TILE].amax(-1)
    assert float((s.amax(-1) > first).float().mean()) > 0.5
    assert 200 % KEY_TILE and 200 % query_tile(64) and 200 % query_tile(128)
