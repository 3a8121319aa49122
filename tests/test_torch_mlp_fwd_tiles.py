"""The tiled algorithm of the MLP forward kernels B4
(``clip_for_dl_tpu_torch/csrc/mlp_train.cu``) and B9 (``csrc/mlp_block.cu``),
both on the GEMM pair of ``csrc/mlp_fwd.cuh``, emulated with torch on the
CPU and held against the plain versions and the JAX package's kernels.

The emulation follows the kernels' arithmetic, not their threads:

- B9's LayerNorm pass: the row's mean, then the mean of squared
  deviations, y = LN(x)·scale + bias in fp32, written out as bf16;
- GEMM-1: 128-row x 128-column tiles of [R, F], h = A·W1ᵀ summed in fp32
  over k-steps of 64 columns of H (A is x for B4, y for B9); then h + b1
  and GELU (exact erf, or tanh for B9's ``gelu_approximate``) in fp32, and
  g rounded to bf16 into the scratch;
- GEMM-2: 128 x 128 tiles of [R, H], o = g·W2ᵀ summed in fp32 over k-steps
  of 64 of F; then y = bf16(o + b2) for B4, out = bf16(x + bf16(o + b2))
  for B9.

Rows past R, and columns past F or H, are zero, as the TMA loads fill them,
and are cut at the store. In fp32 every rounding is left out and the result
must agree with the JAX kernel in interpret mode within 1e-5 (its A&S erf
is within 5.3e-7 of the exact erf used here). With ``bf16`` the inputs are
bf16 and y, g and the outputs are rounded where the kernels round them;
then the output (B9: the branch out - x) must agree with the plain version
on the same inputs within two bf16 steps at its largest entry, and be equal
to it but for at most 1% of its entries: the two round at the same points,
so only the fp32 summation order differs, which flips a bf16 rounding of an
entry with a chance of about 1e-3 (0.02-0.2% at these shapes). Planted
faults must fail that check; those that move every entry by less than a
bf16 step (g not rounded, the GELU forms swapped, the residual added before
o is rounded) change 8-42% of the entries.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.functional import gelu

jmlp = importlib.import_module("clip_for_dl_tpu.ops.mlp_train")
jblk = importlib.import_module("clip_for_dl_tpu.ops.mlp_block")
from clip_for_dl_tpu_torch.ops import mlp_block as blk
from clip_for_dl_tpu_torch.ops import mlp_train as mlp

torch.set_num_threads(1)

ROWS, COLS, K_STEP = 128, 128, 64  # a block tile's rows and columns, a k-step
TWO_STEPS = 2.0 ** -6
FLIP_SHARE = 0.01  # entries a summation-order flip of one rounding may change
EPS = 1e-6


def _pad(t: torch.Tensor, dim: int, tile: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to whole tiles: what a TMA load
    returns past the matrix's edge."""
    extra = -t.shape[dim] % tile
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def tiled_gemm(a, b, drop_last_k_step=False):
    """a [R, K]·b [N, K]ᵀ in fp32 by 128 x 128 output tiles, each summed over
    k-steps of 64; both operands K-major, zero-filled past their edges."""
    R, K = a.shape
    N = b.shape[0]
    ap, bp = _pad(a, 0, ROWS), _pad(b, 0, COLS)
    k_steps = range(0, K, K_STEP)
    if drop_last_k_step:
        k_steps = k_steps[:-1]
    out = torch.zeros(ap.shape[0], bp.shape[0])
    for r0 in range(0, ap.shape[0], ROWS):
        rows = slice(r0, r0 + ROWS)
        for c0 in range(0, bp.shape[0], COLS):
            cols = slice(c0, c0 + COLS)
            acc = torch.zeros(ROWS, COLS)
            for k0 in k_steps:
                ks = slice(k0, k0 + K_STEP)
                acc = acc + ap[rows, ks] @ bp[cols, ks].T
            out[rows, cols] = acc
    return out[:R, :N]


def _gelu_step(a, w1, b1, approximate, rnd, fault):
    """GEMM-1 and its epilogue: the scratch g."""
    h = tiled_gemm(a, w1, drop_last_k_step=fault == "last_k_step_dropped")
    if fault != "b1_skipped":
        h = h + b1
    if fault == "gelu_forms_swapped":
        approximate = not approximate
    g = gelu(h, approximate="tanh" if approximate else "none")
    return g if fault == "g_not_rounded" else rnd(g)


def _rounding(bf16: bool):
    return (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)


def tiled_fwd(x, w1, b1, w2, b2, bf16=False, fault=None):
    """B4's y in fp32 from fp32 x [R, H], w1 [F, H], b1 [F], w2 [H, F] and
    b2 [H]; ``fault`` plants one of FAULTS."""
    rnd = _rounding(bf16)
    g = _gelu_step(x, w1, b1, False, rnd, fault)
    return rnd(tiled_gemm(g, w2) + b2)


def tiled_block(x, ls, lb, w1, b1, w2, b2, approximate=False, bf16=False, fault=None):
    """B9's out in fp32 from fp32 x [R, H], the LayerNorm scale and bias
    [H], w1 [F, H], b1 [F], w2 [H, F] and b2 [H]."""
    rnd = _rounding(bf16)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = rnd((x - mean) * torch.rsqrt(var + EPS) * ls + lb)  # the LayerNorm pass
    g = _gelu_step(y, w1, b1, approximate, rnd, fault)
    o = tiled_gemm(g, w2) + b2
    if fault == "residual_before_rounding":
        return rnd(x + o)
    return rnd(x + rnd(o))


FAULTS = ("last_k_step_dropped", "b1_skipped", "g_not_rounded", "gelu_forms_swapped",
          "residual_before_rounding")


def _case(R, H, F, seed=0):
    """fp32 x, LayerNorm scale and bias, w1 [F, H], b1, w2 [H, F], b2 at the
    kernels' scales (weights at std fan_in^-1/2, biases and the LayerNorm
    parameters' spread at 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, H))
    ls = 1.0 + 0.1 * rng.standard_normal(H)
    lb = 0.1 * rng.standard_normal(H)
    w1 = rng.standard_normal((F, H)) / np.sqrt(H)
    b1 = 0.1 * rng.standard_normal(F)
    w2 = rng.standard_normal((H, F)) / np.sqrt(F)
    b2 = 0.1 * rng.standard_normal(H)
    return tuple(a.astype(np.float32) for a in (x, ls, lb, w1, b1, w2, b2))


def _assert_bf16_close(got, want, scale, what):
    """Within two bf16 steps at ``scale`` and equal but for FLIP_SHARE of
    the entries."""
    assert got.shape == want.shape, what
    diff = (got - want).abs()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TWO_STEPS * scale, rtol=0,
                               err_msg=what)
    share = float((diff > 0).float().mean())
    assert share <= FLIP_SHARE, f"{what}: {share:.4f} of the entries differ"


def _check_b4_bf16(case, fault=None):
    x, _, _, w1, b1, w2, b2 = (torch.from_numpy(a).bfloat16() for a in case)
    got = tiled_fwd(*(t.float() for t in (x, w1, b1, w2, b2)), bf16=True, fault=fault)
    want = mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2).float()
    _assert_bf16_close(got, want, float(want.abs().max()), "B4 y")


def _check_b9_bf16(case, approximate, fault=None):
    """bf16 x and weights, fp32 LayerNorm parameters and biases, as the ViT
    layer hands them over; the branch out - x is held."""
    x, ls, lb, w1, b1, w2, b2 = (torch.from_numpy(a) for a in case)
    x, w1, w2 = x.bfloat16(), w1.bfloat16(), w2.bfloat16()
    xf = x.float()
    got = tiled_block(xf, ls, lb, w1.float(), b1, w2.float(), b2, approximate, bf16=True,
                      fault=fault) - xf
    want = blk.fused_mlp_block_reference(x, ls, lb, w1, b1, w2, b2, eps=EPS,
                                         gelu_approximate=approximate).float() - xf
    _assert_bf16_close(got, want, float(want.abs().max()), "B9 out - x")


SHAPES = [(R, H, F) for R in (1, 127, 129) for H in (64, 192, 256) for F in (128, 320)]


@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_b4_matches_jax_kernel_in_fp32(R, H, F):
    """fp32 y within 1e-5 of JAX ``dense_gelu_dense(interpret=True)``:
    ragged row tiles (1, 127, 129 rows), H of one to four k-steps and past a
    128-column tile, F of one column tile and past two."""
    x, _, _, w1, b1, w2, b2 = _case(R, H, F, seed=R + H + F)
    got = tiled_fwd(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    want = jmlp.dense_gelu_dense(*(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2)),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_b4_in_bf16_within_two_steps_of_the_plain_version(R, H, F):
    """bf16 inputs, g rounded before the second product, y rounded once:
    within two bf16 steps of ``dense_gelu_dense_reference`` on the same
    inputs, and equal to it but for FLIP_SHARE of the entries."""
    _check_b4_bf16(_case(R, H, F, seed=2 * R + H + F))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_b9_matches_jax_kernel_in_fp32(R, H, F, approximate):
    """fp32 out within 1e-5 of JAX ``fused_mlp_block(interpret=True)`` where
    H and F are multiples of 128 (its rule), else of its pallas_call
    ``_pallas_mlp_2d(interpret=True)``, for both GELU forms."""
    x, ls, lb, w1, b1, w2, b2 = _case(R, H, F, seed=R + H + F + 1)
    got = tiled_block(*(torch.from_numpy(a) for a in (x, ls, lb, w1, b1, w2, b2)),
                      approximate=approximate)
    j = [jnp.asarray(a) for a in (x, ls, lb, w1.T, b1, w2.T, b2)]
    if H % 128 == 0 and F % 128 == 0:
        want = jblk.fused_mlp_block(*j, eps=EPS, gelu_approximate=approximate,
                                    interpret=True)
    else:
        row = [j[0], j[1][None], j[2][None], j[3], j[4][None], j[5], j[6][None]]
        want = jblk._pallas_mlp_2d(*row, eps=EPS, approximate=approximate, block_rows=128,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_b9_in_bf16_within_two_steps_of_the_plain_version(R, H, F, approximate):
    """bf16 y from the LayerNorm pass, g rounded, o rounded before the
    residual: the branch out - x within two bf16 steps of
    ``fused_mlp_block_reference``'s at its largest entry, and equal to it
    but for FLIP_SHARE of the entries, for both GELU forms."""
    _check_b9_bf16(_case(R, H, F, seed=2 * R + H + F + 1), approximate)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_check(fault):
    """A tile that skips its last k-step of H, an epilogue without b1, g
    left unrounded, the GELU forms swapped (B9) and the residual added
    before o is rounded (B9) each fail the check that the right algorithm
    passes, for B4 where the fault applies to it and for B9."""
    case = _case(129, 192, 320, seed=4)
    _check_b4_bf16(case)
    _check_b9_bf16(case, False)
    if fault not in ("gelu_forms_swapped", "residual_before_rounding"):
        with pytest.raises(AssertionError):
            _check_b4_bf16(case, fault=fault)
    with pytest.raises(AssertionError):
        _check_b9_bf16(case, False, fault=fault)


def test_the_shapes_reach_the_edges():
    """The cases above reach the paths they name: a ragged last row tile, a
    ragged last F tile, a ragged last H tile of GEMM-2, H and F not
    multiples of 128, and shapes where JAX's own 128 rule holds."""
    assert 129 % ROWS and 127 % ROWS and 320 % COLS and 192 % COLS and 64 < COLS
    assert all(H % K_STEP == 0 and F % K_STEP == 0 for _, H, F in SHAPES)
    assert any(H % 128 == 0 and F % 128 == 0 for _, H, F in SHAPES)
    assert any(H % 128 for _, H, _ in SHAPES) and any(F % 128 for _, _, F in SHAPES)
