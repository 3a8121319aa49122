"""The tiled algorithm of the MLP backward kernel B8
(``clip_for_dl_tpu_torch/csrc/mlp_train_bwd.cu``), emulated with torch on the
CPU and held against the plain backward and the JAX package's kernel.

The emulation follows the kernels' arithmetic, not their threads:

- B8a: 128-row x 128-column tiles of [R, F]; h = x·W1ᵀ and dg = dy·W2 summed
  in fp32 over k-steps of 64 columns of H; then, per tile, h + b1, GELU and
  GELU′ in fp32, and g and dh rounded to bf16;
- B8b: 128 x 128 tiles of dx = dh·W1 from the bf16 dh, summed in fp32 over
  k-steps of 64 of F, then rounded.

Rows past R, and columns past F or H, are zero, as the TMA loads fill them,
and are cut at the store. In fp32 every rounding is left out and the result
must agree with JAX's backward kernel in interpret mode within 1e-5 (the
JAX kernel's A&S erf is within 5.3e-7 of the exact erf used here). With
``bf16`` the inputs are bf16 and g, dh and dx are rounded where the kernels
round them; then each output must agree with the plain backward on the
same bf16 inputs within two bf16 steps at its largest entry. Planted faults
must fail that check.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jmlp = importlib.import_module("clip_for_dl_tpu.ops.mlp_train")
from clip_for_dl_tpu_torch.ops import mlp_train as mlp

torch.set_num_threads(1)

ROWS, COLS, K_STEP = 128, 128, 64  # a block tile's rows and columns, a k-step
TWO_STEPS = 2.0 ** -6


def _pad(t: torch.Tensor, dim: int, tile: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to whole tiles: what a TMA load
    returns past the matrix's edge."""
    extra = -t.shape[dim] % tile
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def tiled_bwd(x, w1, b1, w2, dy, bf16=False, fault=None):
    """(dx, g, dh) in fp32 from fp32 x, dy [R, H], w1 [F, H], b1 [F] and
    w2 [H, F] by the kernels' tiled algorithm; ``fault`` plants one of
    FAULTS."""
    R, H = x.shape
    F = w1.shape[0]
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    xp, dyp = _pad(x, 0, ROWS), _pad(dy, 0, ROWS)
    w1p, b1p, w2p = _pad(w1, 0, COLS), _pad(b1, 0, COLS), _pad(w2, 1, COLS)
    k_steps = range(0, H, K_STEP)
    if fault == "last_k_step_dropped":
        k_steps = k_steps[:-1]
    g = torch.zeros(xp.shape[0], w1p.shape[0])
    dh = torch.zeros_like(g)
    for r0 in range(0, xp.shape[0], ROWS):  # B8a
        rows = slice(r0, r0 + ROWS)
        for f0 in range(0, w1p.shape[0], COLS):
            cols = slice(f0, f0 + COLS)
            h = torch.zeros(ROWS, COLS)
            dg = torch.zeros(ROWS, COLS)
            for k0 in k_steps:
                ks = slice(k0, k0 + K_STEP)
                h = h + xp[rows, ks] @ w1p[cols, ks].T
                dg = dg + dyp[rows, ks] @ w2p[ks, cols]
            h = h + b1p[cols]
            grad = (0.5 * (1.0 + torch.erf(h * mlp._INV_SQRT2)) if fault == "gelu_grad_without_pdf"
                    else mlp._gelu_grad(h))
            g[rows, cols] = rnd(mlp._gelu(h))
            dh[rows, cols] = rnd(dg * grad)
    g, dh = g[:, :F], dh[:, :F]
    w1n = _pad(w1, 1, COLS)  # W1 read N-major: columns past H are zero
    dx = torch.zeros(xp.shape[0], w1n.shape[1])
    for r0 in range(0, xp.shape[0], ROWS):  # B8b
        rows = slice(r0, r0 + ROWS)
        for n0 in range(0, w1n.shape[1], COLS):
            cols = slice(n0, n0 + COLS)
            acc = torch.zeros(ROWS, COLS)
            for k0 in range(0, F, K_STEP):
                ks = slice(k0, k0 + K_STEP)
                acc = acc + dh[rows, ks] @ w1n[ks, cols]
            dx[rows, cols] = rnd(acc)
    return dx[:R, :H], g[:R], dh[:R]


FAULTS = ("last_k_step_dropped", "gelu_grad_without_pdf")


def _case(R, H, F, seed=0):
    """fp32 x, w1 [F, H], b1, w2 [H, F], dy at the kernels' scales (weights
    at std fan_in^-1/2, b1 at 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, H)).astype(np.float32)
    w1 = (rng.standard_normal((F, H)) / np.sqrt(H)).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((H, F)) / np.sqrt(F)).astype(np.float32)
    dy = rng.standard_normal((R, H)).astype(np.float32)
    return x, w1, b1, w2, dy


def _check_bf16(case, fault=None):
    ts = [torch.from_numpy(a).bfloat16() for a in case]
    got = tiled_bwd(*(t.float() for t in ts), bf16=True, fault=fault)
    want = mlp.dense_gelu_dense_bwd_reference(*ts)
    for name, a, b in zip(("dx", "g", "dh"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.float().numpy(),
                                   atol=TWO_STEPS * float(b.float().abs().max()), rtol=0,
                                   err_msg=name)


SHAPES = [(R, H, F) for R in (1, 127, 129) for H in (64, 192, 256) for F in (64, 320)]


@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_backward_matches_jax_kernel_in_fp32(R, H, F):
    """fp32 (dx, g, dh) within 1e-5 of JAX ``_pallas_bwd(interpret=True)``:
    ragged row tiles (1, 127, 129 rows), H of one to four k-steps and F past
    and below one 128-column tile."""
    x, w1, b1, w2, dy = _case(R, H, F, seed=R + H + F)
    got = tiled_bwd(*(torch.from_numpy(a) for a in (x, w1, b1, w2, dy)))
    want = jmlp._pallas_bwd(*(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, dy)),
                            approximate=False, interpret=True)
    for name, a, b in zip(("dx", "g", "dh"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("R,H,F", SHAPES)
def test_tiled_backward_in_bf16_within_two_steps_of_the_plain_version(R, H, F):
    """bf16 inputs, g and dh rounded before dx = dh·W1, every output rounded
    once: within two bf16 steps at each output's largest entry of
    ``dense_gelu_dense_bwd_reference`` on the same bf16 inputs."""
    _check_bf16(_case(R, H, F, seed=2 * R + H + F))


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_check(fault):
    """A tile that skips its last k-step of H, and GELU′ without its h·φ(h)
    term, each fail the check that the right algorithm passes."""
    case = _case(129, 192, 320, seed=4)
    _check_bf16(case)
    with pytest.raises(AssertionError):
        _check_bf16(case, fault=fault)


def test_the_shapes_reach_the_edges():
    """The cases above reach the paths they name: a ragged last row tile, a
    ragged last F tile and a ragged last dx column tile."""
    assert 129 % ROWS and 127 % ROWS and 320 % COLS and 192 % COLS and 64 < COLS
    assert all(H % K_STEP == 0 and F % K_STEP == 0 for _, H, F in SHAPES)
