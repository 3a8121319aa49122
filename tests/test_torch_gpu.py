"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one. They import torch and the port only, so they also run where
JAX is not installed; on a GPU host, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Shapes cover the main path's and the ragged edges each kernel masks.
Tolerances (max abs) are stated per test; bf16 outputs allow one or two
bf16 rounding steps at the outputs' magnitude.
"""

import pytest
import torch

from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import image_prep as prep
from clip_for_dl_tpu_torch.ops import mlp_block
from clip_for_dl_tpu_torch.ops import mlp_train as mlp
from clip_for_dl_tpu_torch.ops import similarity as sim

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,C,D", [(256, 16, 512), (13, 5, 128), (1, 16, 768)])
def test_similarity_kernel(cuda, B, C, D):
    """fp32: 1e-5."""
    g = torch.Generator(cuda).manual_seed(0)
    img = torch.randn(B, D, device=cuda, generator=g)
    img[0] = 0.0  # padded bucket row: the eps² clamp gives 0, not NaN
    txt = torch.randn(C, D, device=cuda, generator=g)
    got = sim.similarity(img, txt, 0.5)
    torch.testing.assert_close(got, sim.similarity_reference(img, txt, 0.5),
                               atol=1e-5, rtol=0)
    assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("shape", [(4, 512, 512, 1), (3, 224, 224, 3), (2, 100, 150, 1),
                                   (2, 333, 97, 3)])
def test_image_prep_kernel(cuda, shape):
    """fp32 output: 1e-4; bf16 output: one bf16 step at |x| ≤ 2.2 (1.6e-2)."""
    g = torch.Generator(cuda).manual_seed(0)
    imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)):
        got = prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt)
        want = prep.preprocess_reference(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt)
        assert got.shape == (shape[0], 224, 224, 3) and got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,N,H,D", [(8, 200, 12, 64), (2, 7, 2, 64), (1, 512, 4, 64),
                                     (3, 65, 2, 128)])
def test_flash_attention_kernel(cuda, B, N, H, D):
    """bf16 output |o| ≤ ~3: two bf16 steps (2e-2); padded keys, a fully
    masked row, N below, at and above one 64-row block."""
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(B, N, 3 * H * D, device=cuda, generator=g).bfloat16()
    lengths = torch.randint(1, N + 1, (B, 1), device=cuda, generator=g)
    bias = torch.where(torch.arange(N, device=cuda)[None] < lengths, 0.0, -1e10)
    bias[0] = -1e10
    got = fa.flash_attention_packed(qkv, H, bias)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_packed_reference(qkv, H, bias).float(),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("R,H,F", [(12800, 768, 3072), (100, 768, 3072), (33, 512, 192)])
def test_mlp_kernel(cuda, R, H, F):
    """bf16 output |y| ≲ 2: two bf16 steps (2e-2); R not a multiple of the
    128-row tile, F (192) past one 128-column tile of GEMM-1."""
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(R, H, device=cuda, generator=g).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=g) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=g) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=g) * F ** -0.5).bfloat16()
    b2 = (torch.randn(H, device=cuda, generator=g) * 0.1).bfloat16()
    with torch.no_grad():
        got = mlp.dense_gelu_dense(x, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(),
                               mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2).float(),
                               atol=2e-2, rtol=0)


def _rel_tol(ref: torch.Tensor, steps: int = 2) -> float:
    """``steps`` bf16 rounding steps at the reference's largest magnitude
    (one step is at most 2^-7 of the value)."""
    return steps * 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6


def _assert_grad_slices(got, want, layout, heads=None, msg=None):
    """An attention gradient of B6 or B7 against the plain version's: finite,
    and each (batch row, head) slice within two bf16 steps of its own
    largest entry (``fa.grad_slice_error``)."""
    assert torch.isfinite(got.float()).all(), msg
    max_abs, worst = fa.grad_slice_error(got, want, layout, heads)
    assert worst <= 1.0, (msg, f"max_abs {max_abs}, worst slice at {worst} of its tolerance")


def _seeds(cuda, B, seed=1):
    return fa.dropout_seeds(torch.Generator(cuda).manual_seed(seed), B, cuda)


@pytest.mark.parametrize("B,N,H", [(8, 200, 12), (3, 13, 2)])
def test_flash_attention_dropout_kernel(cuda, B, N, H):
    """Rate 0.1, D = 64: bf16 output |o| ≤ ~3 within two bf16 steps (2e-2),
    padded keys, N not a multiple of 8, a fully masked row."""
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(B, N, 3 * H * 64, device=cuda, generator=g).bfloat16()
    lengths = torch.randint(1, N + 1, (B, 1), device=cuda, generator=g)
    bias = torch.where(torch.arange(N, device=cuda)[None] < lengths, 0.0, -1e10)
    bias[0] = -1e10
    seeds = _seeds(cuda, B)
    got = fa.flash_attention_packed(qkv, H, bias, dropout_rate=0.1, dropout_seeds=seeds)
    want = fa.flash_attention_packed_reference(qkv, H, bias, dropout_rate=0.1,
                                               dropout_seeds=seeds)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("N", [13, 64])
def test_flash_attention_dropout_mask_is_the_plain_versions(cuda, N):
    """With q = 0 every kept probability is the same constant, and with
    v_j = e_j (one-hot, D = 64 ≥ N) output o[i, j] is that constant when
    (i, j) is kept and exactly 0 when it is dropped: the kernel's zero
    pattern must equal the plain version's bit for bit."""
    B, H, D = 4, 3, 64
    qkv = torch.zeros(B, N, 3, H, D, device=cuda)
    qkv[:, :, 2, :, :N] = torch.eye(N, D, device=cuda)[None, :, None, :N]
    qkv = qkv.reshape(B, N, 3 * H * D).bfloat16()
    seeds = _seeds(cuda, B, 5)
    got = fa.flash_attention_packed(qkv, H, None, dropout_rate=0.1, dropout_seeds=seeds)
    want = fa.flash_attention_packed_reference(qkv, H, None, dropout_rate=0.1,
                                               dropout_seeds=seeds)
    keep = got.view(B, N, H, D)[..., :N] != 0
    assert torch.equal(keep, want.view(B, N, H, D)[..., :N] != 0)
    assert 0.8 < keep.float().mean() < 0.97


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,N,H", [(8, 200, 12), (3, 13, 2), (2, 512, 2)])
def test_flash_attention_bwd_kernel(cuda, B, N, H, rate):
    """dqkv vs the plain backward, D = 64: each (batch row, head) slice
    within two bf16 steps of its largest entry; padded keys, N not a
    multiple of 8 or 64, a fully masked row, and N = 512, the bound."""
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(B, N, 3 * H * 64, device=cuda, generator=g).bfloat16()
    do = torch.randn(B, N, H * 64, device=cuda, generator=g).bfloat16()
    lengths = torch.randint(1, N + 1, (B, 1), device=cuda, generator=g)
    bias = torch.where(torch.arange(N, device=cuda)[None] < lengths, 0.0, -1e10)
    bias[0] = -1e10
    seeds = _seeds(cuda, B) if rate else None
    got = fa._kernel_bwd(qkv, do, H, bias, dropout_rate=rate, dropout_seeds=seeds)
    want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, dropout_rate=rate,
                                                   dropout_seeds=seeds)
    _assert_grad_slices(got, want, "packed", H)


def test_flash_attention_autograd_on_the_card(cuda):
    """The autograd function launches B3 and B6 and gives the plain
    backward's gradient."""
    g = torch.Generator(cuda).manual_seed(3)
    qkv = torch.randn(2, 40, 3 * 2 * 64, device=cuda, generator=g).bfloat16()
    do = torch.randn(2, 40, 2 * 64, device=cuda, generator=g).bfloat16()
    seeds = _seeds(cuda, 2)
    x = qkv.clone().requires_grad_()
    fa.flash_attention_packed(x, 2, None, dropout_rate=0.1, dropout_seeds=seeds).backward(do)
    want = fa.flash_attention_packed_bwd_reference(qkv, do, 2, None, dropout_rate=0.1,
                                                   dropout_seeds=seeds)
    _assert_grad_slices(x.grad, want, "packed", 2)


@pytest.mark.parametrize("R,H,F", [(4096, 768, 3072), (100, 768, 3072), (33, 512, 192)])
def test_mlp_bwd_kernel(cuda, R, H, F):
    """(dx, g, dh) vs the plain backward: two bf16 steps at each output's
    largest entry; R not a multiple of the 128-row tile."""
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=gen) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=gen) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=gen) * F ** -0.5).bfloat16()
    dy = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    got = mlp._kernel_bwd(x, w1, b1, w2, dy)
    want = mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)
    for name, a, b in zip(("dx", "g", "dh"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a.float(), b.float(), atol=_rel_tol(b), rtol=0, msg=name)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        sim.similarity(torch.zeros(4, 512, device=cuda, dtype=torch.float64),
                       torch.zeros(16, 512, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="dropout_seeds"):
        fa.flash_attention_packed(torch.zeros(2, 8, 6 * 64, device=cuda,
                                              dtype=torch.bfloat16), 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="sequence length"):
        fa._kernel_bwd(torch.zeros(2, 513, 6 * 64, device=cuda, dtype=torch.bfloat16),
                       torch.zeros(2, 513, 2 * 64, device=cuda, dtype=torch.bfloat16), 2, None)
    # ROADMAP C4, closed: head dim 160 is taken (padded to 192, run in slices)
    qkv, do, bias = _attention_inputs(cuda, 2, 8, 2, 160)
    _assert_grad_slices(fa._kernel_bwd(qkv, do, 2, bias),
                        fa.flash_attention_packed_bwd_reference(qkv, do, 2, bias), "packed", 2)
    with pytest.raises(TypeError):
        fa._kernel_bwd(torch.zeros(2, 8, 6 * 64, device=cuda, dtype=torch.bfloat16),
                       torch.zeros(2, 8, 2 * 64, device=cuda), 2, None)
    with pytest.raises(ValueError, match="contiguous"):
        mlp.dense_gelu_dense(torch.zeros(4, 768, device=cuda, dtype=torch.bfloat16),
                             torch.zeros(768, 3072, device=cuda, dtype=torch.bfloat16).T,
                             torch.zeros(3072, device=cuda, dtype=torch.bfloat16),
                             torch.zeros(768, 3072, device=cuda, dtype=torch.bfloat16),
                             torch.zeros(768, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 64"):
        mlp._kernel_bwd(*(torch.zeros(s, device=cuda, dtype=torch.bfloat16)
                          for s in ((4, 768), (96, 768), (96,), (768, 96), (4, 768))))
    with pytest.raises(TypeError):  # B9 takes bf16 activations only
        mlp_block.fused_mlp_block(*_block_inputs(cuda, 4, 128, 256, torch.float32))


# ---------------------------------------------------------------------------
# Repairs of ROADMAP queue C: head dim 128 at N = 512 (B3, B6), MLP widths (B4, B8)
# ---------------------------------------------------------------------------


def _attention_inputs(cuda, B, N, H, D, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * D, device=cuda, generator=g).bfloat16()
    do = torch.randn(B, N, H * D, device=cuda, generator=g).bfloat16()
    lengths = torch.randint(1, N + 1, (B, 1), device=cuda, generator=g)
    bias = torch.where(torch.arange(N, device=cuda)[None] < lengths, 0.0, -1e10)
    return qkv, do, bias


def test_flash_attention_kernel_head_dim_128_at_512(cuda):
    """ROADMAP C1: B3 at (B, N, H, D) = (2, 512, 2, 128) with padded keys,
    where K and V in shared memory would exceed a block's 227 KB; bf16
    output within two bf16 steps (2e-2)."""
    qkv, _, bias = _attention_inputs(cuda, 2, 512, 2, 128)
    got = fa.flash_attention_packed(qkv, 2, bias)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_packed_reference(qkv, 2, bias).float(),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_bwd_kernel_head_dim_128_at_512(cuda, rate):
    """ROADMAP C2: B6 at (2, 512, 2, 128) with padded keys, rates 0 and
    0.1: dqkv per (batch row, head) slice within two bf16 steps, and with
    dropout the mask equal to the plain version's (probe inputs as in
    chip_smoke.py's dropout_probe: q = k = 0, one-hot v and d(out))."""
    B, N, H, D = 2, 512, 2, 128
    qkv, do, bias = _attention_inputs(cuda, B, N, H, D)
    seeds = _seeds(cuda, B) if rate else None
    got = fa._kernel_bwd(qkv, do, H, bias, dropout_rate=rate, dropout_seeds=seeds)
    want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, dropout_rate=rate,
                                                   dropout_seeds=seeds)
    assert torch.isfinite(got.float()).all()
    _assert_grad_slices(got, want, "packed", H)
    if rate:
        pos = torch.arange(N, device=cuda)
        window = (pos // D)[None] == torch.arange(B, device=cuda)[:, None]  # [B, N]
        onehot = torch.nn.functional.one_hot(pos % D, D).float()
        pq = torch.zeros(B, N, 3, H, D, device=cuda)
        pq[:, :, 2] = (onehot[None] * window[..., None])[:, :, None, :]
        pdo = (onehot[None] * window[..., None])[:, :, None, :].expand(B, N, H, D)
        pq = pq.reshape(B, N, 3 * H * D).bfloat16()
        pdo = pdo.reshape(B, N, H * D).bfloat16()
        pbias = torch.where(window, 0.0, -1e10)
        gdv = fa._kernel_bwd(pq, pdo, H, pbias, dropout_rate=rate, dropout_seeds=seeds)
        wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, dropout_rate=rate,
                                                      dropout_seeds=seeds)
        gdv, wdv = (t.view(B, N, 3, H, D)[:, :, 2] for t in (gdv, wdv))
        assert torch.equal(gdv != 0, wdv != 0)
        assert 0.8 < float((wdv != 0).sum()) / (B * D * D * H) < 0.97


def test_mlp_kernels_at_hidden_256(cuda):
    """ROADMAP C3: B4 and B8 at hidden 256 (once refused: only 512, 768,
    1024 were instantiated), 100 rows, F = 512: B4 within 2e-2, B8's
    (dx, g, dh) within two bf16 steps at each output's largest entry."""
    R, H, F = 100, 256, 512
    gen = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=gen) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=gen) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=gen) * F ** -0.5).bfloat16()
    b2 = (torch.randn(H, device=cuda, generator=gen) * 0.1).bfloat16()
    dy = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    with torch.no_grad():
        got = mlp.dense_gelu_dense(x, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(),
                               mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2).float(),
                               atol=2e-2, rtol=0)
    for name, a, b in zip(("dx", "g", "dh"), mlp._kernel_bwd(x, w1, b1, w2, dy),
                          mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)):
        torch.testing.assert_close(a.float(), b.float(), atol=_rel_tol(b), rtol=0, msg=name)


# ---------------------------------------------------------------------------
# B9: the fused LayerNorm-MLP block
# ---------------------------------------------------------------------------


def _block_inputs(cuda, R, H, F, dtype=torch.bfloat16, seed=0):
    """x in the compute dtype, bf16 weights, fp32 LayerNorm parameters and
    biases (what the ViT layer hands over); every bias and LayerNorm
    parameter at std 0.1, so that each moves the output by more than the
    tolerance."""
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(R, H, device=cuda, generator=g).to(dtype)
    ls = 1.0 + 0.1 * torch.randn(H, device=cuda, generator=g)
    lb = 0.1 * torch.randn(H, device=cuda, generator=g)
    w1 = (torch.randn(F, H, device=cuda, generator=g) * H ** -0.5).bfloat16()
    b1 = 0.1 * torch.randn(F, device=cuda, generator=g)
    w2 = (torch.randn(H, F, device=cuda, generator=g) * F ** -0.5).bfloat16()
    b2 = 0.1 * torch.randn(H, device=cuda, generator=g)
    return x, ls, lb, w1, b1, w2, b2


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("R,H,F", [(50432, 768, 3072), (197, 768, 3072), (33, 128, 256),
                                   (70, 1024, 512)])
def test_mlp_block_kernel(cuda, R, H, F, approximate):
    """B9 vs its plain version: the ViT-B/16 serving shape (256 images of
    197 tokens), one request's 197 rows, R not a multiple of the 128-row
    tile, a narrow and a wide hidden. The MLP branch out - x within two bf16
    steps at its largest entry (the residual, which both sides add, would
    set the scale of a tolerance on out): a summation-order flip of the
    GELU or o rounding moves out by at most one step of o, the residual's
    rounding by one step of out (|out| < 8 at x ~ N(0, 1))."""
    args = _block_inputs(cuda, R, H, F)
    with torch.no_grad():
        got = mlp_block.fused_mlp_block(*args, gelu_approximate=approximate)
    want = mlp_block.fused_mlp_block_reference(*args, gelu_approximate=approximate)
    assert got.shape == (R, H) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    x = args[0].float()
    branch = want.float() - x
    torch.testing.assert_close(got.float() - x, branch, atol=_rel_tol(branch), rtol=0)


def test_mlp_block_trainable_on_the_card(cuda):
    """The trainable form launches B9 forward and gives the plain
    version's gradients (the backward is the plain version's autograd)."""
    from clip_for_dl_tpu_torch.ops import _build

    args = [t.clone().requires_grad_() for t in _block_inputs(cuda, 40, 256, 512, seed=2)]
    before = _build.LAUNCHES[mlp_block.KERNEL]
    out = mlp_block.fused_mlp_block_trainable(*args)
    assert _build.LAUNCHES[mlp_block.KERNEL] == before + 1
    ct = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    (out.float() * ct).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in args]
    (mlp_block.fused_mlp_block_reference(*ref).float() * ct).sum().backward()
    for a, b in zip(args, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# B5 and B7: the split-q/k/v attention forward and backward
# ---------------------------------------------------------------------------


def _split_from_packed(qkv, H, layout):
    """q, k, v as views of a packed qkv's column blocks ("bnhd"), or their
    head-major contiguous copies ("bhnd")."""
    B, N, _ = qkv.shape
    q, k, v = qkv.view(B, N, 3, H, -1).unbind(2)
    if layout == "bhnd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v


def _to_bnhd(t, layout):
    return t if layout == "bnhd" else t.transpose(1, 2)


def _head_major(t, layout):
    """A split operand as [B, H, N, D] for the plain versions, and their
    results back in ``layout``."""
    return t if layout == "bhnd" else t.transpose(1, 2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("B,N,H,D", [(8, 200, 12, 64), (3, 13, 2, 64), (2, 512, 2, 128)])
def test_flash_attention_split_kernels(cuda, B, N, H, D, layout, rate):
    """B5's output within two bf16 steps (2e-2) and B7's (dq, dk, dv) within
    two bf16 steps per (batch row, head) slice of the plain versions;
    and both bit-equal to B3 and B6 on the same heads (one kernel body):
    padded keys, a fully masked row, N below one 64-row block, and the
    (N, D) = (512, 128) bound."""
    qkv, do, bias = _attention_inputs(cuda, B, N, H, D)
    bias[0] = -1e10
    seeds = _seeds(cuda, B) if rate else None
    kw = dict(dropout_rate=rate, dropout_seeds=seeds)
    q, k, v = _split_from_packed(qkv, H, layout)
    dos = _to_bnhd(do.view(B, N, H, D), layout)
    if layout == "bhnd":
        dos = dos.contiguous()
    got = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
    want = _head_major(fa.flash_attention_reference(
        *(_head_major(t, layout) for t in (q, k, v)), bias, **kw), layout)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    packed = fa.flash_attention_packed(qkv, H, bias, **kw)
    assert torch.equal(_to_bnhd(got, layout).reshape(B, N, H * D), packed)

    grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
    plain = fa.flash_attention_bwd_reference(
        *(_head_major(t, layout) for t in (q, k, v, dos)), bias, **kw)
    dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), grads, plain)):
        assert g.shape == q.shape and torch.isfinite(g.float()).all(), name
        w = _head_major(w, layout)
        _assert_grad_slices(g, w, layout, msg=name)
        assert torch.equal(_to_bnhd(g, layout), dqkv[:, :, i]), name


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_flash_attention_split_dropout_mask_is_the_plain_versions(cuda, layout):
    """The probe inputs of chip_smoke.py's dropout_probe (q = k = 0, one-hot
    v and d(out) windows): B5's output and B7's dv are nonzero exactly where
    the plain versions' are, so the masks agree bit for bit."""
    B, N, H, D = 6, 200, 3, 64
    nwin = -(-N // D)
    pos = torch.arange(N, device=cuda)
    win = torch.arange(B, device=cuda) % nwin
    in_key = (pos[None] // D) == win[:, None]
    in_row = (pos[None] // D) == ((torch.arange(B, device=cuda) // nwin) % nwin)[:, None]
    onehot = torch.nn.functional.one_hot(pos % D, D).float()
    qkv = torch.zeros(B, N, 3, H, D, device=cuda)
    qkv[:, :, 2] = (onehot[None] * in_key[..., None])[:, :, None, :]
    do = (onehot[None] * in_row[..., None])[:, :, None, :].expand(B, N, H, D).bfloat16()
    qkv = qkv.reshape(B, N, 3 * H * D).bfloat16()
    bias = torch.where(in_key, 0.0, -1e10)
    kw = dict(dropout_rate=0.1, dropout_seeds=_seeds(cuda, B, 7))
    q, k, v = _split_from_packed(qkv, H, layout)
    dos = _to_bnhd(do, layout).contiguous()
    out = _to_bnhd(fa.flash_attention(q, k, v, bias, layout=layout, **kw), layout)
    want = fa.flash_attention_packed_reference(qkv, H, bias, **kw).view(B, N, H, D)
    assert torch.equal(out != 0, want != 0)
    dv = _to_bnhd(fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)[2], layout)
    wdv = fa.flash_attention_packed_bwd_reference(qkv, do.reshape(B, N, H * D), H, bias,
                                                  **kw).view(B, N, 3, H, D)[:, :, 2]
    assert torch.equal(dv != 0, wdv != 0)
    assert 0.8 < float((want != 0).sum()) / (int(in_key.sum()) * N * H) < 0.97


def test_flash_attention_split_autograd_on_the_card(cuda):
    """``_Flash`` launches B5 and B7 and gives the plain backward's
    gradients; a d(out) with a non-contiguous head dim reaches B7 as a
    contiguous copy."""
    from clip_for_dl_tpu_torch.ops import _build

    g = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(2, 40, 2, 64, device=cuda, generator=g).bfloat16() for _ in range(3))
    do = torch.randn(2, 40, 64, 2, device=cuda, generator=g).bfloat16().transpose(2, 3)
    seeds = _seeds(cuda, 2)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    fa.flash_attention(*xs, None, layout="bnhd", dropout_rate=0.1,
                       dropout_seeds=seeds).backward(do)
    for name in (fa.KERNEL_SPLIT, fa.KERNEL_SPLIT_BWD):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1, name
    want = fa.flash_attention_bwd_reference(
        *(t.transpose(1, 2) for t in (q, k, v, do)), None, dropout_rate=0.1,
        dropout_seeds=seeds)
    for x, w in zip(xs, want):
        _assert_grad_slices(x.grad, w.transpose(1, 2), "bnhd")


# ---------------------------------------------------------------------------
# B6 and B7 on the tensor cores: tile edges, strides, determinism
# ---------------------------------------------------------------------------


def _bwd_case(cuda, B, N, H, D, rate, seed=0):
    """Packed inputs with padded keys and a fully masked batch row 0, and
    the keyword arguments of a call at ``rate``."""
    qkv, do, bias = _attention_inputs(cuda, B, N, H, D, seed)
    bias[0] = -1e10
    return qkv, do, bias, dict(dropout_rate=rate,
                               dropout_seeds=_seeds(cuda, B) if rate else None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("N", [1, 13, 64, 65, 128, 200, 512])
def test_flash_attention_bwd_kernels_over_tile_edges(cuda, N, D, rate):
    """B6 per (batch row, head) slice within two bf16 steps of the plain
    version, and B7 bit-equal to B6 in both layouts: N of one token, below,
    at and one past a 64-token tile, whole tiles, the train length and the
    bound."""
    B, H = 2, 2
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, rate)
    got = fa._kernel_bwd(qkv, do, H, bias, **kw)
    want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw)
    _assert_grad_slices(got, want, "packed", H)
    packed = got.view(B, N, 3, H, D)
    for layout in ("bnhd", "bhnd"):
        q, k, v = _split_from_packed(qkv, H, layout)
        dos = _to_bnhd(do.view(B, N, H, D), layout).contiguous()
        grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
        for i, g in enumerate(grads):
            assert torch.equal(_to_bnhd(g, layout), packed[:, :, i]), (layout, i)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("N,D", [(65, 64), (200, 64), (13, 128), (200, 128)])
def test_flash_attention_bwd_never_reads_past_token_n(cuda, N, D, layout):
    """Split operands sliced [:N] along the token dim of NaN-filled buffers
    64 tokens longer: the tokens a ragged tile covers past N hold NaN (in
    "bnhd" they would be the next batch row's), so a tile that read them
    would give NaN. The gradients are finite, equal to those of contiguous
    copies bit for bit, and per (batch row, head) slice within two bf16
    steps of the plain version."""
    B, H = 3, 2
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    q, k, v = _split_from_packed(qkv, H, "bnhd")
    dense = [_to_bnhd(t, layout).contiguous() for t in (q, k, v, do.view(B, N, H, D))]
    padded = []
    for t in dense:
        shape = list(t.shape)
        tok = 1 if layout == "bnhd" else 2
        shape[tok] += 64
        buf = torch.full(shape, float("nan"), device=cuda, dtype=torch.bfloat16)
        view = buf.narrow(tok, 0, N)
        view.copy_(t)
        padded.append(view)
    got = fa.flash_attention_bwd(*padded[:3], padded[3], bias, layout=layout, **kw)
    want = fa.flash_attention_bwd(*dense[:3], dense[3], bias, layout=layout, **kw)
    plain = fa.flash_attention_bwd_reference(*(_head_major(t, layout) for t in dense), bias,
                                             **kw)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        _assert_grad_slices(g, _head_major(p, layout), layout)


def test_flash_attention_bwd_copies_views_off_the_16_byte_grid(cuda):
    """A "bnhd" view whose data is 4-byte but not 16-byte aligned reaches
    B7 as a contiguous copy (the kernel's 16-byte copies need the grid) and
    gives the aligned tensors' bits."""
    B, N, H, D = 2, 70, 2, 64
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    q, k, v = (t.contiguous() for t in _split_from_packed(qkv, H, "bnhd"))
    dos = do.view(B, N, H, D)
    store = torch.empty(q.numel() + 2, device=cuda, dtype=torch.bfloat16)
    q_off = store[2:].view(B, N, H, D)  # 4 bytes past a 16-byte boundary
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 4
    want = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **kw)
    got = fa.flash_attention_bwd(q_off, k, v, dos, bias, layout="bnhd", **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_attention_bwd_is_deterministic(cuda):
    """No atomics: two calls of B6 and of B7 on the same inputs give the
    same bits, at the train shape's H and D with dropout."""
    B, N, H, D = 4, 200, 12, 64
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    assert torch.equal(fa._kernel_bwd(qkv, do, H, bias, **kw),
                       fa._kernel_bwd(qkv, do, H, bias, **kw))
    q, k, v = _split_from_packed(qkv, H, "bnhd")
    dos = do.view(B, N, H, D)
    first = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **kw)
    second = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_split_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(2, 513, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sequence length"):
        fa.flash_attention(z, z, z, layout="bnhd")
    # ROADMAP C4, closed: head dim 160 is taken and matches the plain version
    qkv, _, bias = _attention_inputs(cuda, 2, 8, 2, 160)
    q, k, v = _split_from_packed(qkv, 2, "bnhd")
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, bias, layout="bnhd").float(),
        fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)), bias)
        .transpose(1, 2).float(), atol=2e-2, rtol=0)
    with pytest.raises(TypeError):  # fp32, bf16 and fp16 are taken (C7), fp64 is not
        fa.flash_attention(*(torch.zeros(2, 8, 2, 64, device=cuda, dtype=torch.float64)
                             for _ in range(3)), layout="bnhd")


# ---------------------------------------------------------------------------
# B3 and B5 on the tensor cores; head dims 32 to 128 (C4); any width for B1
# (C5); batches past 65535 (C6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 200, 512])
def test_flash_attention_fwd_kernels_over_tile_edges(cuda, N, D, rate):
    """B3 within two bf16 steps (2e-2) of the plain version and B5
    bit-equal to B3 in both layouts: N of one token, one short of, at and
    one past a 64-token tile, the train length and the bound; padded keys
    and a fully masked batch row 0."""
    B, H = 2, 2
    qkv, _, bias, kw = _bwd_case(cuda, B, N, H, D, rate)
    got = fa.flash_attention_packed(qkv, H, bias, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_packed_reference(qkv, H, bias, **kw).float(),
                               atol=2e-2, rtol=0)
    for layout in ("bnhd", "bhnd"):
        out = fa.flash_attention(*_split_from_packed(qkv, H, layout), bias, layout=layout, **kw)
        assert torch.equal(_to_bnhd(out, layout).reshape(B, N, H * D), got), layout


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("N,D", [(1, 32), (65, 64), (200, 64), (13, 128), (200, 128)])
def test_flash_attention_fwd_never_reads_past_token_n(cuda, N, D, layout):
    """Split operands sliced [:N] along the token dim of NaN-filled buffers
    64 tokens longer: a ragged tile that read past N would give NaN. The
    output is finite and equal to that of contiguous copies bit for bit."""
    B, H = 3, 2
    qkv, _, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    dense = [_to_bnhd(t, layout).contiguous() for t in _split_from_packed(qkv, H, "bnhd")]
    padded = []
    for t in dense:
        tok = 1 if layout == "bnhd" else 2
        shape = list(t.shape)
        shape[tok] += 64
        view = torch.full(shape, float("nan"), device=cuda, dtype=torch.bfloat16).narrow(tok, 0, N)
        view.copy_(t)
        padded.append(view)
    got = fa.flash_attention(*padded, bias, layout=layout, **kw)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, fa.flash_attention(*dense, bias, layout=layout, **kw))


def test_flash_attention_fwd_is_deterministic(cuda):
    """Every sum over keys is a loop inside one block: two calls of B3 and
    of B5 on the same inputs give the same bits, at the train shape's H and
    D with dropout."""
    B, N, H, D = 4, 200, 12, 64
    qkv, _, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    assert torch.equal(fa.flash_attention_packed(qkv, H, bias, **kw),
                       fa.flash_attention_packed(qkv, H, bias, **kw))
    q, k, v = _split_from_packed(qkv, H, "bnhd")
    assert torch.equal(fa.flash_attention(q, k, v, bias, layout="bnhd", **kw),
                       fa.flash_attention(q, k, v, bias, layout="bnhd", **kw))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 96])
def test_flash_attention_kernels_at_head_dims_32_and_96(cuda, D, rate):
    """ROADMAP C4: head dim 32 runs natively, 96 through the wrappers' zero
    pad to 128. B3 and B5 within two bf16 steps (2e-2) of the plain
    versions, B6 and B7 per (batch row, head) slice within two bf16 steps;
    B5 and B7 bit-equal to B3 and B6 in both layouts; N = 200, padded keys."""
    B, N, H = 3, 200, 2
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, rate)
    out = fa.flash_attention_packed(qkv, H, bias, **kw)
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_packed_reference(qkv, H, bias, **kw).float(),
                               atol=2e-2, rtol=0)
    dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
    assert dqkv.shape == qkv.shape
    _assert_grad_slices(dqkv, fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw),
                        "packed", H)
    packed = dqkv.view(B, N, 3, H, D)
    for layout in ("bnhd", "bhnd"):
        q, k, v = _split_from_packed(qkv, H, layout)
        dos = _to_bnhd(do.view(B, N, H, D), layout).contiguous()
        split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
        assert split.shape == q.shape
        assert torch.equal(_to_bnhd(split, layout).reshape(B, N, H * D), out), layout
        for i, g in enumerate(fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)):
            assert g.shape == q.shape
            assert torch.equal(_to_bnhd(g, layout), packed[:, :, i]), (layout, i)


@pytest.mark.parametrize("C", [16, 200])
@pytest.mark.parametrize("D", [64, 96, 100, 2048])
def test_similarity_kernel_at_any_width(cuda, D, C):
    """ROADMAP C5: B1 at widths it once refused (not in {128, 256, 512, 768,
    1024}; not a multiple of 32) and C = 200 prompts (over the old 200 KB
    text block at D = 2048): fp32 within 1e-5, a zero row gives 0."""
    g = torch.Generator(cuda).manual_seed(D + C)
    img = torch.randn(37, D, device=cuda, generator=g)
    img[0] = 0.0
    txt = torch.randn(C, D, device=cuda, generator=g)
    got = sim.similarity(img, txt, 0.5)
    torch.testing.assert_close(got, sim.similarity_reference(img, txt, 0.5), atol=1e-5, rtol=0)
    assert torch.all(got[0] == 0.0)


def test_kernels_take_a_batch_of_65537(cuda):
    """ROADMAP C6: B2 and B3/B6 at a batch past the 65535 of gridDim.y and
    gridDim.z, at a small image and N. B2's blocks walk (image, band, column
    chunk) items in a grid-stride loop; B3 and B6 launch batch chunks of at
    most 65535 rows on their 3-D grid (gridDim.z)."""
    B = 65537
    g = torch.Generator(cuda).manual_seed(6)
    imgs = torch.randint(0, 256, (B, 12, 10, 1), device=cuda, generator=g, dtype=torch.uint8)
    got = prep.preprocess_images(imgs, 8, 8, CLIP_MEAN, CLIP_STD)
    torch.testing.assert_close(got.float(), prep.preprocess_reference(
        imgs, 8, 8, CLIP_MEAN, CLIP_STD).float(), atol=1.6e-2, rtol=0)
    N, H, D = 5, 2, 32
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, 0.1)
    torch.testing.assert_close(fa.flash_attention_packed(qkv, H, bias, **kw).float(),
                               fa.flash_attention_packed_reference(qkv, H, bias, **kw).float(),
                               atol=2e-2, rtol=0)
    _assert_grad_slices(fa._kernel_bwd(qkv, do, H, bias, **kw),
                        fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw),
                        "packed", H)


# ---------------------------------------------------------------------------
# B8 on wgmma with TMA-fed tiles: any multiple of 64, determinism
# ---------------------------------------------------------------------------


def _mlp_bwd_inputs(cuda, R, H, F, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=gen) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=gen) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=gen) * F ** -0.5).bfloat16()
    dy = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    return x, w1, b1, w2, dy


@pytest.mark.parametrize("F", [64, 3072])
@pytest.mark.parametrize("H", [192, 768, 1280])
@pytest.mark.parametrize("R", [1, 129, 25600])
def test_mlp_bwd_kernel_at_any_multiple_of_64(cuda, R, H, F):
    """B8 (two wgmma kernels fed by TMA) at one row, one past a 128-row tile
    and the train shape's rows; H past a 128-column tile (192), the train
    width, and past the old MAX_HIDDEN (1280); F of one k-step and the train
    width: (dx, g, dh) within two bf16 steps of each output's largest entry
    of the plain backward."""
    args = _mlp_bwd_inputs(cuda, R, H, F)
    got = mlp._kernel_bwd(*args)
    want = mlp.dense_gelu_dense_bwd_reference(*args)
    for name, a, b in zip(("dx", "g", "dh"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=_rel_tol(b), rtol=0, msg=name)


def _mlp_fwd_inputs(cuda, R, H, F, which, seed=0):
    """(B4's or B9's kernel entry, its inputs, its plain version)."""
    if which == "B9":
        return (lambda *a: mlp_block._kernel(*a, eps=1e-6, gelu_approximate=False),
                _block_inputs(cuda, R, H, F, seed=seed), mlp_block.fused_mlp_block_reference)
    gen = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=gen) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=gen) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=gen) * F ** -0.5).bfloat16()
    b2 = (torch.randn(H, device=cuda, generator=gen) * 0.1).bfloat16()
    return mlp._kernel, (x, w1, b1, w2, b2), mlp.dense_gelu_dense_reference


@pytest.mark.parametrize("which", ["B4", "B9"])
@pytest.mark.parametrize("H", [192, 1280])
@pytest.mark.parametrize("R", [1, 197, 12801])
def test_mlp_fwd_kernels_at_any_multiple_of_64(cuda, R, H, which):
    """B4 and B9 (the GEMM pair on wgmma, fed by TMA) at one row, one
    request's 197 rows and one past a 128-row tile of the bank; H past a
    128-column tile (192, not a multiple of 128) and past the old
    MAX_HIDDEN (1280), F = 4 H. B4 within two bf16 steps of its largest
    entry; B9's branch out - x within two bf16 steps of its largest entry,
    through the kernel's own entry (the public function keeps JAX's rule of
    multiples of 128)."""
    kernel, args, plain = _mlp_fwd_inputs(cuda, R, H, 4 * H, which)
    got = kernel(*args)
    want = plain(*args)
    assert got.shape == want.shape == (R, H) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    base = args[0].float() if which == "B9" else 0.0
    torch.testing.assert_close(got.float() - base, want.float() - base,
                               atol=_rel_tol(want.float() - base), rtol=0)


@pytest.mark.parametrize("which,R", [("B4", 12800), ("B9", 50432)])
def test_mlp_fwd_kernels_are_deterministic(cuda, which, R):
    """No split of K and no atomics: two calls give the same bits, at the
    prompt bank's and the ViT batch's shapes."""
    kernel, args, _ = _mlp_fwd_inputs(cuda, R, 768, 3072, which, seed=5)
    assert torch.equal(kernel(*args), kernel(*args))


def test_mlp_bwd_is_deterministic(cuda):
    """No split of K and no atomics: two calls give the same bits, at the
    train shape."""
    args = _mlp_bwd_inputs(cuda, 25600, 768, 3072, seed=3)
    first, second = mlp._kernel_bwd(*args), mlp._kernel_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------------------------------
# Head dims over 128 (ROADMAP C4, closed): B3/B5/B6/B7 in 64-column slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [160, 256, 320])
def test_flash_attention_kernels_over_head_dim_128(cuda, D, rate):
    """B3 and B5 within two bf16 steps (2e-2) of the plain versions, B6 and
    B7 per (batch row, head) slice within two bf16 steps; B5 and B7
    bit-equal to B3 and B6 in both layouts; N = 200, padded keys, a fully
    masked batch row 0. D = 160 runs padded to 192."""
    B, N, H = 3, 200, 2
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, rate)
    out = fa.flash_attention_packed(qkv, H, bias, **kw)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_packed_reference(qkv, H, bias, **kw).float(),
                               atol=2e-2, rtol=0)
    dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
    _assert_grad_slices(dqkv, fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw),
                        "packed", H)
    packed = dqkv.view(B, N, 3, H, D)
    for layout in ("bnhd", "bhnd"):
        q, k, v = _split_from_packed(qkv, H, layout)
        dos = _to_bnhd(do.view(B, N, H, D), layout).contiguous()
        split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
        assert torch.equal(_to_bnhd(split, layout).reshape(B, N, H * D), out), layout
        for i, g in enumerate(fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)):
            assert torch.equal(_to_bnhd(g, layout), packed[:, :, i]), (layout, i)


@pytest.mark.parametrize("D", [160, 320])
def test_flash_attention_dropout_mask_over_head_dim_128(cuda, D):
    """Every slice draws the same dropout mask: with q = k = 0, key windows
    of D keys and one-hot v and d(out) (as chip_smoke.py's dropout_probe),
    out and dv are nonzero exactly where (row, key) is kept, in B3's output
    and B6's dv alike; their zero patterns equal the plain version's."""
    B, N, H = 4, 200, 2
    nwin = -(-N // D)
    pos = torch.arange(N, device=cuda)
    win = torch.arange(B, device=cuda) % nwin
    in_key = (pos[None] // D) == win[:, None]
    in_row = (pos[None] // D) == ((torch.arange(B, device=cuda) // nwin) % nwin)[:, None]
    onehot = torch.nn.functional.one_hot(pos % D, D).float()
    qkv = torch.zeros(B, N, 3, H, D, device=cuda)
    qkv[:, :, 2] = (onehot[None] * in_key[..., None])[:, :, None, :]
    qkv = qkv.reshape(B, N, 3 * H * D).bfloat16()
    do = (onehot[None] * in_row[..., None])[:, :, None, :].expand(B, N, H, D)
    do = do.reshape(B, N, H * D).bfloat16()
    bias = torch.where(in_key, 0.0, -1e10)
    kw = dict(dropout_rate=0.1, dropout_seeds=_seeds(cuda, B, 7))
    got = fa.flash_attention_packed(qkv, H, bias, **kw)
    want = fa.flash_attention_packed_reference(qkv, H, bias, **kw)
    assert torch.equal(got != 0, want != 0)
    gdv = fa._kernel_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw).view(
        B, N, 3, H, D)[:, :, 2]
    assert torch.equal(gdv != 0, wdv != 0)
    assert 0.8 < float((want != 0).sum()) / (int(in_key.sum()) * N * H) < 0.97


# ---------------------------------------------------------------------------
# B2 over bands of output rows, staged source rows and 16-byte stores
# ---------------------------------------------------------------------------


def _prep_plan(cuda, imgs, out_h, out_w):
    """The kernel's work split for this card (ops/image_prep.py band_plan)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B, _, W, C = imgs.shape
    return prep.band_plan(B, W, C, out_h, out_w, sms)


def _assert_prep(imgs, out_h, out_w, mean=CLIP_MEAN, std=CLIP_STD):
    """fp32 output: 1e-4; bf16 output: one bf16 step at |x| ≤ 2.2 (1.6e-2)."""
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)):
        got = prep.preprocess_images(imgs, out_h, out_w, mean, std, dt)
        want = prep.preprocess_reference(imgs, out_h, out_w, mean, std, dt)
        assert got.shape == want.shape and got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


PREP_EDGES = {
    # B = 1: bands of one row
    "one_request": ((1, 224, 224, 3), (224, 224)),
    "one_grey_image": ((1, 512, 512, 1), (224, 224)),
    # H_out = 100 at R = 16: a last band of 4 rows
    "rows_not_a_multiple_of_r": ((64, 120, 100, 3), (100, 75)),
    # 7-wide output rows, 42 bytes in bf16 and 84 in fp32: scalar stores
    "seven_wide_out_rows": ((2, 50, 30, 3), (7, 7)),
    # a 12 KB source row: staged in column chunks
    "wide_source_in_chunks": ((1, 512, 4096, 3), (224, 224)),
    "strong_downsampling": ((2, 2048, 1536, 1), (224, 224)),
    "upsampling": ((3, 100, 150, 1), (224, 224)),
}


@pytest.mark.parametrize("case", list(PREP_EDGES), ids=list(PREP_EDGES))
def test_image_prep_kernel_over_band_edges(cuda, case):
    shape, (oh, ow) = PREP_EDGES[case]
    g = torch.Generator(cuda).manual_seed(len(case))
    imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    plan = _prep_plan(cuda, imgs, oh, ow)
    if case == "rows_not_a_multiple_of_r":
        assert oh % plan.rows != 0
    if case == "wide_source_in_chunks":
        assert plan.chunks > 1
    _assert_prep(imgs, oh, ow)


def test_image_prep_kernel_reads_no_byte_past_the_last_row(cuda):
    """A 333 x 3 source row (999 bytes) in a view that starts 3 bytes into its
    buffer and ends 4 bytes before the buffer's end: no row start, and not the
    tensor's end, is on the 16-byte grid."""
    shape = (3, 97, 333, 3)
    n = 3 * 97 * 333 * 3
    g = torch.Generator(cuda).manual_seed(11)
    buf = torch.randint(0, 256, (n + 7,), device=cuda, generator=g, dtype=torch.uint8)
    imgs = buf[3:3 + n].view(shape)
    assert imgs.data_ptr() % 16 and (imgs.data_ptr() + n) % 16
    _assert_prep(imgs, 224, 224)
    _assert_prep(imgs, 96, 331)


@pytest.mark.parametrize("channels,stats", [(4, 4), (1, 1), (12000, 12000)],
                         ids=["rgba", "grey_to_grey", "row_pair_past_the_buffer"])
def test_image_prep_kernel_at_other_channel_counts(cuda, channels, stats):
    """C_out of 4 (any count, scalar stores), 1, and 12000 channels, whose
    one-column row pair outgrows the two 22 KB buffers and takes more shared
    memory."""
    g = torch.Generator(cuda).manual_seed(channels)
    shape = (2, 40, 50, channels) if channels < 100 else (1, 3, 3, channels)
    out_hw = (24, 31) if channels < 100 else (2, 2)
    imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    mean = tuple(0.1 + 0.8 * i / stats for i in range(stats))
    std = tuple(0.2 + 0.1 * (i % 3) for i in range(stats))
    _assert_prep(imgs, *out_hw, mean, std)


def test_image_prep_kernel_is_deterministic(cuda):
    g = torch.Generator(cuda).manual_seed(12)
    imgs = torch.randint(0, 256, (16, 512, 512, 1), device=cuda, generator=g,
                         dtype=torch.uint8)
    for dt in (torch.bfloat16, torch.float32):
        first = prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt)
        assert torch.equal(first, prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt))


# ---------------------------------------------------------------------------
# fp32 and fp16 attention (ROADMAP C7): B3/B5/B6/B7 in every operand type
# ---------------------------------------------------------------------------


@pytest.fixture
def full_fp32(cuda):
    """The plain versions' fp32 products in full fp32, not TF32."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = flag


def _typed_case(cuda, B, N, H, D, dtype, rate, seed=0):
    qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, rate, seed)
    return qkv.to(dtype), do.to(dtype), bias, kw


def _assert_fwd(got, want, msg=None):
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    assert torch.isfinite(got.float()).all(), msg
    torch.testing.assert_close(got.float(), want.float(), atol=fa.fwd_tolerance(want), rtol=0,
                               msg=msg)


def _assert_typed_grad(got, want, layout, dtype, heads=None, msg=None):
    assert got.dtype == dtype, msg
    assert torch.isfinite(got.float()).all(), msg
    max_abs, worst = fa.grad_slice_error(got, want, layout, heads, dtype)
    assert worst <= 1.0, (msg, f"max_abs {max_abs}, worst slice at {worst} of its tolerance")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 64, 128, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_flash_attention_kernels_in_fp32_and_fp16(full_fp32, dtype, D, rate):
    """B3 and B5 against the plain versions (fp32 1e-5; fp16 two fp16 steps
    at the largest entry), B6 and B7 per (batch row, head) slice (fp32 1e-4
    of the slice's largest entry + 1e-6; fp16 two fp16 steps); B5 and B7
    bit-equal to B3 and B6 in both layouts; N = 200, padded keys, a fully
    masked batch row 0. Each type's entry points count their launches."""
    cuda = full_fp32
    B, N, H = 3, 200, 2
    qkv, do, bias, kw = _typed_case(cuda, B, N, H, D, dtype, rate)
    suffix = fa.SUFFIXES[dtype]
    from clip_for_dl_tpu_torch.ops import _build
    before = dict(_build.LAUNCHES)
    out = fa.flash_attention_packed(qkv, H, bias, **kw)
    _assert_fwd(out, fa.flash_attention_packed_reference(qkv, H, bias, **kw))
    dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
    _assert_typed_grad(dqkv, fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw),
                       "packed", dtype, H)
    packed = dqkv.view(B, N, 3, H, D)
    for layout in ("bnhd", "bhnd"):
        q, k, v = _split_from_packed(qkv, H, layout)
        dos = _to_bnhd(do.view(B, N, H, D), layout).contiguous()
        split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
        assert torch.equal(_to_bnhd(split, layout).reshape(B, N, H * D), out), layout
        plain = fa.flash_attention_bwd_reference(*(_head_major(t, layout) for t in (q, k, v, dos)),
                                                 bias, **kw)
        for i, g in enumerate(fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)):
            assert torch.equal(_to_bnhd(g, layout), packed[:, :, i]), (layout, i)
            _assert_typed_grad(g, _head_major(plain[i], layout), layout, dtype, msg=(layout, i))
    for name, n in ((fa.KERNEL, 1), (fa.KERNEL_BWD, 1), (fa.KERNEL_SPLIT, 2),
                    (fa.KERNEL_SPLIT_BWD, 2)):
        assert _build.LAUNCHES[name + suffix] - before.get(name + suffix, 0) == n, name


@pytest.mark.parametrize("N", [1, 13, 64, 65, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_flash_attention_fp32_fp16_over_sequence_edges(full_fp32, dtype, N):
    """Packed forward and backward at rate 0.1 over N at and around the
    kernels' 32- and 64-token chunks, up to MAX_SEQ_LEN, D = 64."""
    qkv, do, bias, kw = _typed_case(full_fp32, 2, N, 2, 64, dtype, 0.1)
    _assert_fwd(fa.flash_attention_packed(qkv, 2, bias, **kw),
                fa.flash_attention_packed_reference(qkv, 2, bias, **kw))
    _assert_typed_grad(fa._kernel_bwd(qkv, do, 2, bias, **kw),
                       fa.flash_attention_packed_bwd_reference(qkv, do, 2, bias, **kw),
                       "packed", dtype, 2)


@pytest.mark.parametrize("D", [64, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_flash_attention_fp32_fp16_dropout_masks(cuda, dtype, D):
    """The dropout mask of B3's output and of B6's dv equals the plain
    version's bit for bit (q = k = 0, one-hot v and d(out) in key windows,
    as chip_smoke.py's dropout_probe)."""
    B, N, H = 4, 200, 2
    nwin = -(-N // D)
    pos = torch.arange(N, device=cuda)
    win = torch.arange(B, device=cuda) % nwin
    in_key = (pos[None] // D) == win[:, None]
    in_row = (pos[None] // D) == ((torch.arange(B, device=cuda) // nwin) % nwin)[:, None]
    onehot = torch.nn.functional.one_hot(pos % D, D).float()
    qkv = torch.zeros(B, N, 3, H, D, device=cuda)
    qkv[:, :, 2] = (onehot[None] * in_key[..., None])[:, :, None, :]
    qkv = qkv.reshape(B, N, 3 * H * D).to(dtype)
    do = (onehot[None] * in_row[..., None])[:, :, None, :].expand(B, N, H, D)
    do = do.reshape(B, N, H * D).to(dtype)
    bias = torch.where(in_key, 0.0, -1e10)
    kw = dict(dropout_rate=0.1, dropout_seeds=_seeds(cuda, B, 7))
    got = fa.flash_attention_packed(qkv, H, bias, **kw)
    want = fa.flash_attention_packed_reference(qkv, H, bias, **kw)
    assert torch.equal(got != 0, want != 0)
    gdv = fa._kernel_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw).view(
        B, N, 3, H, D)[:, :, 2]
    assert torch.equal(gdv != 0, wdv != 0)
    assert 0.8 < float((want != 0).sum()) / (int(in_key.sum()) * N * H) < 0.97


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_flash_attention_fp32_fp16_autograd_on_the_card(full_fp32, dtype):
    """The entry points with a gradient required run the kernels of the
    operands' type and give the plain versions' gradients."""
    cuda = full_fp32
    B, N, H, D = 2, 40, 2, 64
    qkv, do, bias, kw = _typed_case(cuda, B, N, H, D, dtype, 0.1)
    x = qkv.clone().requires_grad_()
    fa.flash_attention_packed(x, H, bias, **kw).backward(do)
    _assert_typed_grad(x.grad, fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw),
                       "packed", dtype, H)
    xs = [t.clone().requires_grad_() for t in _split_from_packed(qkv, H, "bnhd")]
    fa.flash_attention(*xs, bias, layout="bnhd", **kw).backward(do.view(B, N, H, D))
    for i, t in enumerate(xs):
        assert torch.equal(t.grad, x.grad.view(B, N, 3, H, D)[:, :, i]), i


def test_flash_attention_fp32_takes_unaligned_views(full_fp32):
    """fp32 operands need no 16-byte grid: a split view one element into its
    buffer runs without a copy's refusal and matches the plain version."""
    cuda = full_fp32
    B, N, H, D = 2, 33, 2, 40
    g = torch.Generator(cuda).manual_seed(3)
    buf = torch.randn(3 * B * N * H * D + 1, device=cuda, generator=g)
    q, k, v = buf[1:].view(3, B, N, H, D).unbind(0)
    assert q.data_ptr() % 16
    got = fa.flash_attention(q, k, v, layout="bnhd")
    want = fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    _assert_fwd(got, want.contiguous())


def test_bf16_attention_kernels_equal_another_build(cuda):
    """B3/B5/B6/B7 in bf16 bit for bit against another checkout's build of
    them (the parent commit's, unpacked where CXR_OTHER_CHECKOUT names):
    templating the 16-bit type must leave the bf16 instances' bits."""
    import os
    from pathlib import Path

    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.tools import compare_builds

    root = os.environ.get("CXR_OTHER_CHECKOUT")
    if not root:
        pytest.skip("set CXR_OTHER_CHECKOUT to another checkout's root")
    other = compare_builds.other_library(Path(root).resolve())
    this = _build.build()
    try:
        for B, N, H, D, rate in ((3, 200, 2, 64, 0.1), (2, 77, 2, 128, 0.0), (2, 65, 2, 192, 0.1)):
            qkv, do, bias, kw = _bwd_case(cuda, B, N, H, D, rate)
            want_o, want_g = fa._kernel(qkv, H, bias, **kw), fa._kernel_bwd(qkv, do, H, bias, **kw)
            q, k, v = _split_from_packed(qkv, H, "bhnd")
            dos = do.view(B, N, H, D).transpose(1, 2).contiguous()
            want_s = fa.flash_attention(q, k, v, bias, layout="bhnd", **kw)
            want_sg = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bhnd", **kw)
            _build.use_library(other)
            try:
                assert torch.equal(fa._kernel(qkv, H, bias, **kw), want_o), (B, N, H, D)
                assert torch.equal(fa._kernel_bwd(qkv, do, H, bias, **kw), want_g), (B, N, H, D)
                assert torch.equal(fa.flash_attention(q, k, v, bias, layout="bhnd", **kw), want_s)
                got = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bhnd", **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want_sg))
            finally:
                _build.use_library(this)
    finally:
        _build.use_library(this)


# ---------------------------------------------------------------------------
# B1 and B2 as wide as the JAX kernels (ROADMAP C8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img_t,txt_t", [(torch.bfloat16, torch.bfloat16),
                                         (torch.float16, torch.float16),
                                         (torch.float32, torch.bfloat16),
                                         (torch.float16, torch.float32)],
                         ids=["bf16", "fp16", "fp32_bf16", "fp16_fp32"])
@pytest.mark.parametrize("B,C,D", [(256, 16, 512), (13, 5, 100), (3, 200, 2048)])
def test_similarity_kernel_in_every_feature_type(cuda, img_t, txt_t, B, C, D):
    """Each side in its own type, widened in the kernel: against the plain
    version on the same (rounded) features, 1e-5; counted under its types'
    key."""
    from clip_for_dl_tpu_torch.ops import _build

    g = torch.Generator(cuda).manual_seed(D)
    img = torch.randn(B, D, device=cuda, generator=g).to(img_t)
    img[0] = 0.0
    txt = torch.randn(C, D, device=cuda, generator=g).to(txt_t)
    key = sim.launch_key(img_t, txt_t)
    before = _build.LAUNCHES[key]
    got = sim.similarity(img, txt, 0.5)
    assert _build.LAUNCHES[key] == before + 1
    torch.testing.assert_close(got, sim.similarity_reference(img, txt, 0.5), atol=1e-5, rtol=0)
    assert torch.all(got[0] == 0.0)


def test_similarity_kernel_takes_views(cuda):
    """Transposed and strided views are copied, not refused; an unaligned
    contiguous view takes the element-wise loads."""
    g = torch.Generator(cuda).manual_seed(4)
    base = torch.randn(512, 64, device=cuda, generator=g)
    img = base.T[:, ::2]  # [64, 256], strided
    txt = torch.randn(16, 257, device=cuda, generator=g)[:, 1:]  # rows off the 16-byte grid
    assert not img.is_contiguous() and not txt.is_contiguous()
    torch.testing.assert_close(sim.similarity(img, txt, 0.5),
                               sim.similarity_reference(img, txt, 0.5), atol=1e-5, rtol=0)
    flat = torch.randn(16 * 256 + 1, device=cuda, generator=g)[1:].view(16, 256)
    assert flat.is_contiguous() and flat.data_ptr() % 16
    torch.testing.assert_close(sim.similarity(flat, txt, 0.5),
                               sim.similarity_reference(flat, txt, 0.5), atol=1e-5, rtol=0)


def _float_images(cuda, shape, dtype, seed=0):
    """Float images in [0, 1], as a float pipeline hands them over."""
    g = torch.Generator(cuda).manual_seed(seed)
    return torch.rand(shape, device=cuda, generator=g).to(dtype)


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("shape", [(4, 512, 512, 1), (2, 333, 97, 3), (1, 224, 224, 3)])
def test_image_prep_kernel_takes_float_images(cuda, src, shape):
    """Float sources at input_scale 1 (fp32 read by the kernel, bf16 and fp16
    widened first), fp32 output within 1e-4 and bf16 within one bf16 step
    (1.6e-2) of the plain version; counted under the fp32-source entry."""
    from clip_for_dl_tpu_torch.ops import _build

    imgs = _float_images(cuda, shape, src)
    before = _build.LAUNCHES[prep.KERNEL_F32SRC]
    _assert_prep(imgs, 224, 224)
    assert _build.LAUNCHES[prep.KERNEL_F32SRC] == before + 2


@pytest.mark.parametrize("src", [torch.uint8, torch.float32], ids=["uint8", "fp32"])
def test_image_prep_kernel_writes_fp16_and_fp64(cuda, src):
    """fp16 output within one fp16 step at |x| ≤ 2.2 (2^-9) of the plain
    version, counted under the _fp16 key; fp64 through the fp32 instance and
    a cast, equal to the fp32 output."""
    from clip_for_dl_tpu_torch.ops import _build

    shape = (3, 333, 97, 3)
    if src == torch.uint8:
        g = torch.Generator(cuda).manual_seed(5)
        imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    else:
        imgs = _float_images(cuda, shape, src, 5)
    entry = prep.KERNEL if src == torch.uint8 else prep.KERNEL_F32SRC
    before = _build.LAUNCHES[entry + "_fp16"]
    got = prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, torch.float16)
    assert got.dtype == torch.float16 and _build.LAUNCHES[entry + "_fp16"] == before + 1
    want = prep.preprocess_reference(imgs, 224, 224, CLIP_MEAN, CLIP_STD, torch.float16)
    torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -9, rtol=0)
    wide = prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, torch.float64)
    assert wide.dtype == torch.float64
    assert torch.equal(wide, prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD,
                                                    torch.float32).double())


def _prep_entry(entry, imgs, out_h, out_w, out_dtype, src_type=None):
    """``entry``'s output for ``imgs`` (uint8 or fp32), called as the wrapper
    calls it, ``src_type`` appended for the direct entry."""
    from clip_for_dl_tpu_torch.ops import _build

    B, H, W, C = imgs.shape
    dev = imgs.device
    c_out = 3 if C == 1 else C
    out = torch.empty(B, out_h, out_w, c_out, dtype=out_dtype, device=dev)
    ty, tx = prep._device_taps(H, out_h, dev), prep._device_taps(W, out_w, dev)
    scale, bias = prep._device_scale_bias(CLIP_MEAN[:c_out] if c_out == 3 else (0.5,) * c_out,
                                          CLIP_STD[:c_out] if c_out == 3 else (0.25,) * c_out,
                                          1 / 255 if imgs.dtype == torch.uint8 else 1.0, dev)
    extra = () if src_type is None else (src_type,)
    _build.launch(entry, dev, imgs.data_ptr(), *(t.data_ptr() for t in ty + tx),
                  scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, out_h, out_w,
                  c_out, prep.OUT_TYPES[out_dtype], *extra)
    return out


@pytest.mark.parametrize("shape", [(2, 333, 97, 3), (3, 512, 512, 1), (1, 50, 30, 3)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("src", [torch.uint8, torch.float32], ids=["uint8", "fp32"])
def test_image_prep_direct_body_equals_the_staged_body(cuda, src, out_dtype, shape):
    """Where both run, the direct body gives the staged body's bits."""
    g = torch.Generator(cuda).manual_seed(6)
    if src == torch.uint8:
        imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
        staged = prep.KERNEL
    else:
        imgs = torch.rand(shape, device=cuda, generator=g)
        staged = prep.KERNEL_F32SRC
    for oh, ow in ((224, 224), (7, 21)):
        a = _prep_entry(staged, imgs, oh, ow, out_dtype)
        b = _prep_entry(prep.KERNEL_DIRECT, imgs, oh, ow, out_dtype, int(src != torch.uint8))
        assert torch.equal(a, b), (oh, ow)


@pytest.mark.parametrize("src,channels", [(torch.uint8, 30000), (torch.float32, 8000),
                                          (torch.bfloat16, 8000)],
                         ids=["uint8", "fp32", "bf16"])
def test_image_prep_kernel_runs_rows_too_wide_to_stage(cuda, src, channels):
    """A source row pair past shared memory at one output column runs the
    direct body (counted under its entry) and matches the plain version."""
    from clip_for_dl_tpu_torch.ops import _build

    shape = (2, 5, 4, channels)
    assert prep.band_plan(2, 4, channels, 3, 3, 132, 1 if src == torch.uint8 else 4).direct
    if src == torch.uint8:
        g = torch.Generator(cuda).manual_seed(7)
        imgs = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    else:
        imgs = _float_images(cuda, shape, src, 7)
    mean = tuple(0.1 + 0.8 * (i % 7) / 7 for i in range(channels))
    std = tuple(0.2 + 0.1 * (i % 3) for i in range(channels))
    before = _build.LAUNCHES[prep.KERNEL_DIRECT]
    _assert_prep(imgs, 3, 3, mean, std)
    assert _build.LAUNCHES[prep.KERNEL_DIRECT] == before + 2


def test_image_prep_kernel_takes_views(cuda):
    """A cropped view (rows strided) and a channels-first tensor permuted to
    NHWC are copied, not refused."""
    g = torch.Generator(cuda).manual_seed(8)
    big = torch.randint(0, 256, (2, 300, 300, 3), device=cuda, generator=g, dtype=torch.uint8)
    crop = big[:, 10:250, 20:260]
    nchw = torch.rand(2, 3, 200, 180, device=cuda, generator=g)
    for imgs in (crop, nchw.permute(0, 2, 3, 1)):
        assert not imgs.is_contiguous()
        _assert_prep(imgs, 224, 224)
