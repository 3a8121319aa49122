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


@pytest.mark.parametrize("channels", [1, 3])
def test_image_prep_kernel_on_decoded_16_bit_tiffs(cuda, channels):
    """B2 on a batch decoded from 16-bit grey LZW TIFFs (Predictor 2, as a
    radiograph's export) by the port's host decoder, at the main path's
    shapes: the cache's grey rows (1 channel) and a request's RGB (3),
    against its plain version; fp32 1e-4, bf16 one bf16 step (1.6e-2)."""
    import numpy as np

    from clip_for_dl_tpu_torch.native import decode_image
    from clip_for_dl_tpu_torch.testing.tiff import encode_tiff

    rng = np.random.default_rng(channels)
    batch = []
    for i in range(4):
        walk = np.cumsum(np.cumsum(rng.integers(-40, 41, (512, 512)), 0), 1)
        grey16 = ((walk - walk.min()) * 65535 // max(1, int(np.ptp(walk)))).astype(np.uint16)
        rgb = decode_image(encode_tiff(grey16, bps=16, compression=5, predictor=2,
                                       rows_per_strip=64))
        assert rgb.shape == (512, 512, 3)
        np.testing.assert_array_equal(rgb[..., 0], grey16 >> 8)
        batch.append(rgb[..., :channels])
    imgs = torch.from_numpy(np.stack(batch)).to(cuda)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)):
        got = prep.preprocess_images(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt)
        want = prep.preprocess_reference(imgs, 224, 224, CLIP_MEAN, CLIP_STD, dt)
        assert got.shape == (4, 224, 224, 3) and got.dtype == dt
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


@pytest.mark.parametrize("R,H,F", [(25216, 768, 3072), (100, 768, 3072), (33, 512, 192)])
def test_mlp_kernels_tanh(cuda, R, H, F):
    """B4 and B8 with the tanh GELU (the ViT's --fast-gelu) against their
    plain versions: B4's output within two bf16 steps (2e-2), B8's (dx, g,
    dh) within two bf16 steps at each output's largest entry; at the ViT
    train shape (B = 128 × 197 tokens), a ragged R and F past one tile.
    The erf form's outputs differ (the flag reaches the kernels), and the
    launches count under the tanh keys."""
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    w1 = (torch.randn(F, H, device=cuda, generator=gen) * H ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=cuda, generator=gen) * 0.1).bfloat16()
    w2 = (torch.randn(H, F, device=cuda, generator=gen) * F ** -0.5).bfloat16()
    b2 = (torch.randn(H, device=cuda, generator=gen) * 0.1).bfloat16()
    dy = torch.randn(R, H, device=cuda, generator=gen).bfloat16()
    before = (_build_launches(mlp.KEY_TANH), _build_launches(mlp.KEY_BWD_TANH))
    with torch.no_grad():
        got = mlp.dense_gelu_dense(x, w1, b1, w2, b2, approximate=True)
    torch.testing.assert_close(
        got.float(), mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2, True).float(),
        atol=2e-2, rtol=0)
    grads = mlp._kernel_bwd(x, w1, b1, w2, dy, True)
    for name, a, b in zip(("dx", "g", "dh"), grads,
                          mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy, True)):
        torch.testing.assert_close(a.float(), b.float(), atol=_rel_tol(b), rtol=0, msg=name)
    assert (_build_launches(mlp.KEY_TANH), _build_launches(mlp.KEY_BWD_TANH)) == (
        before[0] + 1, before[1] + 1)
    assert not torch.equal(grads[1], mlp._kernel_bwd(x, w1, b1, w2, dy)[1])


def _build_launches(key: str) -> int:
    from clip_for_dl_tpu_torch.ops import _build

    return _build.LAUNCHES[key]


def test_vit_fused_mlp_train_step_on_the_card(cuda):
    """A ViT layer with ``fused_mlp_train`` (hidden 128, MLP 256, bf16) in
    train mode, both GELU forms: B4 forward and B8 backward launch, and the
    output and every gradient stay within two bf16 steps of the plain
    route's (the kernels' plain versions on the same tensors)."""
    import contextlib
    from unittest import mock

    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    from clip_for_dl_tpu_torch.models.vit import ViTEncoderLayer

    for approximate in (False, True):
        torch.manual_seed(0)
        layer = ViTEncoderLayer(128, 2, 256, gelu_approximate=approximate, flash=True,
                                fused_mlp_train=True).to(cuda)
        cast_matmul_weights(layer, torch.bfloat16).train()
        x = torch.randn(4, 17, 128, device=cuda).bfloat16()
        keys = (mlp.KEY_TANH, mlp.KEY_BWD_TANH) if approximate else (mlp.KERNEL,
                                                                       mlp.KERNEL_BWD)
        before = [_build_launches(k) for k in keys]
        runs = []
        for plain in (False, True):
            layer.zero_grad()
            route = (mock.patch.multiple(mlp, _kernel=mlp.dense_gelu_dense_reference,
                                         _kernel_bwd=mlp.dense_gelu_dense_bwd_reference)
                     if plain else contextlib.nullcontext())
            with route:
                out = layer(x)
                out.float().square().sum().backward()
            runs.append((out.detach(), {n: p.grad.clone() for n, p in layer.named_parameters()}))
        assert [_build_launches(k) for k in keys] == [b + 1 for b in before]
        (out_k, grads_k), (out_p, grads_p) = runs
        torch.testing.assert_close(out_k.float(), out_p.float(), atol=_rel_tol(out_p), rtol=0)
        for name, g in grads_k.items():
            torch.testing.assert_close(g.float(), grads_p[name].float(),
                                       atol=_rel_tol(grads_p[name], 4), rtol=0, msg=name)


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


# ---------------------------------------------------------------------------
# evaluation from files (chip_smoke.py phase 8, at a tiny size)
# ---------------------------------------------------------------------------


def _tiny_eval_config():
    import dataclasses

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab

    preset = get_preset("zero_shot")
    model = dataclasses.replace(
        preset.model, image_size=64, max_text_length=32,
        vocab_size=len(build_dev_vocab(DISEASE_LABELS)), text_embedding_dim=128,
        text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
        text_max_position=64, resnet_stages=(1, 1, 1, 1), resnet_width=16,
        flash_attention=True, bert_fused_mlp=True)
    return preset.replace(model=model)


def _weight_sources(tmp_path, cfg):
    """A CheckpointManager directory of a seeded model, and the reference
    .pth and .safetensors mirror of the same weights."""
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights
    from clip_for_dl_tpu_torch.models.safetensors_io import save_reference_checkpoint_safetensors
    from clip_for_dl_tpu_torch.train import CheckpointManager, TrainState
    from clip_for_dl_tpu_torch.train.checkpoint import model_state, reference_models

    model = init_weights(CXRClip(cfg.model), torch.Generator().manual_seed(5))
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)))
    torch.save({"epoch": 0, "models": reference_models(model_state(model))},
               tmp_path / "ref.pth")
    save_reference_checkpoint_safetensors(model_state(model), str(tmp_path / "ref.safetensors"))
    return [str(tmp_path / "ckpt"), str(tmp_path / "ref.pth"), str(tmp_path / "ref.safetensors")]


def _eval_loader(tmp_path, size):
    from clip_for_dl_tpu_torch.data import (
        ChestXrayMultiViewDataset, HostLoader, build_exam_index, build_image_cache,
        prepare_labeled_csv, read_csv,
    )
    from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout

    paths = write_kaggle_layout(str(tmp_path / "kaggle"), 20, sizes=((80, 80), (96, 72)),
                                single_view_uids=(3,), not_png_uids=(7,))
    labeled = prepare_labeled_csv(paths["reports"], str(tmp_path / "labeled.csv"))
    index = build_exam_index(labeled, read_csv(paths["projections"]), paths["image_dir"])
    cache = build_image_cache([p for pair in zip(index.frontal_paths, index.lateral_paths)
                               for p in pair], size, str(tmp_path / "cache"), workers=2)
    return HostLoader(ChestXrayMultiViewDataset(index, size, cache=cache), 8, num_threads=2)


def _engine(model, cfg):
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    engine = ZeroShotEngine(model, BertTokenizer(build_dev_vocab(DISEASE_LABELS)),
                            DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean, cfg.augment.std,
                            cfg.model.image_size, cfg.model.max_text_length, torch.bfloat16)
    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    return engine


def test_three_weight_sources_give_equal_logits_on_the_card(cuda, tmp_path):
    """load_trained_model from a checkpoint directory, a reference .pth and
    a .safetensors mirror of the same weights: bit-equal bf16 logits on a
    grey-packed batch from the cache."""
    from clip_for_dl_tpu_torch.inference import load_trained_model

    cfg = _tiny_eval_config()
    batch = next(iter(_eval_loader(tmp_path, cfg.model.image_size)))["images"]
    logits = [_engine(load_trained_model(src, cfg, device=cuda), cfg).logits(batch)
              for src in _weight_sources(tmp_path, cfg)]
    assert logits[0].shape == (16, 16)
    assert all((x == logits[0]).all() for x in logits[1:])


def test_eval_from_files_runs_b1_to_b4_on_the_card(cuda, tmp_path):
    """run_zero_shot_eval and run_dynamic_threshold_eval over the loader
    launch B1, B2, B3 and B4, and score every exam."""
    from clip_for_dl_tpu_torch.inference import load_trained_model
    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.zeroshot import run_dynamic_threshold_eval, run_zero_shot_eval

    cfg = _tiny_eval_config()
    loader = _eval_loader(tmp_path, cfg.model.image_size)
    model = load_trained_model(_weight_sources(tmp_path, cfg)[0], cfg, device=cuda)
    _build.reset_launches()
    engine = _engine(model, cfg)
    zs = run_zero_shot_eval(engine, loader, 3, str(tmp_path / "zs.csv"))
    dyn = run_dynamic_threshold_eval(engine, lambda: iter(loader))
    torch.cuda.synchronize()
    for key in (sim.KERNEL, prep.KERNEL, "cxr_flash_fwd_packed", "cxr_mlp_fwd"):
        assert _build.LAUNCHES[key] > 0, key
    n = len(loader.dataset)
    assert len(zs["predictions"]) == len(dyn["predictions"]) == n
    assert all(0 < len(p) for p in zs["predictions"])


def _grey_cache(tmp_path, n=6):
    import numpy as np

    from clip_for_dl_tpu_torch.data import build_image_cache
    from clip_for_dl_tpu_torch.testing.png import write_png

    rng = np.random.default_rng(2)
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"CXR{i}_IM.png"))
        write_png(paths[-1], rng.integers(0, 256, (40, 36), np.uint8))
    return build_image_cache(paths, 32, str(tmp_path / "cache"), workers=2), paths


def test_device_cache_gathers_on_the_card(cuda, tmp_path):
    """The whole cache in one card tensor; gather selects rows there: the
    disk cache's bytes, −1 the zero image; rows out of range raise."""
    import numpy as np

    from clip_for_dl_tpu_torch.data import DeviceImageCache

    cache, paths = _grey_cache(tmp_path)
    dcache = DeviceImageCache(cache, device=cuda)
    assert dcache.array.device.type == "cuda" and dcache.array.shape == (7, 32, 32, 1)
    rows = np.array([[0, 5], [3, -1]])
    got = dcache.gather(rows)
    assert got.device.type == "cuda" and got.shape == (2, 2, 32, 32, 1)
    for (i, j), r in np.ndenumerate(rows):
        want = cache.get(paths[r]) if r >= 0 else np.zeros((32, 32, 1), np.uint8)
        assert (got[i, j].cpu().numpy() == want).all()
    for bad in ([-2], [6]):
        with pytest.raises(IndexError):
            dcache.gather(np.array(bad))


@pytest.mark.parametrize("threaded", [False, True])
def test_prefetch_to_device_on_the_card(cuda, threaded):
    """Numpy batches reach the card equal, each copied on a side stream the
    consumer's stream waits for; tensors already there pass untouched."""
    import numpy as np

    from clip_for_dl_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(0)
    on_card = torch.ones(3, device=cuda)
    batches = [{"images": rng.integers(0, 256, (64, 224, 224, 1), np.uint8),
                "ids": rng.integers(0, 100, (64, 200)).astype(np.int32), "kept": on_card}
               for _ in range(6)]
    got = []
    for b in prefetch_to_device(iter(batches), device=cuda, threaded=threaded):
        # consumer work queued behind the copy on the current stream
        got.append((b["images"].sum(), b["ids"].clone(), b["kept"]))
    assert len(got) == len(batches)
    for (total, ids, kept), b in zip(got, batches):
        assert ids.device.type == "cuda" and kept is on_card
        assert int(total) == int(b["images"].sum(dtype=np.int64))
        assert (ids.cpu().numpy() == b["ids"]).all()


def test_cli_zeroshot_tiny_on_the_card(cuda, tmp_path):
    """python -m clip_for_dl_tpu_torch zeroshot --tiny on the card: exit 0
    and the metrics printed."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "CLIP_FOR_DL_TPU_FORCE_CPU"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "clip_for_dl_tpu_torch", "zeroshot", "--tiny", "--synthetic",
         "--synthetic-samples", "32", "--flash-attention", "--log-dir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout)  # the command's only output: the metrics
    assert "mAP" in metrics and os.path.exists(tmp_path / "zero_shot_results.csv")


# ---------------------------------------------------------------------------
# the scripts' multi-view training and the enhance engine (chip_smoke.py
# phase 11, at a tiny size)
# ---------------------------------------------------------------------------


def _tiny_multiview_model(device, compute=torch.bfloat16, seed=0):
    import dataclasses

    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.core.device import cast_in_forward
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights

    preset = get_preset("multimodal_attention")
    cfg = dataclasses.replace(
        preset.model, image_size=64, max_text_length=32, vocab_size=128,
        text_embedding_dim=128, text_layers=2, text_heads=2, text_intermediate_dim=256,
        shared_embedding_dim=64, text_max_position=64, resnet_stages=(1, 1, 1, 1),
        resnet_width=16, flash_attention=True, bert_fused_mlp=True)
    model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(seed)).to(device)
    if compute != torch.float32:
        cast_in_forward(model, compute)
    return preset, cfg, model


def test_augment_warp_on_the_card_equals_its_cpu_result(cuda):
    """warp of a normalized bf16 and fp32 batch on the card, on parameters
    drawn on the CPU: fp32 within 1e-5 of the CPU result; bf16 within one
    bf16 step at |x| ≤ 2.7 (2^-6)."""
    from clip_for_dl_tpu_torch.ops.augment import sample_augment, warp

    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 224, 224, 3, generator=g)
    params = sample_augment(16, g, 0.5, 10.0, 0.1, 224, 224)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        want = warp(x.to(dt), *params)
        got = warp(x.to(dt).to(cuda), *(p.to(cuda) for p in params))
        assert got.device.type == "cuda" and got.dtype == dt
        torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=0)


def test_multiview_step_on_the_card_matches_the_plain_route(cuda):
    """The multimodal preset's step (bf16, augmentation, the attention and
    the asymmetric loss) on the card, twice from the same weights,
    generator, global seed and shared B2 output: once as it runs (B2
    launched once a step, on the 2B views) and once with B2's plain
    version: the same loss and gradients, bit for bit (no other kernel is
    on the step's path, and cuDNN runs deterministically here)."""
    from unittest import mock

    import numpy as np

    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.train import (
        TrainState, make_label_fn, make_multiview_train_step, make_optimizer, steps,
    )

    preset, cfg, model = _tiny_multiview_model(cuda)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    views = rng.integers(0, 256, (8, 2, 96, 96, 1), np.uint8)
    batch = {"images": torch.from_numpy(views).to(cuda),
             "labels": torch.from_numpy((rng.random((8, 16)) < 0.3).astype(np.float32)).to(cuda)}
    bank = torch.nn.functional.normalize(torch.randn(16, 64, device=cuda), dim=-1)
    prep_args = (64, 64, preset.augment.mean, preset.augment.std, torch.bfloat16)
    flat = batch["images"].reshape(16, 96, 96, 1)
    shared = prep.preprocess_images(flat, *prep_args)
    torch.testing.assert_close(shared.float(), prep.preprocess_reference(flat, *prep_args).float(),
                               atol=1.6e-2, rtol=0)

    def one_step(fn):
        torch.manual_seed(2)  # the dropouts outside the fusion draw from the global generator
        model.load_state_dict(init)
        label_fn = make_label_fn([])
        opt = make_optimizer(model, label_fn, weight_decay=preset.train.weight_decay)
        step = make_multiview_train_step(
            model, opt, label_fn, cfg.temperature, image_size=64, mean=preset.augment.mean,
            std=preset.augment.std, use_enhance=True, augment=True)
        with mock.patch.object(steps, "preprocess_images", fn):
            _, out = step(TrainState(model, opt), batch, bank, {"default": 1e-4},
                          torch.Generator(cuda).manual_seed(1))
        return float(out["loss"]), [p.grad.clone() for p in model.parameters()]

    def kernel_route(images, *a):
        assert images.shape == flat.shape
        prep.preprocess_images(images, *a)  # the launch the step makes
        return shared

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _build.reset_launches()
        loss_k, grads_k = one_step(kernel_route)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {prep.KERNEL: 1}, dict(_build.LAUNCHES)
        loss_p, grads_p = one_step(lambda images, *a: shared)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    assert np.isfinite(loss_k) and loss_k == loss_p
    assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_p))


def test_enhance_engine_launches_b1_on_the_card(cuda):
    """ZeroShotEngine(use_enhance=True) over the multimodal model in bf16:
    B1 (and B2) launched per batch, the probabilities within 5e-3 of the
    same engine with B1 and B2 on their plain versions."""
    from unittest import mock

    import numpy as np

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights
    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    import dataclasses

    preset, cfg, _ = _tiny_multiview_model(cuda)
    vocab = build_dev_vocab(DISEASE_LABELS)
    cfg = dataclasses.replace(cfg, vocab_size=len(vocab))
    model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(3)).to(cuda)
    cast_matmul_weights(model, torch.bfloat16)
    engine = ZeroShotEngine(model, BertTokenizer(vocab), DISEASE_LABELS, preset.zeroshot,
                            preset.augment.mean, preset.augment.std, 64, 32, torch.bfloat16,
                            use_enhance=True)
    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    imgs = np.random.default_rng(4).integers(0, 256, (12, 80, 80, 1), np.uint8)
    _build.reset_launches()
    got = engine.probs(imgs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[sim.KERNEL] == 1 and _build.LAUNCHES[prep.KERNEL] == 1
    with mock.patch.object(sim, "_kernel", sim.similarity_reference), \
            mock.patch.object(prep, "_kernel", prep.preprocess_reference):
        want = engine.probs(imgs)
    assert got.shape == (12, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


# ---------------------------------------------------------------------------
# interpretability (chip_smoke.py phase 13, at a tiny size)
# ---------------------------------------------------------------------------


def _tiny_interpret_model(device, tower: str):
    """A bf16 serving model (matmul weights cast) with both towers' kernel
    gates open: BERT and the ViT at hidden 128, MLP 256; flash attention,
    the BERT MLP kernel and the ViT's fused MLP on."""
    import dataclasses

    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights

    preset = get_preset("vit" if tower == "vit" else "zero_shot")
    cfg = dataclasses.replace(
        preset.model, image_size=64, max_text_length=32, vocab_size=128,
        text_embedding_dim=128, text_layers=2, text_heads=2, text_intermediate_dim=256,
        shared_embedding_dim=64, text_max_position=64, resnet_stages=(1, 1, 1, 1),
        resnet_width=16, vit_layers=2, vit_hidden=128, vit_heads=2, vit_mlp_dim=256,
        flash_attention=True, bert_fused_mlp=True, vit_fused_mlp=True)
    model = init_weights(CXRClip(cfg), torch.Generator().manual_seed(5)).to(device)
    cast_matmul_weights(model, torch.bfloat16)
    return preset, model.eval()


def test_gradcam_on_the_card_holds_against_b2s_plain_version(cuda):
    """gradcam on a bf16 ResNet, fp32 prep of two grey 96 × 96 views: B2
    launched once, and against the same call with B2's plain version the
    scores within 1e-3 of the largest one and the CAMs [16, 2, 2, 2] within 1e-3
    (B2's fp32 outputs differ by ≤ 1e-4 and the tower casts them to
    bf16)."""
    from unittest import mock

    from clip_for_dl_tpu_torch.interpret import gradcam
    from clip_for_dl_tpu_torch.ops import _build

    preset, model = _tiny_interpret_model(cuda, "resnet")
    g = torch.Generator(cuda).manual_seed(6)
    views = torch.randint(0, 256, (2, 96, 96, 1), device=cuda, generator=g, dtype=torch.uint8)
    text = torch.randn(16, 64, device=cuda, generator=g)
    args = (64, 64, preset.augment.mean, preset.augment.std, torch.float32)
    _build.reset_launches()
    cams, scores = gradcam(model, prep.preprocess_images(views, *args), text)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {prep.KERNEL: 1}
    with mock.patch.object(prep, "_kernel", prep.preprocess_reference):
        cams_p, scores_p = gradcam(model, prep.preprocess_images(views, *args), text)
    assert cams.shape == (16, 2, 2, 2) and torch.isfinite(cams).all()
    assert float((scores - scores_p).abs().max()) <= 1e-3 * float(scores_p.abs().max())
    torch.testing.assert_close(cams, cams_p, atol=1e-3, rtol=0)


def test_rollout_on_the_card_holds_against_the_plain_route(cuda):
    """vit_rollout on a bf16 --fused-mlp --flash-attention ViT: B2 and B9
    launched, B3 never (sowing turns flash off); B9 at its first inputs on
    this path against its plain version, on the MLP branch out - x within
    2^-6 of its largest entry (chip_smoke.py's mlp_block_rel: the mask
    below is nearly flat on random weights, so it alone would not catch a
    wrong B9); the sowing forward's features bit-equal to the forward with
    flash off; the mask within 2e-2 of the plain route's (B2 and B9 on
    their plain versions), cosine ≥ 0.999."""
    from unittest import mock

    from clip_for_dl_tpu_torch.interpret import vit_rollout
    from clip_for_dl_tpu_torch.ops import _build

    preset, model = _tiny_interpret_model(cuda, "vit")
    tower = model.image_tower
    g = torch.Generator(cuda).manual_seed(7)
    views = torch.randint(0, 256, (2, 96, 96, 1), device=cuda, generator=g, dtype=torch.uint8)
    args = (64, 64, preset.augment.mean, preset.augment.std, torch.float32)
    kept, kernel = [], mlp_block._kernel

    def keep(*a, **kw):
        if not kept:
            kept.append(([t.clone() if torch.is_tensor(t) else t for t in a], dict(kw)))
        return kernel(*a, **kw)

    _build.reset_launches()
    with mock.patch.object(mlp_block, "_kernel", keep):
        mask = vit_rollout(tower, prep.preprocess_images(views, *args))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches.get(prep.KERNEL) == 1 and launches.get(mlp_block.KERNEL) == 2
    assert launches.get(fa.KERNEL, 0) == 0
    a, kw = kept[0]
    x0 = a[0].float()
    want = mlp_block.fused_mlp_block_reference(*a, **kw).float() - x0
    branch_err = float((mlp_block._kernel(*a, **kw).float() - x0 - want).abs().max())
    assert branch_err <= 2.0 ** -6 * float(want.abs().max())
    x = prep.preprocess_images(views, *args)
    with torch.no_grad():
        feats, _ = tower(x, sow_weights=True)
        for layer in tower.encoder.layers:
            layer.self_attention.flash = False
        try:
            plain_feats = tower(x)
        finally:
            for layer in tower.encoder.layers:
                layer.self_attention.flash = True
    assert torch.equal(feats, plain_feats)
    with mock.patch.object(prep, "_kernel", prep.preprocess_reference), \
            mock.patch.object(mlp_block, "_kernel", mlp_block.fused_mlp_block_reference):
        mask_p = vit_rollout(tower, prep.preprocess_images(views, *args))
    assert mask.shape == (2, 4, 4) and torch.isfinite(mask).all()
    torch.testing.assert_close(mask, mask_p, atol=2e-2, rtol=0)
    cos = torch.nn.functional.cosine_similarity(mask.flatten(), mask_p.flatten(), dim=0)
    assert float(cos) >= 0.999


# -- the operators and the exported programs (ROADMAP A9b) ----------------------------------


def _launch_delta(fn):
    """(fn's result, the launches it added, per key)."""
    from clip_for_dl_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                 if v != before.get(k, 0)}


def test_operators_launch_their_kernels(cuda):
    """Each ``cxr`` operator on CUDA tensors launches its kernel once and
    matches the plain version at the kernel tests' tolerances (B1 1e-5, B2
    bf16 one step, B3 and B4 2e-2, B9's branch two bf16 steps of its
    largest entry)."""
    ops = torch.ops.cxr
    g = torch.Generator(cuda).manual_seed(3)
    img, txt = torch.randn(8, 512, device=cuda, generator=g), torch.randn(16, 512, device=cuda,
                                                                          generator=g)
    got, n = _launch_delta(lambda: ops.similarity(img, txt, 0.5))
    assert n == {sim.KERNEL: 1}
    torch.testing.assert_close(got, sim.similarity_reference(img, txt, 0.5), atol=1e-5, rtol=0)
    u8 = torch.randint(0, 256, (2, 512, 512, 3), device=cuda, generator=g, dtype=torch.uint8)
    args = (224, 224, list(CLIP_MEAN), list(CLIP_STD), torch.bfloat16)
    got, n = _launch_delta(lambda: ops.preprocess_images(u8, *args))
    assert n == {prep.KERNEL: 1}
    want = prep.preprocess_reference(u8, 224, 224, CLIP_MEAN, CLIP_STD, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2, rtol=0)
    qkv = torch.randn(2, 200, 3 * 12 * 64, device=cuda, generator=g).bfloat16()
    bias = torch.zeros(2, 200, device=cuda)
    got, n = _launch_delta(lambda: ops.flash_attention_packed(qkv, 12, bias, 0.0, None))
    assert n == {fa.KERNEL: 1}
    torch.testing.assert_close(got.float(), fa.flash_attention_packed_reference(
        qkv, 12, bias).float(), atol=2e-2, rtol=0)
    x = torch.randn(400, 768, device=cuda, generator=g).bfloat16()
    w1 = (torch.randn(3072, 768, device=cuda, generator=g) / 28).bfloat16()
    w2 = (torch.randn(768, 3072, device=cuda, generator=g) / 55).bfloat16()
    b1, b2 = torch.zeros(3072, device=cuda).bfloat16(), torch.zeros(768, device=cuda).bfloat16()
    got, n = _launch_delta(lambda: ops.dense_gelu_dense(x, w1, b1, w2, b2, False))
    assert n == {mlp.KERNEL: 1}
    torch.testing.assert_close(got.float(), mlp.dense_gelu_dense_reference(
        x, w1, b1, w2, b2).float(), atol=2e-2, rtol=0)
    ls, lb = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    fb1, fb2 = torch.zeros(3072, device=cuda), torch.zeros(768, device=cuda)
    got, n = _launch_delta(lambda: ops.fused_mlp_block(x, ls, lb, w1, fb1, w2, fb2, 1e-6, False))
    assert n == {mlp_block.KERNEL: 1}
    want = mlp_block.fused_mlp_block_reference(x, ls, lb, w1, fb1, w2, fb2).float() - x.float()
    err = float((got.float() - x.float() - want).abs().max())
    assert err <= 2.0 ** -6 * float(want.abs().max())


def _export_config(tower: str):
    import dataclasses

    from clip_for_dl_tpu_torch.core.config import get_preset

    preset = get_preset("vit" if tower == "vit" else "zero_shot")
    return preset.replace(model=dataclasses.replace(
        preset.model, image_size=64, max_text_length=32, vocab_size=128,
        text_embedding_dim=128, text_layers=1, text_heads=2, text_intermediate_dim=256,
        shared_embedding_dim=64, text_max_position=64, resnet_stages=(1, 1, 1, 1),
        resnet_width=16, vit_layers=1, vit_hidden=128, vit_heads=2, vit_mlp_dim=256,
        flash_attention=True, bert_fused_mlp=True, vit_fused_mlp=True))


def test_cpu_traced_artifact_runs_b1_and_b2_on_the_card(cuda, tmp_path):
    """A folded bf16 ResNet scorer and its adapter head, traced on the CPU
    and loaded onto the card, launch B2 (and B1) on every batch; each
    answer equals the live engines' on the card over the same weights and
    bank, bit for bit, at b = 1 and 3."""
    from clip_for_dl_tpu_torch import export
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    from clip_for_dl_tpu_torch.inference import AdapterEngine
    from clip_for_dl_tpu_torch.models import CXRClip, fold_clip_image_tower, init_weights
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine

    cfg = _export_config("resnet")
    m = cfg.model
    model = init_weights(CXRClip(m), torch.Generator().manual_seed(5))
    folded = CXRClip(m, fold_bn=True)
    folded.load_state_dict(fold_clip_image_tower(model.state_dict()))
    cast_matmul_weights(folded, torch.bfloat16).eval()
    bank = torch.nn.functional.normalize(torch.randn(16, 64, generator=torch.Generator()
                                                     .manual_seed(1)), dim=-1)
    mean, std = cfg.augment.mean, cfg.augment.std
    export.write_artifact(
        str(tmp_path), None,
        singleview_bytes=export.export_singleview_scorer(
            folded, bank, 64, mean, std, cfg.zeroshot.temperature, source_hw=(96, 96)),
        adapter_bytes=export.export_adapter_scorer(folded, 64, mean, std, source_hw=(96, 96)))
    programs = {"zeroshot": export.ExportedEngine(str(tmp_path)),
                "adapter": export.ExportedEngine(str(tmp_path), module=export.ADAPTER_FILE)}
    assert programs["zeroshot"].device.type == "cuda"
    live_model = folded.to(cuda)
    live = {"zeroshot": ZeroShotEngine(live_model, None, DISEASE_LABELS, cfg.zeroshot, mean,
                                       std, 64),
            "adapter": AdapterEngine(live_model, mean, std, 64)}
    live["zeroshot"].text_features = bank.to(cuda)
    g = torch.Generator(cuda).manual_seed(2)
    for b in (1, 3):
        imgs = torch.randint(0, 256, (b, 96, 96, 3), device=cuda, generator=g,
                             dtype=torch.uint8)
        for head, kernels in (("zeroshot", {sim.launch_key(torch.float32, torch.float32),
                                            prep.KERNEL}), ("adapter", {prep.KERNEL})):
            got, n = _launch_delta(lambda: programs[head].logits(imgs))
            assert set(n) == kernels and all(v == 1 for v in n.values()), (head, n)
            assert (got == live[head].logits(imgs)).all(), head


def test_vit_and_bert_exports_launch_b3_b4_b9(cuda):
    """The fused-MLP ViT's score_image and the flash, fused-MLP BERT's
    encode_text, exported on the card: B3 and B9 (ViT), B3 and B4 (BERT)
    launch, and each program's output equals its live forward."""
    from clip_for_dl_tpu_torch import export
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    import io

    from clip_for_dl_tpu_torch.models import CXRClip, init_weights

    cfg = _export_config("vit")
    model = init_weights(CXRClip(cfg.model), torch.Generator().manual_seed(6)).to(cuda)
    cast_matmul_weights(model, torch.bfloat16).eval()
    bank = torch.nn.functional.normalize(torch.randn(16, 64, device=cuda), dim=-1)
    mean, std = cfg.augment.mean, cfg.augment.std

    def load(data):
        return torch.export.load(io.BytesIO(data)).module()

    image = load(export.export_singleview_scorer(model, bank, 64, mean, std, 0.5))
    text = load(export.export_text_encoder(model, 32))
    live_image = export.make_singleview_scorer(model, bank, 64, mean, std, 0.5)
    live_text = export.make_text_encoder(model)
    g = torch.Generator(cuda).manual_seed(4)
    imgs = torch.randint(0, 256, (3, 64, 64, 3), device=cuda, generator=g, dtype=torch.uint8)
    ids = torch.randint(1, 128, (5, 32), device=cuda, generator=g, dtype=torch.int32)
    mask = (torch.arange(32, device=cuda)[None] < torch.tensor([[32], [5], [9], [1], [20]],
                                                               device=cuda)).int()
    with torch.inference_mode():
        got, n = _launch_delta(lambda: image(imgs))
        assert {fa.KERNEL, mlp_block.KERNEL, prep.KERNEL} <= set(n), n
        assert torch.equal(got, live_image(imgs))
        got, n = _launch_delta(lambda: text(ids, mask))
        assert {fa.KERNEL, mlp.KERNEL} <= set(n), n
        assert torch.equal(got, live_text(ids, mask))


# -- data parallelism over NCCL (ROADMAP A7), one rank a card ---------------------------


def _dp_case(**extra):
    """A phase-A step case for ``testing.ranks`` on the card: a narrow
    CXRClip (ResNet (1, 1, 1, 1) at 16, BERT 2 x 128) from the port's seeded
    init, fp32 through the fp32 attention kernels, 16 pairs of 64-px grey
    images, SGD at lr 1 after the clip at 1."""
    import numpy as np

    rng = np.random.default_rng(0)
    mask = np.ones((16, 24), np.int32)
    mask[::3, 10:] = 0
    config = dict(image_size=64, max_text_length=24, vocab_size=128, text_embedding_dim=128,
                  text_layers=2, text_heads=2, text_intermediate_dim=256,
                  shared_embedding_dim=64, text_max_position=32, resnet_stages=(1, 1, 1, 1),
                  resnet_width=16, dropout=0.0, flash_attention=True)
    case = dict(kind="pretrain", config=config, seed=3, device="cuda", loss="clip_self_distill",
                temperature=2.0, clip=1.0, groups=[], lrs={"default": 1.0}, image_size=64,
                mean=CLIP_MEAN, std=CLIP_STD,
                batch={"images": rng.integers(0, 256, (16, 80, 80, 1), dtype=np.uint8),
                       "input_ids": rng.integers(5, 128, (16, 24)).astype(np.int32),
                       "attention_mask": mask})
    return {**case, **extra}


DP_CASES = {"self_distill": ("clip_self_distill", False), "siglip": ("siglip", False),
            "self_distill_local": ("clip_self_distill", True), "siglip_ring": ("siglip", True)}


@pytest.fixture(scope="module")
def nccl_steps(tmp_path_factory):
    """Every case of DP_CASES run once by one NCCL rank (its own process,
    killed past a deadline)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from clip_for_dl_tpu_torch.testing import ranks

    cases = {name: _dp_case(loss=loss, local=local) for name, (loss, local) in DP_CASES.items()}
    return cases, ranks.launch(cases, 1, str(tmp_path_factory.mktemp("nccl")), timeout=300,
                               device="cuda")[0]


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_step_over_nccl_equals_the_plain_step(cuda, nccl_steps, name):
    """The step through parallel.dp on one NCCL rank (the global or
    local-loss form, the gradients' all-reduce before the clip) against the
    plain step in this process, on the fp32 route: the loss at 1e-5
    relative, each module's change (its clipped gradient: the towers', the
    projections', the rest's, concatenated, as the smoke's phases hold a
    step's groups) at cosine 0.9999 or better."""
    import numpy as np

    from clip_for_dl_tpu_torch.testing import ranks

    cases, out = nccl_steps
    got = out[name]
    want_losses, _, want = ranks.step_case(dict(cases[name], local=False))
    assert got["losses"][0] == pytest.approx(want_losses[0], rel=1e-5)
    for group in {k.split(".")[0] for k in want}:
        keys = sorted(k for k in want if k.split(".")[0] == group)
        a = np.concatenate([got["delta"][k].ravel() for k in keys]).astype(np.float64)
        b = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
        if np.abs(b).max() > 0:
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= 0.9999, (group, cos)


def test_global_batch_losses_over_nccl_equal_the_plain_losses(cuda, tmp_path):
    """The seven global-batch losses and make_global on one NCCL rank
    against the plain losses on the card: values at 1e-5 relative, the
    gradients at 5e-5 of their largest entry (the local forms build the
    self-distill targets from the row normalizers, another order of the
    same fp32 sums)."""
    import numpy as np

    from clip_for_dl_tpu_torch.losses import contrastive
    from clip_for_dl_tpu_torch.testing import ranks

    rng = np.random.default_rng(1)
    bank = rng.standard_normal((16, 32)).astype(np.float32)
    x = dict(txt=(rng.standard_normal((32, 32)) * 0.5).astype(np.float32),
             img=(rng.standard_normal((32, 32)) * 0.5).astype(np.float32),
             labels=(rng.random((32, 16)) < 0.3).astype(np.float32),
             bank=bank / np.linalg.norm(bank, axis=1, keepdims=True), scale=7.0, bias=-4.0)
    got = ranks.launch({"losses": dict(kind="losses", device="cuda", **x)}, 1, str(tmp_path),
                       timeout=300, device="cuda")[0]["losses"]
    plain = {
        "global_clip_self_distill": lambda t, i, lbl, bank: contrastive.clip_self_distill_loss(
            t, i, 2.0),
        "global_info_nce": lambda t, i, lbl, bank: contrastive.info_nce_loss(i, t, 0.5),
        "global_multilabel": lambda t, i, lbl, bank: contrastive.multilabel_contrastive_loss(
            i, bank, lbl, 0.07),
        "global_siglip": lambda t, i, lbl, bank: contrastive.siglip_loss(t, i, 7.0, -4.0),
        "ring_siglip": lambda t, i, lbl, bank: contrastive.siglip_loss(t, i, 7.0, -4.0),
        "local_info_nce": lambda t, i, lbl, bank: contrastive.info_nce_loss(i, t, 0.5),
        "local_clip_self_distill": lambda t, i, lbl, bank: (
            contrastive.clip_self_distill_loss(t, i, 2.0)),
        "make_global": lambda t, i, lbl, bank: contrastive.clip_self_distill_loss(t, i, 2.0),
    }
    assert set(got) == set(plain)
    for name, fn in plain.items():
        t = torch.tensor(x["txt"], device=cuda, requires_grad=True)
        i = torch.tensor(x["img"], device=cuda, requires_grad=True)
        loss = fn(t, i, torch.tensor(x["labels"], device=cuda),
                  torch.tensor(x["bank"], device=cuda))
        loss.backward()
        assert got[name]["loss"] == pytest.approx(float(loss.detach()), rel=1e-5), name
        for key, want in (("dtxt", t.grad), ("dimg", i.grad)):
            want = want.cpu().numpy() if want is not None else np.zeros_like(x["txt"])
            np.testing.assert_allclose(got[name][key], want,
                                       atol=5e-5 * float(np.abs(want).max()) + 1e-12, rtol=0,
                                       err_msg=f"{name} {key}")


# -- tensor and sequence parallelism (ROADMAP A7b) ---------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("t", [2, 4])
def test_head_offset_kernels_equal_the_unsharded_heads(cuda, t, dtype):
    """B3 and B6 on each tensor-parallel rank's heads with ``head_offset``
    (dropout 0.1, padded keys): bit for bit the unsharded kernel's heads;
    offset 0 bit for bit the call without it."""
    B, N, H, D = 4, 200, 12, 64
    g = torch.Generator(cuda).manual_seed(3)
    qkv = torch.randn(B, N, 3 * H * D, device=cuda, generator=g).to(dtype)
    do = torch.randn(B, N, H * D, device=cuda, generator=g).to(dtype)
    lengths = torch.randint(3, N + 1, (B, 1), device=cuda, generator=g)
    bias = torch.where(torch.arange(N, device=cuda)[None] < lengths, 0.0, -1e10)
    kw = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, cuda))
    full = fa.flash_attention_packed(qkv, H, bias, **kw).view(B, N, H, D)
    dfull = fa.flash_attention_packed_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)
    assert torch.equal(fa.flash_attention_packed(qkv, H, bias, **kw, head_offset=0),
                       full.reshape(B, N, -1))
    h = H // t
    for r in range(t):
        sl = slice(r * h, (r + 1) * h)
        local = torch.cat([x[:, :, sl].reshape(B, N, -1)
                           for x in qkv.view(B, N, 3, H, D).unbind(2)], -1)
        dl = do.view(B, N, H, D)[:, :, sl].reshape(B, N, -1).contiguous()
        got = fa.flash_attention_packed(local, h, bias, **kw, head_offset=r * h)
        assert torch.equal(got, full[:, :, sl].reshape(B, N, -1)), r
        dgot = fa.flash_attention_packed_bwd(local, dl, h, bias, **kw, head_offset=r * h)
        assert torch.equal(dgot.view(B, N, 3, h, D), dfull[:, :, :, sl]), r


@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_tp_layer_shares_on_the_card(cuda, kind):
    """Every rank's share of a bf16 layer (hidden 256, 4 heads, MLP 1024:
    B3/B6 at a head, B4/B8 at F/tp) run one after another on the card, the
    partials summed here, against the unsharded layer on the kernels: the
    output and the input gradient within four bf16 steps of their largest
    entry, each weight's gradient at cosine 0.999 (chip_smoke.py phase 16's
    rule, TOL tp_layer_rel and tp_grad_cos)."""
    import copy

    from clip_for_dl_tpu_torch.core.device import cast_in_forward, plain_name
    from clip_for_dl_tpu_torch.models import bert as bert_module
    from clip_for_dl_tpu_torch.models import init_weights
    from clip_for_dl_tpu_torch.models import vit as vit_module
    from clip_for_dl_tpu_torch.parallel import tp
    from clip_for_dl_tpu_torch.parallel.common import Mesh2D, rank_grid

    g = torch.Generator(cuda).manual_seed(5)
    if kind == "bert":
        base = bert_module.BertLayer(256, 4, 1024, dropout=0.1, flash=True, fused_mlp=True)
        bias = torch.zeros(8, 128, device=cuda)
        bias[::3, 100:] = -1e10
        run = lambda layers, x: bert_module.layer_shares(
            layers, x, bias, torch.Generator(cuda).manual_seed(1))
    else:
        base = vit_module.ViTEncoderLayer(256, 4, 1024, flash=True, fused_mlp_train=True)
        run = lambda layers, x: vit_module.layer_shares(layers, x)
    base = init_weights(base.to(cuda), g).train()
    mesh = lambda t, r: Mesh2D(rank_grid(t, t), ("data", "model"), r, None, None)
    shard = lambda t, r: cast_in_forward(tp.tensor_parallel_(copy.deepcopy(base), mesh(t, r),
                                                             share=r), torch.bfloat16)
    x = torch.randn(8, 128, 256, device=cuda, generator=g).bfloat16().requires_grad_()
    whole = shard(1, 0)
    want = run([whole], x)
    dy = (torch.randn(want.shape, device=cuda, generator=g) * 0.1).bfloat16()
    want.backward(dy)
    wx, x.grad = x.grad.clone(), None
    wgrads = {plain_name(n): p.grad.float() for n, p in whole.named_parameters()}
    top = max(float(w.norm()) for w in wgrads.values())
    for t in (2, 4):
        shares = [shard(t, r) for r in range(t)]
        got = run(shares, x)
        got.backward(dy)
        for a, b in ((got.detach(), want.detach()), (x.grad, wx)):
            assert float((a.float() - b.float()).abs().max()) <= 2.0 ** -5 * float(
                b.float().abs().max())
        grads = [{plain_name(n): p.grad for n, p in s.named_parameters()} for s in shares]
        for n, w in wgrads.items():
            if float(w.norm()) < 1e-3 * top:  # the key bias: zero but for rounding
                continue
            gathered = tp.gather_tensor([s[n] for s in grads], tp.layer_spec(n, w)).float()
            cos = torch.nn.functional.cosine_similarity(gathered.flatten(), w.flatten(), dim=0)
            assert float(cos) >= 0.999, (n, float(cos))
        x.grad = None


@pytest.fixture(scope="module")
def nccl_tp(tmp_path_factory):
    """The tensor and sequence parallel cases of ``testing.ranks`` run once
    by one NCCL rank (tp 1 over the group of one card): a narrow BERT
    forward, the pretrain step with attention dropout 0.1, the engine and
    sequence_sharded_fn, from the port's seeded init."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import numpy as np

    from clip_for_dl_tpu_torch.models.bert import BertEncoder
    from clip_for_dl_tpu_torch.testing import ranks
    from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS

    torch.manual_seed(0)
    bert = dict(vocab_size=128, hidden=128, layers=2, heads=2, intermediate=256,
                max_position=64, flash=True)
    state = {k: v.numpy() for k, v in BertEncoder(**bert).state_dict().items()}
    rng = np.random.default_rng(2)
    mask = np.ones((4, 50), np.int32)
    mask[:, 45:] = 0
    text = {"ids": rng.integers(0, 128, (4, 50)).astype(np.int32), "mask": mask}
    step = _dp_case(config=dict(_dp_case()["config"], dropout=0.1), adamw=True,
                    seeds=[rng.integers(-2 ** 31, 2 ** 31, (16, 1)).astype(np.int32)
                           for _ in range(2)], groups=["text_tower", "image_tower"],
                    lrs={"text_tower": 1e-3, "image_tower": 1e-3, "default": 0.0},
                    weight_decay=1e-3, tp=1)
    step["kind"] = "tp_step"
    vocab = build_dev_vocab(DISEASE_LABELS)
    engine = dict(kind="tp_engine", tp=1, device="cuda", seed=4, vocab=vocab,
                  config=dict(_dp_case()["config"], vocab_size=len(vocab)), image_size=64,
                  max_text_length=24,
                  images=rng.integers(0, 255, (10, 64, 64, 3), dtype=np.uint8))
    cases = {"fwd": dict(kind="tp_forward", tower="bert", config=bert, state=state,
                         inputs=text, tp=1, device="cuda"),
             "sp": dict(kind="sp", tower="bert", config=bert, state=state, inputs=text, tp=1,
                        tp_params=False, device="cuda"),
             "sp_tp": dict(kind="sp", tower="bert", config=bert, state=state, inputs=text,
                           tp=1, tp_params=True, device="cuda"),
             "step": step, "engine": engine}
    return cases, ranks.launch(cases, 1, str(tmp_path_factory.mktemp("nccl_tp")), timeout=300,
                               device="cuda")[0]


def test_tp_cases_over_nccl_equal_the_plain_runs(cuda, nccl_tp):
    """Over one NCCL rank (fp32, TF32 off): the BERT forward through the
    TP layers at tp 1 and sequence_sharded_fn (replicated) bit for bit the
    plain forward on the card, with tp_params within 1e-5; the TP step
    (attention dropout 0.1 through the fixed seeds, BatchNorm over the
    group's data axis) against the plain step as the data-parallel cases
    above: the loss within 1e-5 relative, each module's clipped gradient
    at cosine 0.9999; the engine's logits within 1e-5 of the plain
    engine's."""
    import numpy as np

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, ZeroShotConfig
    from clip_for_dl_tpu_torch.testing import ranks
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    cases, out = nccl_tp
    with ranks.fp32_exact(), torch.no_grad():
        tower = ranks._tp_tower(cases["fwd"])
        want = tower(*ranks.tensors(cases["fwd"]["inputs"], cuda).values()).cpu().numpy()
    assert np.array_equal(out["fwd"]["out"], want)
    assert np.array_equal(out["sp"]["out"], want)
    np.testing.assert_allclose(out["sp_tp"]["out"], want, atol=1e-5, rtol=0)
    plain = ranks._tp_step_case(dict(cases["step"], plain=True))
    assert out["step"]["loss"] == pytest.approx(plain["loss"], rel=1e-5)
    assert out["step"]["seed_calls"] == plain["seed_calls"] == 2
    for group in {k.split(".")[0] for k in plain["grads"]}:
        keys = sorted(k for k in plain["grads"] if k.split(".")[0] == group)
        a = np.concatenate([out["step"]["grads"][k].ravel() for k in keys]).astype(np.float64)
        b = np.concatenate([plain["grads"][k].ravel() for k in keys]).astype(np.float64)
        if np.abs(b).max() > 0:
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999, group
    case = cases["engine"]
    with ranks.fp32_exact():
        engine = ZeroShotEngine(ranks.model_from(case), BertTokenizer(case["vocab"]),
                                DISEASE_LABELS, ZeroShotConfig(), image_size=64,
                                max_text_length=24, compute_dtype=torch.float32)
        engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        np.testing.assert_allclose(out["engine"]["logits"], engine.logits(case["images"]),
                                   atol=1e-5, rtol=0)


def test_moe_layer_on_the_card(cuda):
    """The MoE layer's expert products on the card (16-bit operands into
    fp32 outputs, ``torch.bmm(..., out_dtype=torch.float32)``) at 4 experts
    of 256 -> 512 over 8 x 100 tokens, some padding: the bf16 layer (fp32
    masters cast in the forward) within four bf16 steps (2^-6) of the
    output's largest entry from its fp32 route (TF32 off); each expert
    product, forward and backward, within 2^-14 of its largest entry from
    the fp32 product of its operands, and the experts before the final
    cast within 2^-10 from fp32 on the layer's bf16 operands (x, wi, wo,
    the hidden rounded to bf16 between the products), TF32 off, both of
    which products rounded to bf16 fail (chip_smoke.py's moe_product_rel
    and moe_products_rel); its backward runs; every ep share (2, 4) run one
    after another and summed gives the unsharded bf16 layer's output, aux
    loss and every gradient bit for bit."""
    import copy
    from unittest import mock

    import torch.nn.functional as F

    from clip_for_dl_tpu_torch.core.device import cast_in_forward
    from clip_for_dl_tpu_torch.models import moe
    from clip_for_dl_tpu_torch.models.moe import (
        ExpertShard, SwitchMoEMLP, moe_shares, route, routing,
    )
    from clip_for_dl_tpu_torch.parallel.ep import shard_experts_
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact

    g = torch.Generator(cuda).manual_seed(0)
    with torch.device(cuda):
        layer = SwitchMoEMLP(256, 512, 4, 1.25)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.05, generator=g)
    x = torch.randn(8, 100, 256, device=cuda, generator=g).bfloat16()
    mask = torch.ones(8, 100, device=cuda)
    mask[::2, 60:] = 0
    bf16 = cast_in_forward(copy.deepcopy(layer), torch.bfloat16)
    with torch.no_grad(), fp32_exact():
        want = layer(x.float(), mask)
        got = bf16(x, mask)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max())

    r = route(bf16, x, mask)
    r = r._replace(gate=r.gate.detach())  # products() runs twice: no graph through the router
    xf = x.reshape(-1, 256).float()
    ref = torch.zeros_like(xf)
    with torch.no_grad(), fp32_exact():
        for e in range(4):
            rows = torch.nonzero((r.slot >= e * r.capacity)
                                 & (r.slot < (e + 1) * r.capacity)).flatten()
            h = F.gelu(xf[rows] @ bf16.wi[e].float() + bf16.bi[e]).bfloat16().float()
            ref[rows] = (h @ bf16.wo[e].float() + bf16.bo[e]) * r.gate[rows, None]

    def products():
        calls, product = [], moe._bmm32

        def recording(a, b):
            calls.append((a, b, product(a, b)))
            return calls[-1][2]

        xt = x.clone().requires_grad_()
        with fp32_exact(), mock.patch.object(moe, "_bmm32", recording):
            out = bf16.experts(xt.reshape(-1, 256), r.slot, r.capacity) * r.gate[:, None]
            out.backward(torch.ones_like(out))
        bf16.zero_grad(set_to_none=True)
        with torch.no_grad(), fp32_exact():
            each = [float((o - torch.bmm(a.float(), b.float())).abs().max())
                    / float(torch.bmm(a.float(), b.float()).abs().max()) for a, b, o in calls]
        assert len(each) == 6  # two products forward, four backward
        return max(each), float((out.detach() - ref).abs().max()) / float(ref.abs().max())

    each, whole_err = products()
    assert each <= 2.0 ** -14 and whole_err <= 2.0 ** -10
    real_bmm = moe._bmm32
    with mock.patch.object(moe, "_bmm32", lambda a, b: real_bmm(a, b).bfloat16().float()):
        each, whole_err = products()
    assert each > 2.0 ** -14 and whole_err > 2.0 ** -10

    def run(shares):
        xt = x.clone().requires_grad_()
        with routing() as aux:
            y = moe_shares(shares, xt, mask)
        (y.float().square().sum() + aux[0]).backward()
        grads = {}
        for s in shares:
            for n, p in s.named_parameters():
                if p.grad is not None:
                    grads.setdefault(n, []).append(p.grad)
        return [y, aux[0].detach(), xt.grad], {k: torch.cat(v) for k, v in grads.items()}

    whole, wgrads = run([bf16])
    for e in (2, 4):
        shares = [shard_experts_(copy.deepcopy(bf16), ExpertShard(k, e)) for k in range(e)]
        for s in shares:
            s.zero_grad(set_to_none=True)
        parts, grads = run(shares)
        assert all(torch.equal(a, b) for a, b in zip(parts, whole)), e
        assert set(grads) == set(wgrads)
        assert all(torch.equal(grads[k], wgrads[k]) for k in wgrads), e



def _pipelined_tower_errors(device, fault=None):
    """A BERT built with ``flash`` and ``fused_mlp`` (4 layers at hidden
    256, 4 heads, MLP 1024; 16 reports of up to 64 tokens, padded), fp32
    with TF32 off, its two pipeline stages run one after another
    (``pipelined_bert_shares``, 4 microbatches) with the planted ``fault``,
    against the whole tower on the plain routes, deterministic: (the
    output's largest difference over its largest entry, the stack's and
    the worst share's embeddings' gradient error in norm relative to the
    whole tower's, the kernel launches during the pipeline, during the
    tower's own forward)."""
    import copy

    from clip_for_dl_tpu_torch.models import init_weights
    from clip_for_dl_tpu_torch.models.bert import BertEncoder
    from clip_for_dl_tpu_torch.ops import _build
    from clip_for_dl_tpu_torch.parallel import pp
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact, pp_fault

    with torch.device(device):
        tower = BertEncoder(vocab_size=1000, hidden=256, layers=4, heads=4, intermediate=1024,
                            max_position=128, flash=True, fused_mlp=True)
    init_weights(tower, torch.Generator(device).manual_seed(0)).train()
    g = torch.Generator(device).manual_seed(1)
    ids = torch.randint(0, 1000, (16, 64), device=device, generator=g)
    lengths = torch.randint(3, 65, (16, 1), device=device, generator=g)
    mask = (torch.arange(64, device=device)[None] < lengths).int()
    cot = torch.randn(16, 64, 256, device=device, generator=g)
    plain = copy.deepcopy(tower).eval()
    for m in plain.modules():
        for flag in ("flash", "fused_mlp"):
            if isinstance(getattr(m, flag, None), bool):
                setattr(m, flag, False)
    shares = [pp.shard_stage_(copy.deepcopy(tower), s, 2) for s in range(2)]
    with fp32_exact():
        want = plain(ids, mask)
        (want * cot).sum().backward()
        before = dict(_build.LAUNCHES)
        with torch.no_grad():
            copy.deepcopy(tower).eval()(ids, mask)
        own = sum(_build.LAUNCHES.values()) - sum(before.values())
        before = dict(_build.LAUNCHES)
        with pp_fault(fault):
            got = pp.pipelined_bert_shares(shares, ids, mask, 4)
            (got * cot).sum().backward()
    piped = sum(_build.LAUNCHES.values()) - sum(before.values())

    def rel(a, b):
        return float((a - b).norm()) / float(b.norm())

    stack = rel(torch.cat([shares[i // 2].encoder.layer[i].get_parameter(n).grad.flatten()
                           for i, layer in enumerate(plain.encoder.layer)
                           for n, _ in layer.named_parameters()]),
                torch.cat([p.grad.flatten() for p in plain.encoder.layer.parameters()]))
    emb = max(rel(torch.cat([p.grad.flatten() for p in sh.embeddings.parameters()]),
                  torch.cat([p.grad.flatten() for p in plain.embeddings.parameters()]))
              for sh in shares)
    return float((got - want).abs().max()) / float(want.abs().max()), stack, emb, piped, own


def test_pipelined_tower_on_the_card(cuda):
    """The one-process pipeline on the card (``_pipelined_tower_errors``):
    the output within 1e-5 of its largest entry, the stack's and every
    share's embeddings' gradients within 1e-5 in norm, no kernel launched
    where the tower's own forward launches B3 (fp32); the planted summing
    broadcast (every layer's gradient twice) fails the stack's bound."""
    out, stack, emb, piped, own = _pipelined_tower_errors(cuda)
    assert out <= 1e-5 and stack <= 1e-5 and emb <= 1e-5, (out, stack, emb)
    assert piped == 0 and own > 0
    _, stack, _, _, _ = _pipelined_tower_errors(cuda, "summing_broadcast")
    assert stack > 1e-5
