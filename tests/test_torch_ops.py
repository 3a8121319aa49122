"""Parity of the port's kernel modules (clip_for_dl_tpu_torch/ops) with the
JAX package's ops, on the CPU.

On CPU tensors each port wrapper runs its kernel's plain PyTorch version;
the JAX side runs its Pallas kernel in interpret mode or through its own
reference. Inputs are drawn with numpy from a seed and handed to both.
Tolerances are stated per test. The kernels themselves run only on a GPU:
tests/test_torch_gpu.py holds each against its plain version there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# modules by path: clip_for_dl_tpu.ops re-exports functions under these names
jfa = importlib.import_module("clip_for_dl_tpu.ops.flash_attention")
jprep = importlib.import_module("clip_for_dl_tpu.ops.image_prep")
jmlp = importlib.import_module("clip_for_dl_tpu.ops.mlp_train")
jsim = importlib.import_module("clip_for_dl_tpu.ops.similarity")
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import image_prep as prep
from clip_for_dl_tpu_torch.ops import mlp_block
from clip_for_dl_tpu_torch.ops import mlp_train as mlp
from clip_for_dl_tpu_torch.ops import similarity as sim

torch.set_num_threads(1)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# B1: similarity
# ---------------------------------------------------------------------------


def test_similarity_matches_jax_reference_and_interpreted_kernel():
    """Tolerance 1e-6 absolute on logits of magnitude ≤ 1/T = 2."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((13, 128)).astype(np.float32)
    txt = rng.standard_normal((16, 128)).astype(np.float32)
    img[3] = 0.0  # a padded bucket row: exercises the eps² clamp
    got = sim.similarity(_t(img), _t(txt), 0.5).numpy()
    ref = np.asarray(jsim.similarity_reference(jnp.asarray(img), jnp.asarray(txt), 0.5))
    ker = np.asarray(jsim.fused_similarity(
        jnp.asarray(img), jnp.asarray(txt), 0.5, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ker, atol=1e-6, rtol=0)
    assert np.all(got[3] == 0.0)


@pytest.mark.parametrize("C,D", [(200, 64), (16, 96), (3, 1000)])
def test_similarity_at_any_width_matches_interpreted_kernel(C, D):
    """Widths and prompt counts the kernel once refused (D outside {128,
    256, 512, 768, 1024}, a text block over 200 KB), which the JAX kernel
    pads to its tiles: 1e-6 absolute on logits of magnitude ≤ 1/T = 2."""
    rng = np.random.default_rng(C + D)
    img = rng.standard_normal((9, D)).astype(np.float32)
    txt = rng.standard_normal((C, D)).astype(np.float32)
    img[2] = 0.0
    got = sim.similarity(_t(img), _t(txt), 0.5).numpy()
    ker = np.asarray(jsim.fused_similarity(
        jnp.asarray(img), jnp.asarray(txt), 0.5, interpret=True))
    assert got.shape == (9, C)
    np.testing.assert_allclose(got, ker, atol=1e-6, rtol=0)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        sim.l2_normalize(_t(x)).numpy(),
        np.asarray(jsim.l2_normalize(jnp.asarray(x))), atol=1e-7, rtol=0,
    )


# ---------------------------------------------------------------------------
# B2: image prep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_size,out_size", [(48, 32), (20, 32), (32, 32), (512, 224), (7, 3)])
def test_resize_weights_equal_and_taps_rebuild_them(in_size, out_size):
    w = prep._resize_weights(in_size, out_size)
    np.testing.assert_array_equal(w, jprep._resize_weights(in_size, out_size))
    lo, hi, w0, w1 = prep._resize_taps(in_size, out_size)
    dense = np.zeros_like(w)
    rows = np.arange(out_size)
    np.add.at(dense, (rows, lo), w0)
    np.add.at(dense, (rows, hi), w1)
    np.testing.assert_array_equal(dense, w)


@pytest.mark.parametrize("channels", [1, 3], ids=["grey_to_rgb", "rgb"])
@pytest.mark.parametrize("in_hw", [(48, 40), (20, 24), (32, 32)], ids=["down", "up", "identity"])
def test_preprocess_matches_jax(channels, in_hw):
    """Plain version vs preprocess_images(fused="never") and the Pallas
    kernel in interpret mode, fp32 output: 1e-5 absolute."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (3, *in_hw, channels), dtype=np.uint8)
    got = prep.preprocess_images(_t(imgs), 32, 32, CLIP_MEAN, CLIP_STD, torch.float32)
    assert got.shape == (3, 32, 32, 3) and got.dtype == torch.float32
    ref = jprep.preprocess_images(jnp.asarray(imgs), 32, 32, CLIP_MEAN, CLIP_STD,
                                  jnp.float32, fused="never")
    ker = jprep.fused_resize_normalize(jnp.asarray(imgs), 32, 32, CLIP_MEAN, CLIP_STD,
                                       jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ker), atol=1e-5, rtol=0)


def test_preprocess_bf16_output_matches_jax():
    """bf16 output: equal to within one bf16 rounding step of values ≤ 2.2
    (2^-7 · 2 ≈ 1.6e-2)."""
    imgs = np.random.default_rng(3).integers(0, 256, (2, 48, 48, 1), dtype=np.uint8)
    got = prep.preprocess_images(_t(imgs), 32, 32, CLIP_MEAN, CLIP_STD)
    ref = jprep.preprocess_images(jnp.asarray(imgs), 32, 32, CLIP_MEAN, CLIP_STD,
                                  fused="never")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=1.6e-2, rtol=0)


# ---------------------------------------------------------------------------
# B3: packed attention
# ---------------------------------------------------------------------------


def _qkv_case(seed, B=2, N=13, H=2, D=16):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)
    bias = np.zeros((B, N), np.float32)
    bias[0, 9:] = -1e10  # padded keys, N not a multiple of 8
    bias[1, 5:] = -1e10
    return qkv, bias, H


def test_flash_attention_packed_matches_interpreted_kernel():
    """fp32, padded keys, N = 13: 1e-5 absolute."""
    qkv, bias, H = _qkv_case(4)
    got = fa.flash_attention_packed(_t(qkv), H, _t(bias)).numpy()
    want = np.asarray(jfa.flash_attention_packed(
        jnp.asarray(qkv), H, jnp.asarray(bias), interpret=True))
    assert got.shape == (2, 13, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [32, 96])
def test_flash_attention_packed_at_head_dims_32_and_96(D, rate):
    """A built head dim (32) and a padded one (96): the packed forward and
    its gradient against the interpreted JAX kernel and its custom VJP,
    fp32, padded keys, N = 13: 1e-5 absolute."""
    rng = np.random.default_rng(D)
    B, N, H = 2, 13, 2
    qkv = rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)
    ct = rng.standard_normal((B, N, H * D)).astype(np.float32)
    bias = _qkv_case(4)[1]
    seeds = np.array([[3], [-8]], np.int32)
    kw = dict(dropout_rate=rate, dropout_seeds=_t(seeds)) if rate else {}
    jkw = dict(dropout_rate=rate, dropout_seeds=jnp.asarray(seeds)) if rate else {}
    x = _t(qkv).requires_grad_()
    out = fa.flash_attention_packed(x, H, _t(bias), **kw)
    (out * _t(ct)).sum().backward()

    def f(q_):
        o = jfa.flash_attention_packed(q_, H, jnp.asarray(bias), interpret=True, **jkw)
        return jnp.sum(o * ct), o

    (_, want), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(qkv))
    assert out.shape == (B, N, H * D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,width", [(20, 32), (96, 128), (33, 64), (160, 192)])
def test_padded_head_dim_route_is_the_plain_version_bit_for_bit(D, width, rate):
    """The kernel wrappers' route for a head dim that is not built: zero-pad
    each head to the built width, run at the scale of the original D, slice.
    With the plain versions in place of the kernels it gives the unpadded
    plain versions' forward and backward bit for bit in fp32 (zero columns
    add exact zeros to q·kᵀ and give zero output columns)."""
    rng = np.random.default_rng(D)
    B, N, H = 2, 13, 3
    assert fa._kernel_dim(D) == width
    qkv = _t(rng.standard_normal((B, N, 3 * H * D)).astype(np.float32))
    do = _t(rng.standard_normal((B, N, H * D)).astype(np.float32))
    bias = _t(_qkv_case(4)[1])
    kw = dict(dropout_rate=rate, dropout_seeds=_t(np.array([[3], [-8]], np.int32))) if rate else {}
    scale = 1.0 / D ** 0.5
    padded = fa._pad_heads(qkv, D, width)
    assert padded.shape == (B, N, 3 * H * width)
    fwd = fa._unpad_heads(fa.flash_attention_packed_reference(padded, H, bias, scale=scale, **kw),
                          D, width)
    bwd = fa._unpad_heads(fa.flash_attention_packed_bwd_reference(
        padded, fa._pad_heads(do, D, width), H, bias, scale=scale, **kw), D, width)
    assert torch.equal(fwd, fa.flash_attention_packed_reference(qkv, H, bias, **kw))
    assert torch.equal(bwd, fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw))
    # a split "bnhd" operand: its last dim is one head
    q, k, v = qkv.view(B, N, 3, H, D).unbind(2)
    pq, pk, pv = (fa._pad_heads(t, D, width) for t in (q, k, v))
    assert pq.shape == (B, N, H, width) and pq.is_contiguous()
    split = fa._unpad_heads(fa.flash_attention_reference(
        *(t.transpose(1, 2) for t in (pq, pk, pv)), bias, scale=scale, **kw).transpose(1, 2),
        D, width)
    assert torch.equal(split, fa.flash_attention_reference(
        *(t.transpose(1, 2) for t in (q, k, v)), bias, **kw).transpose(1, 2))


def test_kernels_refuse_head_dims_over_128_before_the_card():
    """ROADMAP C4, closed: no head dim is refused. Over 128 the kernels run
    every multiple of 64 in 64-column slices, and the wrappers pad any other
    D to the next one; D = 160 reaches the device check of all four kernel
    wrappers (the kernels run in tests/test_torch_gpu.py)."""
    assert [fa._kernel_dim(d) for d in (1, 32, 33, 64, 65, 128)] == [32, 32, 64, 64, 128, 128]
    assert [fa._kernel_dim(d) for d in (129, 160, 192, 256, 300, 320, 1000)] == [
        192, 192, 192, 256, 320, 320, 1024]
    bf = torch.bfloat16
    for call in (lambda: fa._kernel(torch.zeros(2, 8, 6 * 160, dtype=bf), 2, None),
                 lambda: fa._kernel_bwd(torch.zeros(2, 8, 6 * 160, dtype=bf),
                                        torch.zeros(2, 8, 2 * 160, dtype=bf), 2, None),
                 lambda: fa._kernel_split(*(torch.zeros(2, 8, 2, 160, dtype=bf)
                                            for _ in range(3)), None, "bnhd"),
                 lambda: fa._kernel_split_bwd(*(torch.zeros(2, 2, 8, 160, dtype=bf)
                                                for _ in range(4)), None, "bhnd")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_flash_attention_fully_masked_row_is_finite():
    qkv, bias, H = _qkv_case(5)
    bias[1, :] = -1e10
    got = fa.flash_attention_packed(_t(qkv), H, _t(bias))
    assert torch.isfinite(got).all()


def test_flash_attention_rejects_long_sequences():
    with pytest.raises(ValueError, match="sequence length"):
        fa.flash_attention_packed(torch.zeros(1, fa.MAX_SEQ_LEN + 1, 6), 1)


# ---------------------------------------------------------------------------
# B4: fused MLP
# ---------------------------------------------------------------------------


def test_dense_gelu_dense_matches_interpreted_kernel():
    """fp32, weights in nn.Linear layout on the port side: 1e-5 absolute."""
    rng = np.random.default_rng(6)
    R, H, F = 20, 128, 256
    x = rng.standard_normal((R, H)).astype(np.float32)
    w1 = (rng.standard_normal((H, F)) / np.sqrt(H)).astype(np.float32)
    b1 = rng.standard_normal(F).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(np.float32)
    b2 = rng.standard_normal(H).astype(np.float32) * 0.1
    got = mlp.dense_gelu_dense(_t(x), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2))
    want = jmlp.dense_gelu_dense(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# No fallback: anything but a CPU tensor goes to the kernel or raises
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: sim.similarity(_meta(4, 512), _meta(16, 512)),
    lambda: prep.preprocess_images(_meta(2, 48, 48, 1, dtype=torch.uint8), 32, 32,
                                   CLIP_MEAN, CLIP_STD),
    lambda: fa.flash_attention_packed(_meta(2, 8, 6 * 64, dtype=torch.bfloat16), 2),
    lambda: mlp.dense_gelu_dense(_meta(4, 768, dtype=torch.bfloat16),
                                 _meta(3072, 768, dtype=torch.bfloat16),
                                 _meta(3072, dtype=torch.bfloat16),
                                 _meta(768, 3072, dtype=torch.bfloat16),
                                 _meta(768, dtype=torch.bfloat16)),
    lambda: mlp_block.fused_mlp_block(_meta(4, 768, dtype=torch.bfloat16), _meta(768),
                                      _meta(768), _meta(3072, 768, dtype=torch.bfloat16),
                                      _meta(3072), _meta(768, 3072, dtype=torch.bfloat16),
                                      _meta(768)),
    lambda: fa.flash_attention(*(_meta(2, 8, 2, 64, dtype=torch.bfloat16) for _ in range(3)),
                               layout="bnhd"),
], ids=["similarity", "image_prep", "flash_attention", "mlp", "mlp_block",
        "flash_attention_split"])
def test_non_cpu_tensor_takes_the_kernel_path_or_raises(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


@pytest.mark.parametrize("call", [
    lambda: sim._kernel(torch.zeros(4, 512), torch.zeros(16, 512), 0.5),
    lambda: prep._kernel(torch.zeros(2, 48, 48, 1, dtype=torch.uint8), 32, 32,
                         CLIP_MEAN, CLIP_STD, torch.bfloat16),
    lambda: fa._kernel(torch.zeros(2, 8, 6 * 64, dtype=torch.bfloat16), 2, None),
    lambda: mlp._kernel(*(torch.zeros(s, dtype=torch.bfloat16)
                          for s in ((4, 768), (3072, 768), (3072,), (768, 3072), (768,)))),
    lambda: fa._kernel_bwd(torch.zeros(2, 8, 6 * 64, dtype=torch.bfloat16),
                           torch.zeros(2, 8, 2 * 64, dtype=torch.bfloat16), 2, None),
    lambda: mlp._kernel_bwd(*(torch.zeros(s, dtype=torch.bfloat16)
                              for s in ((4, 768), (3072, 768), (3072,), (768, 3072), (4, 768)))),
    lambda: mlp_block._kernel(torch.zeros(4, 768, dtype=torch.bfloat16), torch.ones(768),
                              torch.zeros(768), torch.zeros(3072, 768, dtype=torch.bfloat16),
                              torch.zeros(3072), torch.zeros(768, 3072, dtype=torch.bfloat16),
                              torch.zeros(768), eps=1e-6, gelu_approximate=False),
    lambda: fa._kernel_split(*(torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16) for _ in range(3)),
                             None, "bnhd"),
    lambda: fa._kernel_split_bwd(*(torch.zeros(2, 2, 8, 64, dtype=torch.bfloat16)
                                   for _ in range(4)), None, "bhnd"),
], ids=["similarity", "image_prep", "flash_attention", "mlp", "flash_attention_bwd", "mlp_bwd",
        "mlp_block", "flash_attention_split", "flash_attention_split_bwd"])
def test_kernel_path_on_cpu_raises(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def _mlp_at(H, F=256):
    x, w1, b1, w2 = (torch.zeros(s, dtype=torch.bfloat16) for s in ((4, H), (F, H), (F,), (H, F)))
    return x, w1, b1, w2, torch.zeros(4, H, dtype=torch.bfloat16), torch.zeros(H)


MLP_KERNELS = [
    lambda x, w1, b1, w2, dy, f: mlp._kernel(x, w1, b1, w2, dy[0]),
    lambda x, w1, b1, w2, dy, f: mlp._kernel_bwd(x, w1, b1, w2, dy),
    lambda x, w1, b1, w2, dy, f: mlp_block._kernel(x, f + 1, f, w1, b1.float(), w2, f,
                                                   eps=1e-6, gelu_approximate=False),
]
MLP_KERNEL_IDS = ["mlp", "mlp_bwd", "mlp_block"]


@pytest.mark.parametrize("call", MLP_KERNELS, ids=MLP_KERNEL_IDS)
@pytest.mark.parametrize("H", [1152, 192])
def test_mlp_kernels_name_their_width_bound(call, H):
    """B4, B8 and B9 are bounded by one rule, positive multiples of 64 (their
    TMA box and k-step; ``check_widths``), and by no largest width: no
    [rows, H] accumulator lives in registers. 1152 (past the old
    MAX_HIDDEN = 1024 of the WMMA forwards) and 192 (not a multiple of 128)
    pass the width check and reach the device check."""
    assert not hasattr(mlp, "MAX_HIDDEN")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(*_mlp_at(H))


@pytest.mark.parametrize("call", MLP_KERNELS, ids=MLP_KERNEL_IDS)
@pytest.mark.parametrize("H,F", [(64, 64), (320, 64), (1280, 3072), (96, 64), (128, 96)])
def test_mlp_bwd_takes_every_multiple_of_64(call, H, F):
    """B4, B8 and B9 take any H and F that are multiples of 64 (their TMA
    box and k-step) and refuse others, naming the rule, before any launch."""
    ok = H % 64 == 0 and F % 64 == 0
    with pytest.raises(ValueError, match="CUDA tensor" if ok else "multiple of 64"):
        call(*_mlp_at(H, F))


@pytest.mark.parametrize("H", range(64, 1281, 64))
def test_mlp_kernels_take_every_width_to_the_bound(H):
    """Each multiple of 64 from 64 to 1280 passes B4's, B8's and B9's width
    check and reaches the device check (the kernels run in
    tests/test_torch_gpu.py)."""
    for call in MLP_KERNELS:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(*_mlp_at(H))


@pytest.mark.parametrize("call", [
    lambda: fa.flash_attention_packed(_meta(2, 8, 6 * 64, dtype=torch.bfloat16).requires_grad_(), 2),
    lambda: fa.flash_attention_packed(_meta(2, 8, 6 * 64, dtype=torch.bfloat16).requires_grad_(), 2,
                                      dropout_rate=0.1,
                                      dropout_seeds=_meta(2, 1, dtype=torch.int32)),
    lambda: mlp.dense_gelu_dense(_meta(4, 768, dtype=torch.bfloat16),
                                 _meta(3072, 768, dtype=torch.bfloat16).requires_grad_(),
                                 _meta(3072, dtype=torch.bfloat16),
                                 _meta(768, 3072, dtype=torch.bfloat16),
                                 _meta(768, dtype=torch.bfloat16)),
    lambda: fa.flash_attention(*(_meta(2, 2, 8, 64, dtype=torch.bfloat16).requires_grad_()
                                 for _ in range(3))),
    lambda: fa.flash_attention(*(_meta(2, 8, 2, 64, dtype=torch.bfloat16).requires_grad_()
                                 for _ in range(3)), layout="bnhd", dropout_rate=0.1,
                               dropout_seeds=_meta(2, 1, dtype=torch.int32)),
], ids=["flash_attention", "flash_attention_dropout", "mlp", "flash_attention_split",
        "flash_attention_split_dropout"])
def test_autograd_path_reaches_the_kernel_checks(call):
    """With a gradient required, a non-CPU tensor goes through the autograd
    function into the kernel wrapper, which refuses anything but CUDA."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


# ---------------------------------------------------------------------------
# B3 dropout and B6: the attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,head,shape", [(0, 0, (13, 13)), (-5, 1, (8, 200)),
                                             (2 ** 31 - 1, 11, (200, 7)),
                                             (-(2 ** 31), 3, (16, 512)),
                                             (123456789, 65535, (5, 9))])
def test_uniform01_is_bit_equal_to_jax(seed, head, shape):
    want = np.asarray(jfa._uniform01(jnp.int32(seed), head, shape))
    got = fa.uniform01(seed, head, *shape).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_uniform01_broadcasts_seeds_and_heads():
    seeds = np.array([[3], [-7]], np.int32)
    got = fa.uniform01(torch.from_numpy(seeds), torch.arange(3)[None, :], 4, 6)
    assert got.shape == (2, 3, 4, 6)
    for b in range(2):
        for h in range(3):
            want = np.asarray(jfa._uniform01(jnp.int32(seeds[b, 0]), h, (4, 6)))
            assert np.array_equal(got[b, h].numpy(), want)


def test_dropout_seeds_are_seeded_int32():
    a = fa.dropout_seeds(torch.Generator().manual_seed(1), 5)
    b = fa.dropout_seeds(torch.Generator().manual_seed(1), 5)
    assert a.shape == (5, 1) and a.dtype == torch.int32 and torch.equal(a, b)


_SEEDS = np.array([[7], [-99]], np.int32)


def test_flash_attention_dropout_matches_interpreted_kernel():
    """fp32, rate 0.1, padded keys, N = 13: 1e-5 absolute (the masks are the
    same bits, so only summation order differs)."""
    qkv, bias, H = _qkv_case(4)
    got = fa.flash_attention_packed(_t(qkv), H, _t(bias), dropout_rate=0.1,
                                    dropout_seeds=_t(_SEEDS)).numpy()
    want = np.asarray(jfa.flash_attention_packed(
        jnp.asarray(qkv), H, jnp.asarray(bias), dropout_rate=0.1,
        dropout_seeds=jnp.asarray(_SEEDS), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    no_drop = fa.flash_attention_packed(_t(qkv), H, _t(bias)).numpy()
    assert np.abs(got - no_drop).max() > 1e-2  # dropout did something


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_backward_matches_jax_grad(rate):
    """fp32 dqkv through the autograd function vs jax.grad through the
    interpreted kernels (custom VJP), cotangent from a seed: 1e-5 absolute
    on gradients of magnitude ≲ 4."""
    qkv, bias, H = _qkv_case(7)
    ct = np.random.default_rng(8).standard_normal((2, 13, 32)).astype(np.float32)
    seeds = _SEEDS if rate else None

    def f(x):
        out = jfa.flash_attention_packed(
            x, H, jnp.asarray(bias), dropout_rate=rate,
            dropout_seeds=None if seeds is None else jnp.asarray(seeds), interpret=True)
        return jnp.sum(out * ct)

    want = np.asarray(jax.grad(f)(jnp.asarray(qkv)))
    x = _t(qkv).requires_grad_()
    out = fa.flash_attention_packed(x, H, _t(bias), dropout_rate=rate,
                                    dropout_seeds=None if seeds is None else _t(seeds))
    (out * _t(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5, rtol=0)
    direct = fa.flash_attention_packed_bwd_reference(
        _t(qkv), _t(ct), H, _t(bias), dropout_rate=rate,
        dropout_seeds=None if seeds is None else _t(seeds))
    assert torch.equal(direct, x.grad)


def test_flash_attention_backward_fully_masked_row_is_finite():
    qkv, bias, H = _qkv_case(9)
    bias[1, :] = -1e10
    x = _t(qkv).requires_grad_()
    fa.flash_attention_packed(x, H, _t(bias), dropout_rate=0.1,
                              dropout_seeds=_t(_SEEDS)).sum().backward()
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# B8: the MLP backward
# ---------------------------------------------------------------------------


def test_dense_gelu_dense_backward_matches_jax_grad():
    """fp32 gradients of x, both weights and both biases through the
    autograd function vs jax.grad through the interpreted kernels: 1e-5
    relative to each gradient's largest entry (the JAX kernel's A&S erf is
    within 5.3e-7 of the exact erf used here)."""
    rng = np.random.default_rng(10)
    R, H, F = 20, 128, 256
    x = rng.standard_normal((R, H)).astype(np.float32)
    w1 = (rng.standard_normal((H, F)) / np.sqrt(H)).astype(np.float32)
    b1 = rng.standard_normal(F).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(np.float32)
    b2 = rng.standard_normal(H).astype(np.float32) * 0.1
    ct = rng.standard_normal((R, H)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jmlp.dense_gelu_dense(*a, interpret=True) * ct),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    args = [_t(a.copy()).requires_grad_() for a in (x, w1.T, b1, w2.T, b2)]
    (mlp.dense_gelu_dense(*args) * _t(ct)).sum().backward()
    got = [args[0].grad, args[1].grad.T, args[2].grad, args[3].grad.T, args[4].grad]
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_dense_gelu_dense_bwd_reference_matches_jax_kernel_outputs():
    """(dx, g, dh) of the plain backward vs the interpreted JAX backward
    kernel itself, fp32: 1e-5."""
    rng = np.random.default_rng(11)
    R, H, F = 12, 128, 192
    x = rng.standard_normal((R, H)).astype(np.float32)
    w1 = (rng.standard_normal((H, F)) / np.sqrt(H)).astype(np.float32)
    b1 = rng.standard_normal(F).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(np.float32)
    dy = rng.standard_normal((R, H)).astype(np.float32)
    want = jmlp._pallas_bwd(*(jnp.asarray(a) for a in (x, w1, b1, w2, dy)),
                            approximate=False, interpret=True)
    got = mlp.dense_gelu_dense_bwd_reference(_t(x), _t(w1.T.copy()), _t(b1),
                                             _t(w2.T.copy()), _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
