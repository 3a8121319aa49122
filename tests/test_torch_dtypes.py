"""The port's kernels in every operand type the JAX kernels take (ROADMAP C7
and C8), on the CPU: the plain versions against the JAX package's kernels
in interpret mode, the wrappers' routing to each type's C entry point, the
image-prep planner's direct body and element sizes, and the launch path.

On CPU tensors each public function runs its plain version; the routing
tests call the kernel wrappers with ``_build.launch`` replaced by a
recorder and ``_build.CARD`` set to "cpu", so that they reach the C call
without a card. The kernels themselves run in tests/test_torch_gpu.py.
Tolerances are stated per test.
"""

import importlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("clip_for_dl_tpu.ops.flash_attention")
jprep = importlib.import_module("clip_for_dl_tpu.ops.image_prep")
jsim = importlib.import_module("clip_for_dl_tpu.ops.similarity")
from clip_for_dl_tpu_torch.ops import _build
from clip_for_dl_tpu_torch.ops import flash_attention as fa
from clip_for_dl_tpu_torch.ops import image_prep as prep
from clip_for_dl_tpu_torch.ops import similarity as sim

torch.set_num_threads(1)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
H100_SMS = 132
TORCH_OF = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
JAX_OF = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", ["fp32", "bf16"])
@pytest.mark.parametrize("channels", [1, 3], ids=["grey_to_rgb", "rgb"])
def test_preprocess_float_images_matches_jax(src, channels):
    """Float images at input_scale 1 (values in [0, 1]): the plain version
    vs the JAX kernel in interpret mode, fp32 output within 1e-5 (the same
    two-pass sums in another order) and fp16 output within one fp16 step at
    |x| ≤ 2.2 (2^-9)."""
    rng = np.random.default_rng(channels)
    imgs = rng.random((2, 40, 36, channels), dtype=np.float32)
    x = _t(imgs).to(TORCH_OF[src])
    jx = jnp.asarray(imgs).astype(JAX_OF[src])
    for out_t, tol in (("fp32", 1e-5), ("fp16", 2.0 ** -9)):
        got = prep.preprocess_images(x, 32, 28, CLIP_MEAN, CLIP_STD, TORCH_OF[out_t])
        want = jprep.fused_resize_normalize(jx, 32, 28, CLIP_MEAN, CLIP_STD, JAX_OF[out_t],
                                            interpret=True)
        assert got.dtype == TORCH_OF[out_t] and got.shape == (2, 32, 28, 3)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=0)


def test_preprocess_fp16_output_of_uint8_matches_jax():
    """uint8 images, fp16 output: within one fp16 step at |x| ≤ 2.2 (2^-9)
    of the JAX kernel in interpret mode."""
    imgs = np.random.default_rng(5).integers(0, 256, (2, 48, 40, 3), dtype=np.uint8)
    got = prep.preprocess_images(_t(imgs), 32, 32, CLIP_MEAN, CLIP_STD, torch.float16)
    want = jprep.fused_resize_normalize(jnp.asarray(imgs), 32, 32, CLIP_MEAN, CLIP_STD,
                                        jnp.float16, interpret=True)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2.0 ** -9, rtol=0)


@pytest.mark.parametrize("img_t,txt_t", [("bf16", "bf16"), ("fp16", "fp16"), ("fp32", "bf16")])
def test_similarity_16_bit_features_match_interpreted_kernel(img_t, txt_t):
    """bf16 and fp16 features, each side on its own: the plain version vs the
    JAX kernel (which casts inside itself) in interpret mode, 1e-5 absolute
    on logits ≤ 1/T = 2."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((13, 96)).astype(np.float32)
    txt = rng.standard_normal((16, 96)).astype(np.float32)
    img[3] = 0.0
    got = sim.similarity(_t(img).to(TORCH_OF[img_t]), _t(txt).to(TORCH_OF[txt_t]), 0.5)
    want = jsim.fused_similarity(jnp.asarray(img).astype(JAX_OF[img_t]),
                                 jnp.asarray(txt).astype(JAX_OF[txt_t]), 0.5, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert np.all(got[3].numpy() == 0.0)


def _fp16_case(seed, B=2, N=13, H=2, D=32):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * D)).astype(np.float16)
    ct = rng.standard_normal((B, N, H * D)).astype(np.float16)
    bias = np.zeros((B, N), np.float32)
    bias[0, 9:] = -1e10
    bias[1, 5:] = -1e10
    return qkv, ct, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp16_attention_matches_interpreted_kernels(rate):
    """fp16 q/k/v: the packed forward within two fp16 steps of its largest
    entry, and its gradient per (batch row, head) slice within two fp16
    steps of that slice's largest entry (fa.grad_slice_error at fp16), of
    the JAX kernels in interpret mode (custom VJP); both round p and ds to
    fp16 before their products."""
    qkv, ct, bias = _fp16_case(11)
    H = 2
    seeds = np.array([[5], [-2]], np.int32)
    kw = dict(dropout_rate=rate, dropout_seeds=_t(seeds)) if rate else {}
    jkw = dict(dropout_rate=rate, dropout_seeds=jnp.asarray(seeds)) if rate else {}
    x = _t(qkv).requires_grad_()
    out = fa.flash_attention_packed(x, H, _t(bias), **kw)
    (out.float() * _t(ct).float()).sum().backward()

    def f(q_):
        o = jfa.flash_attention_packed(q_, H, jnp.asarray(bias), interpret=True, **jkw)
        return jnp.sum(o.astype(jnp.float32) * ct.astype(np.float32)), o

    (_, want), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(qkv))
    want = _t(np.asarray(want))
    assert out.dtype == torch.float16 and want.dtype == torch.float16
    np.testing.assert_allclose(out.detach().float().numpy(), want.float().numpy(),
                               atol=fa.fwd_tolerance(want), rtol=0)
    g = _t(np.asarray(grad))
    assert x.grad.dtype == torch.float16
    assert fa.grad_slice_error(x.grad, g, "packed", H, torch.float16)[1] <= 1.0


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_fp16_split_attention_matches_interpreted_kernel(layout):
    """The split form in fp16 vs the JAX split kernel in interpret mode, the
    same rules; and bit for bit the packed form's output on the same heads."""
    qkv, _, bias = _fp16_case(12)
    B, N, H, D = 2, 13, 2, 32
    q, k, v = _t(qkv).view(B, N, 3, H, D).unbind(2)
    if layout == "bhnd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = fa.flash_attention(q, k, v, _t(bias), layout=layout)
    want = jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(bias),
                               layout=layout, interpret=True)
    want = _t(np.asarray(want))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=fa.fwd_tolerance(want), rtol=0)
    packed = fa.flash_attention_packed(_t(qkv), H, _t(bias)).view(B, N, H, D)
    assert torch.equal(got if layout == "bnhd" else got.transpose(1, 2), packed)


# ---------------------------------------------------------------------------
# the wrappers' routing, with launch recorded on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Every _build.launch call as (entry, args, key), on CPU tensors."""
    calls = []
    monkeypatch.setattr(_build, "CARD", "cpu")
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *args, key=None: calls.append((name, args, key)))
    return calls


def _words(t):
    """A split operand's (batch, token, head) strides in 32-bit words."""
    return [s * t.element_size() // 4 for s in t.stride()[:3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["fp32", "fp16", "bf16"])
def test_packed_attention_routes_by_type(launches, dtype):
    """qkv of each type reaches its type's B3 and B6 entries; fp32 keeps D
    = 40 as it is, the 16-bit types run it padded to 64; the output keeps
    the type."""
    B, N, H, D = 2, 9, 2, 40
    qkv = torch.zeros(B, N, 3 * H * D, dtype=dtype)
    out = fa._kernel(qkv, H, None)
    dqkv = fa._kernel_bwd(qkv, torch.zeros(B, N, H * D, dtype=dtype), H, None,
                          dropout_rate=0.1, dropout_seeds=torch.ones(B, 1, dtype=torch.int32))
    suffix = {torch.float32: "_f32", torch.float16: "_f16", torch.bfloat16: ""}[dtype]
    width = D if dtype == torch.float32 else 64
    assert [c[0] for c in launches] == [fa.KERNEL + suffix, fa.KERNEL_BWD + suffix]
    assert launches[0][1][4:8] == (B, N, H, width)
    assert launches[1][1][6:10] == (B, N, H, width)
    assert out.dtype == dqkv.dtype == dtype
    assert out.shape == (B, N, H * D) and dqkv.shape == qkv.shape


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_split_attention_routes_by_type(launches, dtype, layout):
    """q/k/v of each type reach their type's B5 and B7 entries with their
    strides in 32-bit words (fp32: the element strides), in both layouts;
    fp32 views off the 16-byte grid are taken without a copy."""
    B, N, H, D = 2, 9, 2, 64
    shape = (B, N, H, D) if layout == "bnhd" else (B, H, N, D)
    buf = torch.zeros(3 * B * N * H * D + 2, dtype=dtype)
    q, k, v = buf[2:].view(3, *shape).unbind(0)
    fa._kernel_split(q, k, v, None, layout)
    fa._kernel_split_bwd(q, k, v, torch.zeros(shape, dtype=dtype), None, layout)
    suffix = "_f32" if dtype == torch.float32 else "_f16"
    assert [c[0] for c in launches] == [fa.KERNEL_SPLIT + suffix, fa.KERNEL_SPLIT_BWD + suffix]
    fwd = launches[0][1]
    strides = list(fwd[6])
    sb, s1, s2 = _words(q)
    want = [sb, s1, s2] if layout == "bnhd" else [sb, s2, s1]
    if dtype == torch.float32:  # no copy: q's own address and strides
        assert fwd[0] == q.data_ptr() and strides[:3] == want
    else:  # off the 16-byte grid: a contiguous copy
        assert fwd[0] != q.data_ptr() and fwd[0] % 16 == 0
    assert fwd[7:11] == (B, N, H, D)


def test_attention_refuses_other_types(launches):
    with pytest.raises(TypeError, match="attention kernels take"):
        fa._kernel(torch.zeros(2, 9, 6 * 64, dtype=torch.float64), 2, None)
    with pytest.raises(TypeError):
        fa._kernel_split(*(torch.zeros(2, 9, 2, 64, dtype=torch.float64) for _ in range(3)),
                         None, "bnhd")
    with pytest.raises(TypeError):  # d(out) in another type than qkv
        fa._kernel_bwd(torch.zeros(2, 9, 6 * 64, dtype=torch.float16),
                       torch.zeros(2, 9, 2 * 64), 2, None)
    assert not launches


@pytest.mark.parametrize("img_t,txt_t,codes,key", [
    (torch.float32, torch.float32, (0, 0), "cxr_similarity"),
    (torch.bfloat16, torch.bfloat16, (1, 1), "cxr_similarity_bf16_bf16"),
    (torch.float16, torch.float32, (2, 0), "cxr_similarity_fp16_fp32"),
])
def test_similarity_routes_by_type(launches, img_t, txt_t, codes, key):
    sim._kernel(torch.zeros(5, 64, dtype=img_t), torch.zeros(3, 64, dtype=txt_t), 0.5)
    (name, args, got_key), = launches
    assert name == sim.KERNEL and args[8:10] == codes and got_key == key
    assert args[3:6] == (5, 3, 64)


def test_similarity_copies_views(launches):
    img = torch.zeros(64, 10).T  # [10, 64], not contiguous
    txt = torch.zeros(3, 128)[:, ::2]
    sim._kernel(img, txt, 0.5)
    (_, args, _), = launches
    assert args[0] != img.data_ptr() and args[1] != txt.data_ptr()
    with pytest.raises(TypeError):
        sim._kernel(torch.zeros(5, 64, dtype=torch.float64), torch.zeros(3, 64), 0.5)


@pytest.mark.parametrize("src,entry,code", [
    (torch.uint8, prep.KERNEL, None), (torch.float32, prep.KERNEL_F32SRC, None),
    (torch.bfloat16, prep.KERNEL_F32SRC, None), (torch.float16, prep.KERNEL_F32SRC, None),
])
@pytest.mark.parametrize("out_t", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "fp32", "fp16"])
def test_image_prep_routes_by_type(launches, src, entry, code, out_t):
    """uint8 images reach the uint8 entry, float images the fp32-source one
    (16-bit ones widened first) with the scale 1; the output type's code;
    fp16 output counted under the _fp16 key."""
    imgs = torch.zeros(2, 30, 20, 3, dtype=src)
    out = prep._kernel(imgs, 16, 12, CLIP_MEAN, CLIP_STD, out_t)
    (name, args, key), = launches
    assert name == entry and args[-1] == prep.OUT_TYPES[out_t]
    assert key == (entry + "_fp16" if out_t == torch.float16 else entry)
    assert out.dtype == out_t and out.shape == (2, 16, 12, 3)
    scale = prep._device_scale_bias(CLIP_MEAN, CLIP_STD,
                                    1 / 255 if src == torch.uint8 else 1.0, imgs.device)[0]
    assert args[9] == scale.data_ptr()
    if src in (torch.bfloat16, torch.float16):
        assert args[0] != imgs.data_ptr()


def test_image_prep_writes_fp64_through_fp32(launches):
    out = prep._kernel(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), 4, 4, CLIP_MEAN, CLIP_STD,
                       torch.float64)
    assert out.dtype == torch.float64 and launches[0][1][-1] == prep.OUT_TYPES[torch.float32]
    with pytest.raises(TypeError):
        prep._kernel(torch.zeros(1, 8, 8, 3, dtype=torch.int32), 4, 4, CLIP_MEAN, CLIP_STD,
                     torch.float32)


@pytest.mark.parametrize("src,channels", [(torch.uint8, 30000), (torch.float32, 8000)])
def test_image_prep_routes_wide_rows_to_the_direct_body(launches, src, channels):
    imgs = torch.zeros(1, 3, 2, channels, dtype=src)
    stats = (0.5,) * channels
    prep._kernel(imgs, 2, 2, stats, stats, torch.bfloat16)
    (name, args, _), = launches
    assert name == prep.KERNEL_DIRECT and args[-1] == int(src != torch.uint8)
    assert args[-2] == prep.OUT_TYPES[torch.bfloat16]


def test_image_prep_copies_views(launches):
    big = torch.zeros(2, 40, 40, 3, dtype=torch.uint8)
    crop = big[:, 5:35, 2:30]
    prep._kernel(crop, 16, 16, CLIP_MEAN, CLIP_STD, torch.bfloat16)
    assert launches[0][0] == prep.KERNEL and launches[0][1][0] != crop.data_ptr()


# ---------------------------------------------------------------------------
# the planner: element sizes and the direct body
# ---------------------------------------------------------------------------


def test_band_plan_sizes_staged_rows_by_element_size():
    """An fp32 source row takes four times the bytes of a uint8 one, so a
    chunk holds a quarter of the columns; the staged stride holds each
    window's bytes plus its misalignment."""
    u8 = prep.band_plan(1, 1024, 3, 18, 224, 1)
    f32 = prep.band_plan(1, 1024, 3, 18, 224, 1, elsize=4)
    assert (u8.rows, u8.cols) == (16, 48)
    assert f32.cols < u8.cols and not f32.direct
    assert f32.stride == prep.row_stride(f32.cols, 1024, 224, 3, 4)
    lo, hi, _, _ = prep._resize_taps(1024, 224)
    for x0 in range(0, 224, f32.cols):
        x1 = min(x0 + f32.cols, 224) - 1
        assert 15 + (int(hi[x1]) - int(lo[x0]) + 1) * 3 * 4 <= f32.stride


@pytest.mark.parametrize("channels", [8000, 14000])
def test_band_plan_takes_the_direct_body_past_shared_memory(channels):
    """8000 fp32 channels (a 64 KB row pair at one column) go direct where 8000
    uint8 ones are still staged; 14000 uint8 ones are staged, 30000 not."""
    assert not prep.band_plan(2, 4, channels, 3, 3, H100_SMS).direct
    plan = prep.band_plan(2, 4, channels, 3, 3, H100_SMS, elsize=4)
    assert plan.direct and (plan.grid, plan.items, plan.bands) == (6, 6, 3)
    assert prep.needs_direct(4, 3, channels, 4) and not prep.needs_direct(4, 3, channels, 1)
    assert prep.band_plan(2, 4, 30000, 3, 3, H100_SMS).direct


def test_direct_plan_refuses_past_the_grid():
    with pytest.raises(ValueError, match="2\\^31"):
        prep.band_plan(2 ** 20, 4, 40000, 2 ** 11, 3, H100_SMS)


# ---------------------------------------------------------------------------
# the launch path
# ---------------------------------------------------------------------------


class _FakeLib:
    """A kernel library whose entry points count their calls."""

    def __init__(self):
        self.calls = 0
        self._lock = threading.Lock()

    def cxr_fake(self, *args):
        with self._lock:
            self.calls += 1
        return 0

    def cxr_error_string(self, err):
        return b"fake"


@pytest.fixture
def fake_card(monkeypatch):
    """The launch path over a fake library on a pretend device 0."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "LAUNCHES", _build.Counter())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0)
    return lib


def test_launch_counts_exactly_from_two_threads(fake_card):
    """Launches from several threads at once (as the service's batcher
    thread launches beside the caller's), switching threads every
    microsecond: no count is lost, and the entry point is looked up once."""
    dev = torch.device("cuda", 0)
    n = 2000
    keys = [None, "other"] * 4

    def work(key):
        for _ in range(n):
            _build.launch("cxr_fake", dev, 1, 2, key=key)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in keys]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["cxr_fake"] == 4 * n and _build.LAUNCHES["other"] == 4 * n
    assert fake_card.calls == 8 * n
    assert set(_build._entries) == {"cxr_fake"}


def test_use_library_drops_cached_entry_points(fake_card):
    dev = torch.device("cuda", 0)
    _build.launch("cxr_fake", dev)
    other = _FakeLib()
    _build.use_library(other)
    assert not _build._entries
    _build.launch("cxr_fake", dev)
    assert (fake_card.calls, other.calls) == (1, 1)
    assert _build.LAUNCHES["cxr_fake"] == 2


def test_launch_raises_on_a_cuda_error(fake_card):
    fake_card.cxr_fake = lambda *args: 2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _build.launch("cxr_fake", torch.device("cuda", 0))
    assert not _build.LAUNCHES


def test_check_tensor_names_what_fails():
    t = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_tensor(t, "x", torch.float32)
    _build.CARD, card = "cpu", _build.CARD
    try:
        _build.check_tensor(t, "x", torch.float32, (4, 8))
        with pytest.raises(TypeError, match="expected torch.bfloat16"):
            _build.check_tensor(t, "x", torch.bfloat16)
        with pytest.raises(ValueError, match="shape"):
            _build.check_tensor(t, "x", torch.float32, (8, 4))
        with pytest.raises(ValueError, match="contiguous"):
            _build.check_tensor(t.T, "x", torch.float32)
        with pytest.raises(ValueError, match="aligned"):
            _build.check_tensor(torch.zeros(9)[1:], "x", torch.float32)
    finally:
        _build.CARD = card
