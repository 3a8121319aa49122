"""The ViT-B/16 zero-shot serving slice, port vs JAX package, on the CPU.

Tiny geometry: a ViT at image 32, patch 16 (4 patches and the class token),
2 layers, hidden 128, 2 heads of 64, MLP 256, with a 2-layer BERT. Both
widths are multiples of 128, so the fused MLP gate (vit.py:201-207 in the
JAX package) opens in bf16 on both sides. JAX variables are drawn from a
seed with numpy and carried into the port by ``state_dict_from_jax``; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do, and
the port runs each kernel's plain version (CPU tensors). Tolerances are
stated per test.
"""

import dataclasses
import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core import config as jconfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.vit import import_torchvision_vit_b16
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu_torch.core import config
from clip_for_dl_tpu_torch.core.device import cast_in_forward, cast_matmul_weights
from clip_for_dl_tpu_torch.models import CXRClip, init_weights, state_dict_from_jax
from clip_for_dl_tpu_torch.ops import mlp_block
from clip_for_dl_tpu_torch.serving import ZeroShotService
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

# the module by path: clip_for_dl_tpu.ops re-exports a function under its name
jmlp_block = importlib.import_module("clip_for_dl_tpu.ops.mlp_block")

torch.set_num_threads(1)

LABELS = config.DISEASE_LABELS
VOCAB = build_dev_vocab(LABELS)
TINY = dict(
    image_tower="vit_b16", image_embedding_dim=128, image_size=32, vit_patch=16,
    vit_layers=2, vit_heads=2, vit_hidden=128, vit_mlp_dim=256,
    max_text_length=16, vocab_size=len(VOCAB), text_embedding_dim=128, text_layers=2,
    text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64, text_max_position=32,
)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bf16_steps(ref, steps=2):
    """``steps`` bf16 rounding steps at the reference's largest magnitude
    (one step is at most 2^-7 of the value)."""
    return steps * 2.0 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())


# ---------------------------------------------------------------------------
# B9: the fused LayerNorm-MLP block, plain version and gradient
# ---------------------------------------------------------------------------


def _block_case(seed, rows, H=128, F=256):
    """x [*rows, H], LayerNorm scale/bias, JAX-layout weights (w1 [H, F],
    w2 [F, H]) and biases, fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*rows, H)) * 2.0).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, H).astype(np.float32)
    lb = (rng.standard_normal(H) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((H, F)) / np.sqrt(H)).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(np.float32)
    b2 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    return x, ls, lb, w1, b1, w2, b2


def _port_args(case, dtype):
    """The port's argument order and layout: weights transposed to
    nn.Linear's, x and the weights in ``dtype``, the rest fp32."""
    x, ls, lb, w1, b1, w2, b2 = case
    return (_t(x).to(dtype), _t(ls), _t(lb), _t(w1.T.copy()).to(dtype), _t(b1),
            _t(w2.T.copy()).to(dtype), _t(b2))


@pytest.mark.parametrize("dtype,approximate,rows", [
    ("float32", False, (2, 5)),
    ("bfloat16", False, (2, 5)),
    ("float32", True, (3, 7)),
    ("bfloat16", True, (3, 7)),
    ("float32", False, (197,)),
], ids=["fp32", "bf16", "fp32-tanh", "bf16-tanh", "fp32-197-rows"])
def test_fused_mlp_block_matches_jax(dtype, approximate, rows):
    """The plain version vs the JAX ``fused_mlp_block`` (its Pallas kernel
    in interpret mode), row counts that are not a multiple of the kernel's
    tile (128 rows in JAX, 32 in the port). fp32: 1e-5 (the JAX kernel's A&S
    erf is within 5.3e-7 of the exact erf). bf16: two bf16 steps at the
    output's largest entry (an fp32 summation-order difference can flip the
    rounding of the GELU output or of o, and then of the residual sum)."""
    case = _block_case(len(rows) + rows[0], rows)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, ls, lb, w1, b1, w2, b2 = case
    want = np.asarray(jmlp_block.fused_mlp_block(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (ls, lb, w1, b1, w2, b2)),
        gelu_approximate=approximate), np.float32)
    got = mlp_block.fused_mlp_block(*_port_args(case, tdt), gelu_approximate=approximate)
    assert got.shape == x.shape and got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else _bf16_steps(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("H,F", [(96, 256), (128, 200)], ids=["hidden", "intermediate"])
def test_fused_mlp_block_rejects_unaligned_widths(H, F):
    """Widths that are not multiples of 128 raise on both sides
    (mlp_block.py:128-129 in JAX)."""
    x, ls, lb, w1, b1, w2, b2 = _block_case(0, (4,), H, F)
    with pytest.raises(ValueError, match="aligned"):
        jmlp_block.fused_mlp_block(*(jnp.asarray(a) for a in (x, ls, lb, w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="multiples of 128"):
        mlp_block.fused_mlp_block(*_port_args((x, ls, lb, w1, b1, w2, b2), torch.float32))


def test_fused_mlp_block_rejects_mismatched_weights():
    x, ls, lb, w1, b1, w2, b2 = _block_case(0, (4,))
    with pytest.raises(ValueError, match="weight shapes"):
        mlp_block.fused_mlp_block(_t(x), _t(ls), _t(lb), _t(w1.copy()), _t(b1),
                                  _t(w2.T.copy()), _t(b2))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_fused_mlp_block_trainable_gradients_match_jax(approximate):
    """Gradients of all seven inputs through the port's autograd function
    vs ``jax.grad`` of ``fused_mlp_block_trainable`` (custom VJP: the
    interpreted kernel forward, the reference's backward), fp32, cotangent
    from a seed: 1e-5 of each gradient's largest entry."""
    case = _block_case(11, (3, 7))
    ct = np.random.default_rng(12).standard_normal(case[0].shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(jmlp_block.fused_mlp_block_trainable(
            *a, gelu_approximate=approximate) * ct)

    want = jax.grad(loss, argnums=tuple(range(7)))(*(jnp.asarray(a) for a in case))
    args = [t.clone().requires_grad_() for t in _port_args(case, torch.float32)]
    out = mlp_block.fused_mlp_block_trainable(*args, gelu_approximate=approximate)
    (out * _t(ct)).sum().backward()
    got = [a.grad for a in args]
    got[3], got[5] = got[3].T, got[5].T  # back to the JAX layout
    for name, g, w in zip(("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_fused_mlp_block_without_grad_skips_the_autograd_function():
    case = _port_args(_block_case(3, (5,)), torch.float32)
    with torch.no_grad():
        out = mlp_block.fused_mlp_block_trainable(*(t.requires_grad_() for t in case))
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# The ViT tower, the weight round trip and the dtype policy
# ---------------------------------------------------------------------------


def _fill(tree, rng, path=()):
    """Random values for every leaf: fan-in-scaled kernels, LayerNorm scales
    near 1, everything else (biases, class token, position embedding)
    N(0, 0.1)."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "scale":
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def _cfg(**kw):
    return dict(TINY, **kw)


@functools.lru_cache(maxsize=None)
def _params():
    """Tiny ViT CXRClip params (shapes from eval_shape, values from a seed);
    the flash and fused-MLP switches leave the tree unchanged, and the model
    has no batch statistics."""
    shapes = jax.eval_shape(
        JCXRClip(jconfig.ModelConfig(**TINY)).init, jax.random.key(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32),
    )
    assert "batch_stats" not in shapes
    return _fill(shapes["params"], np.random.default_rng(21))


@functools.lru_cache(maxsize=None)
def _port_model(bf16: bool = False, **kw):
    model = CXRClip(config.ModelConfig(**_cfg(**kw)))
    model.load_state_dict(state_dict_from_jax(_params(), {}), strict=True)
    if bf16:
        cast_matmul_weights(model, torch.bfloat16)
    return model.eval()


def _images(seed=2, b=3, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_tower(bf16: bool, **kw):
    jmodel = JCXRClip(jconfig.ModelConfig(**_cfg(**kw)),
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    return jax.jit(lambda p, x: jmodel.apply({"params": p}, x, normalize=False,
                                             method="encode_image")), \
        jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                          method=lambda m, x: m.image_tower(x)))


@pytest.mark.parametrize("flash", [False, True], ids=["xla_attention", "flash"])
def test_vit_tower_matches_jax_fp32(flash):
    """CLS features [3, 128] and projected image features, fp32, flash on
    and off, fused MLP asked for (its gate stays shut in fp32 on both
    sides): 1e-5."""
    kw = dict(flash_attention=flash, vit_fused_mlp=True)
    encode, tower = _jax_tower(False, **kw)
    x = _images()
    model = _port_model(**kw)
    with torch.no_grad():
        got_cls = model.image_tower(_t(x))
        got = model.encode_image(_t(x))
    assert got_cls.shape == (3, 128) and got.shape == (3, 64)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(tower(_params(), x)), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(encode(_params(), x)), atol=1e-5,
                               rtol=0)


def test_vit_tower_matches_jax_bf16_through_the_kernels():
    """bf16 with the fused MLP and flash on: JAX through its interpreted B3
    and B9 kernels, the port through their plain versions. CLS features
    within four bf16 steps at their largest entry, and every row's cosine
    ≥ 0.9999. Each side rounds its bf16 intermediates in its own order (the
    port's packed q|k|v product rounds once, JAX rounds the product and the
    bias add apart; summation order flips GELU and output roundings), so
    each layer's attention half and MLP half can each move the residual
    stream by about a step: four over two layers (measured: 3.5 steps,
    cosine 0.99994)."""
    kw = dict(flash_attention=True, vit_fused_mlp=True)
    _, tower = _jax_tower(True, **kw)
    x = _images(4)
    want = np.asarray(tower(_params(), jnp.asarray(x, jnp.bfloat16)), np.float32)
    model = _port_model(True, **kw)
    with torch.no_grad(), mock.patch.object(mlp_block, "fused_mlp_block_reference",
                                            wraps=mlp_block.fused_mlp_block_reference) as b9:
        got = model.image_tower(_t(x).bfloat16()).float().numpy()
    assert b9.call_count == 2  # one B9 call per layer: the gate opened
    np.testing.assert_allclose(got, want, atol=_bf16_steps(want, 4), rtol=0)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.9999


def test_fused_mlp_gate():
    """Inference, bf16 and 128-aligned widths open the gate; train mode,
    fp32 or an unaligned width keep the plain path, as in JAX."""
    layer = _port_model(True, vit_fused_mlp=True).image_tower.encoder.layers[0]
    assert layer._use_fused_mlp(torch.bfloat16)
    assert not layer._use_fused_mlp(torch.float32)
    layer.train()
    try:
        assert not layer._use_fused_mlp(torch.bfloat16)
    finally:
        layer.eval()
    narrow = CXRClip(config.ModelConfig(**_cfg(vit_hidden=64, vit_fused_mlp=True)))
    assert not narrow.image_tower.encoder.layers[0].eval()._use_fused_mlp(torch.bfloat16)


def test_vit_state_dict_round_trip_through_the_torchvision_importer():
    """The converted ViT state dict loads with strict=True, and its
    ``image_tower.*`` part, read by the JAX ``import_torchvision_vit_b16``,
    gives back the original params exactly."""
    sd = state_dict_from_jax(_params(), {})
    assert set(sd) == set(_port_model().state_dict())
    vit_sd = {k[len("image_tower."):]: v for k, v in sd.items() if k.startswith("image_tower.")}
    back = import_torchvision_vit_b16(vit_sd, layers=2, hidden=128)
    want = _params()["image_tower"]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_back) == len(flat_want)
    for path, value in flat_back:
        np.testing.assert_array_equal(np.asarray(value), flat_want[path], err_msg=str(path))


@pytest.mark.parametrize("fused_mlp", [False, True], ids=["plain_mlp", "fused_mlp"])
def test_cast_matmul_weights_covers_every_vit_parameter(fused_mlp):
    """After ``cast_matmul_weights`` every ViT parameter is bf16 (the packed
    attention projection, class token and position embedding included, as
    JAX casts them) except the LayerNorms and, with the fused MLP, its two
    biases, which the JAX ``fused_mlp_block`` takes in fp32."""
    model = CXRClip(config.ModelConfig(**_cfg(vit_fused_mlp=fused_mlp)))
    cast_matmul_weights(model, torch.bfloat16)
    fp32 = {n for n, p in model.image_tower.named_parameters() if p.dtype == torch.float32}
    want = {n for n, _ in model.image_tower.named_parameters() if ".ln" in n or n.startswith("ln")}
    if fused_mlp:
        want |= {f"encoder.layers.encoder_layer_{i}.mlp.{j}.bias" for i in (0, 1) for j in (0, 3)}
    assert fp32 == want
    other = {p.dtype for n, p in model.image_tower.named_parameters() if n not in fp32}
    assert other == {torch.bfloat16}


def test_cast_in_forward_gives_the_cast_model_forward():
    """fp32 masters cast on access give the bf16-stored model's features
    bit for bit, and gradients reach the fp32 bare parameters."""
    kw = dict(flash_attention=True, vit_fused_mlp=True)
    masters = CXRClip(config.ModelConfig(**_cfg(**kw)))
    masters.load_state_dict(state_dict_from_jax(_params(), {}))
    cast_in_forward(masters.eval(), torch.bfloat16)
    x = _t(_images(6)).bfloat16()
    with torch.no_grad():
        want = _port_model(True, **kw).image_tower(x)
        got = masters.image_tower(x)
    assert torch.equal(got, want)
    masters.image_tower(x).float().sum().backward()
    ct = masters.image_tower.class_token
    assert ct.dtype == torch.bfloat16
    master = masters.image_tower.parametrizations.class_token.original
    assert master.dtype == torch.float32 and master.grad is not None


def test_unported_vit_options_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        CXRClip(config.ModelConfig(**_cfg(vit_fused_mlp_train=True)))
    with pytest.raises(NotImplementedError, match="A9"):
        _port_model().image_tower(torch.zeros(1, 32, 32, 3), sow_weights=True)


def test_init_weights_is_seeded_for_the_vit():
    cfg = config.ModelConfig(**_cfg(flash_attention=True, vit_fused_mlp=True))
    a = init_weights(CXRClip(cfg), torch.Generator().manual_seed(7))
    b = init_weights(CXRClip(cfg), torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.image_tower.class_token.any()
    with torch.no_grad():
        assert float(a.image_tower.encoder.pos_embedding.std()) == pytest.approx(0.02, rel=0.2)


# ---------------------------------------------------------------------------
# The slice: port engine vs JAX engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines(bf16: bool):
    """The JAX and port ZeroShotEngine on the same weights and prompt bank,
    flash attention and both fused MLPs on."""
    kw = dict(flash_attention=True, vit_fused_mlp=True, bert_fused_mlp=True)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jmodel = JCXRClip(jconfig.ModelConfig(**_cfg(**kw)), dtype=jdt)
    prompts = prompts_for_family("prediction", LABELS)
    common = dict(image_size=32, max_text_length=16)
    jeng = JZeroShotEngine(jmodel, {"params": _params()}, JBertTokenizer(VOCAB), LABELS,
                           jconfig.ZeroShotConfig(), jconfig.CLIP_MEAN, jconfig.CLIP_STD,
                           compute_dtype=jdt, **common)
    jeng.build_text_features(prompts)
    eng = ZeroShotEngine(_port_model(bf16, **kw), BertTokenizer(VOCAB), LABELS,
                         config.ZeroShotConfig(), config.CLIP_MEAN, config.CLIP_STD,
                         compute_dtype=tdt, **common)
    eng.build_text_features(prompts)
    return jeng, eng


def _batch(seed=0, b=5):
    return np.random.default_rng(seed).integers(0, 256, (b, 48, 48, 1), dtype=np.uint8)


def test_engine_matches_jax_fp32():
    """fp32 (the fused gates stay shut): text features 1e-5, probabilities
    within 1e-4 and identical prediction sets (the ResNet engine's bounds
    in tests/test_torch_zeroshot.py)."""
    jeng, eng = _engines(False)
    np.testing.assert_allclose(eng.text_features.numpy(), np.asarray(jeng.text_features),
                               atol=1e-5, rtol=0)
    imgs = _batch()
    got, want = eng.probs(imgs), jeng.probs(imgs)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert eng.predict(imgs)[0] == jeng.predict(imgs)[0]
    assert eng.predict(imgs, top_k=3)[0] == jeng.predict(imgs, top_k=3)[0]


def test_engine_matches_jax_bf16_fused():
    """bf16 with the fused ViT MLP (B9), the fused BERT MLP (B4) and flash
    attention (B3) on both sides, JAX through its interpreted kernels:
    probabilities within 1e-2. A logit is a cosine over T = 0.5 and a
    sigmoid's slope is at most 1/4, so a probability moves by at most half
    the cosine's change; bf16 features of the two sides agree to ~1e-2
    relative (the tower test above), so cosines to ~1e-2 and probabilities
    to ~5e-3 (measured: 2.7e-3)."""
    jeng, eng = _engines(True)
    imgs = _batch(1)
    got, want = eng.probs(imgs), jeng.probs(imgs)
    assert got.shape == (5, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_service_answers_equal_engine_probs():
    """Each single-image answer (bucket 1) equals engine.probs on that
    image, bf16 ViT engine: 1e-6 (host vs device sigmoid)."""
    _, eng = _engines(True)
    service = ZeroShotService(eng, LABELS, buckets=(1, 4), max_wait_ms=1.0)
    try:
        for img in _batch(3, 3):
            answer = service.predict_one(img)
            want = eng.probs(img[None])[0]
            np.testing.assert_allclose([answer["probs"][d] for d in LABELS], want,
                                       atol=1e-6, rtol=0)
    finally:
        service.close()


def test_vit_preset_builds_the_published_geometry():
    """The ``vit`` preset's model is ViT-B/16 (86 M parameters in the tower,
    torchvision's count less the classification head) with 768-d image
    features into the projection."""
    cfg = dataclasses.replace(config.get_preset("vit").model, vit_fused_mlp=True)
    with torch.device("meta"):
        model = CXRClip(cfg)
    n = sum(p.numel() for p in model.image_tower.parameters())
    assert n == 85_798_656
    assert model.image_projector.image_projection.in_features == 768
