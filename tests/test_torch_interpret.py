"""Interpretability of the port (clip_for_dl_tpu_torch/interpret) against
the JAX package's, on the CPU in fp32.

Tiny JAX CXRClip variables (a ResNet tower at 96 px, so that stage 4 is
3 × 3, and a ViT tower at 64 px, 4 × 4 patches) are drawn from a seed with
numpy and carried into the port by ``state_dict_from_jax``; the same numpy
inputs go through both. The JAX ``attention_rollout`` raises for any
discard ratio that drops an entry (ROADMAP C9), so the port's discard rule is
held against a numpy statement of the rule the JAX comment gives.
Tolerances are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.interpret import attention_rollout as jattention_rollout
from clip_for_dl_tpu.interpret import fuse_heads as jfuse_heads
from clip_for_dl_tpu.interpret import gradcam as jgradcam
from clip_for_dl_tpu.interpret import jet_colormap as jjet_colormap
from clip_for_dl_tpu.interpret import overlay_cam as joverlay_cam
from clip_for_dl_tpu.interpret import save_attention_weights as jsave_attention_weights
from clip_for_dl_tpu.interpret import upsample_cam as jupsample_cam
from clip_for_dl_tpu.interpret.gradcam import _head_scores as j_head_scores
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu_torch.core.config import ModelConfig
from clip_for_dl_tpu_torch.interpret import (
    attention_rollout,
    fuse_heads,
    gradcam,
    jet_colormap,
    overlay_cam,
    save_attention_weights,
    upsample_cam,
    vit_rollout,
)
from clip_for_dl_tpu_torch.interpret.gradcam import _class_grads
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax

torch.set_num_threads(1)

COMMON = dict(max_text_length=8, vocab_size=64, text_embedding_dim=16, text_layers=1,
              text_heads=2, text_intermediate_dim=32, shared_embedding_dim=32,
              text_max_position=16)
RESNET = dict(COMMON, image_size=96, resnet_stages=(1, 1, 1, 1), resnet_width=8)
VIT = dict(COMMON, image_tower="vit_b16", image_embedding_dim=32, image_size=64, vit_patch=16,
           vit_layers=2, vit_heads=2, vit_hidden=32, vit_mlp_dim=64)


def _fill(tree, rng, path=()):
    """Random values for every leaf (fan-in-scaled kernels, non-zero biases,
    norm scales near 1, BatchNorm statistics away from (0, 1))."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        v = rng.uniform(-0.5, 0.5, shape)
    else:  # biases, embeddings, the class token, position embeddings
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(tower: str, flash: bool = False):
    """(JAX model, its variables, the port's model in eval mode) with the same
    seeded weights; the flash switch leaves the weights unchanged."""
    cfg = dict(RESNET if tower == "resnet" else VIT, flash_attention=flash)
    size = cfg["image_size"]
    jmodel = JCXRClip(JModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(5)
    variables = {k: _fill(v, rng) for k, v in shapes.items()}
    model = CXRClip(ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats")), strict=True)
    return jmodel, variables, model.eval()


def _images(size, seed=2, b=2):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _text(seed=3):
    return np.random.default_rng(seed).standard_normal((16, 32)).astype(np.float32)


# -- Grad-CAM --------------------------------------------------------------------


def test_capture_stage4_matches_jax():
    """Stage-4 activations NHWC [2, 3, 3, 256] and the projected features
    beside them: 2e-4, the ResNet tower's parity bar (tests/test_resnet.py)."""
    jmodel, variables, model = _pair("resnet")
    x = _images(96)
    jfeats, jstage4 = jmodel.apply(variables, jnp.asarray(x), method="encode_image_with_stage4")
    with torch.no_grad():
        feats, stage4 = model.encode_image_with_stage4(torch.from_numpy(x))
        pooled = model.image_tower(torch.from_numpy(x))
    assert stage4.shape == (2, 3, 3, 256) and stage4.dtype == torch.float32
    np.testing.assert_allclose(stage4.numpy(), np.asarray(jstage4), atol=2e-4, rtol=0)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-4, rtol=0)
    # the capture changes nothing of the pooled output
    assert torch.equal(stage4.mean(dim=(1, 2)), pooled)


@pytest.mark.parametrize("mode", ["similarity", "adapter"])
def test_gradcam_matches_jax(mode):
    """Scores and the normalized CAMs [16, 2, 3, 3] against JAX's gradcam at
    1e-5, and the raw per-class gradients [16, 2, 3, 3, 256] of the head at
    1e-5 of their largest entry: the CAMs' min-max normalization amplifies
    a gradient difference where a map's max − min is small, so the gradients
    are held before it. The gradients are taken at JAX's stage-4 activations
    on both sides, so only the heads' arithmetic differs."""
    jmodel, variables, model = _pair("resnet")
    x = _images(96)
    text = _text() if mode == "similarity" else None
    jtext = None if text is None else jnp.asarray(text)
    jcams, jscores = jgradcam(jmodel, variables, jnp.asarray(x), jtext, mode=mode,
                              temperature=0.5)
    cams, scores = gradcam(model, torch.from_numpy(x),
                           None if text is None else torch.from_numpy(text), mode, 0.5)
    assert cams.shape == (16, 2, 3, 3) and scores.shape == (2, 16)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cams.numpy(), np.asarray(jcams), atol=1e-5, rtol=0)

    _, jstage4 = jmodel.apply(variables, jnp.asarray(x), method="encode_image_with_stage4")
    jstage4 = jstage4.astype(jnp.float32)
    jsc, vjp = jax.vjp(lambda s4: j_head_scores(jmodel, variables, s4, jtext, 0.5, mode),
                       jstage4)
    jgrads = jax.vmap(lambda c: vjp(jnp.broadcast_to(jax.nn.one_hot(c, 16), jsc.shape))[0])(
        jnp.arange(16))
    grads, _ = _class_grads(model, torch.from_numpy(np.array(jstage4)),
                            None if text is None else torch.from_numpy(text), 0.5, mode)
    jgrads = np.asarray(jgrads)
    assert grads.shape == jgrads.shape == (16, 2, 3, 3, 256)
    np.testing.assert_allclose(grads.numpy(), jgrads, atol=1e-5 * np.abs(jgrads).max(), rtol=0)


def test_gradcam_on_a_vit_raises_in_both_packages():
    """The JAX ViT takes no ``capture_stage4`` (TypeError); the port names
    the tower (ValueError)."""
    jmodel, variables, model = _pair("vit")
    x = _images(64)
    with pytest.raises(TypeError):
        jgradcam(jmodel, variables, jnp.asarray(x), jnp.asarray(_text()))
    with pytest.raises(ValueError, match="vit_b16"):
        gradcam(model, torch.from_numpy(x), torch.from_numpy(_text()))


def test_upsample_overlay_and_jet_colormap_match_jax():
    """upsample_cam [2, 3, 3] → [2, 96, 80], overlay_cam over [96, 80, 3]
    and the JET colormap over [0, 1] and beyond it: 1e-6 (the same fp32
    interpolation matrices and clamps)."""
    rng = np.random.default_rng(4)
    cam = rng.random((2, 3, 3)).astype(np.float32)
    up = upsample_cam(torch.from_numpy(cam), 96, 80)
    np.testing.assert_allclose(up.numpy(), np.asarray(jupsample_cam(jnp.asarray(cam), 96, 80)),
                               atol=1e-6, rtol=0)
    img = rng.random((96, 80, 3)).astype(np.float32)
    got = overlay_cam(torch.from_numpy(img), up[0], alpha=0.4)
    want = joverlay_cam(jnp.asarray(img), jnp.asarray(up[0].numpy()), alpha=0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    x = np.linspace(-0.2, 1.2, 57, dtype=np.float32)
    np.testing.assert_allclose(jet_colormap(torch.from_numpy(x)).numpy(),
                               np.asarray(jjet_colormap(jnp.asarray(x))), atol=1e-6, rtol=0)


# -- rollout ---------------------------------------------------------------------


def _softmax_layers(seed, layers=3, b=2, h=3, n=17):
    x = np.random.default_rng(seed).standard_normal((layers, b, h, n, n)).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return list(e / e.sum(-1, keepdims=True))


@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
def test_fuse_heads_and_rollout_match_jax(fusion):
    """fuse_heads within 1e-7 (max and min exactly; the mean's fp32 sum may
    differ in order), attention_rollout at ratio 0 within 1e-5 (three
    layers, 16 patches + CLS)."""
    layers = _softmax_layers(6)
    np.testing.assert_allclose(fuse_heads(torch.from_numpy(layers[0]), fusion).numpy(),
                               np.asarray(jfuse_heads(jnp.asarray(layers[0]), fusion)),
                               atol=1e-7 if fusion == "mean" else 0, rtol=0)
    got = attention_rollout([torch.from_numpy(a) for a in layers], fusion)
    want = jattention_rollout([jnp.asarray(a) for a in layers], fusion)
    assert got.shape == (2, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _numpy_rollout(layers, ratio):
    """The rule in numpy: mean over heads; in each row, the k = int((N-1)·r)
    smallest entries among columns 1..N-1 zeroed (stable order, so ties fall
    by column index); (A + I) / rowsum folded from layer 0 upward; the CLS
    row's patches over their max."""
    n = layers[0].shape[-1]
    k = int((n - 1) * ratio)
    rollout = None
    for a in layers:
        fused = a.astype(np.float64).mean(axis=1)
        for row in fused.reshape(-1, n):
            row[1 + np.argsort(row[1:], kind="stable")[:k]] = 0.0
        aug = fused + np.eye(n)
        aug /= aug.sum(-1, keepdims=True)
        rollout = aug if rollout is None else aug @ rollout
    g = int(np.sqrt(n - 1))
    mask = rollout[:, 0, 1:].reshape(-1, g, g)
    return mask / mask.max(axis=(1, 2), keepdims=True)


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_discard_ratio_follows_its_rule(ratio):
    """k = int(16 · ratio) = 1, 8, 14 entries zeroed a row, never the CLS
    column, exactly k even among ties (a row of a layer is made of equal
    values): 1e-5 against the numpy statement of the rule."""
    layers = _softmax_layers(7)
    layers[1][0, :, 3, :] = 1.0 / 17  # a row of ties in every head
    got = attention_rollout([torch.from_numpy(a) for a in layers], "mean", ratio)
    np.testing.assert_allclose(got.numpy(), _numpy_rollout(layers, ratio), atol=1e-5, rtol=0)


def test_jax_rollout_still_raises_for_a_discard_ratio():
    """The reference fault the port does not copy (ROADMAP C9): the JAX
    threshold row is [L, B, N, 2], not [L, B, N, N]. A repaired reference
    fails this test, and the discard rule can then be held against it."""
    layers = [jnp.asarray(a) for a in _softmax_layers(7)]
    with pytest.raises(TypeError):
        jattention_rollout(layers, "mean", 0.1)


def test_vit_rollout_matches_jax():
    """The ViT's per-layer probabilities [2, 2, 17, 17] (1e-5), its CLS
    features (2e-5) and the rollout mask [2, 4, 4] (1e-5) against JAX's
    sown intermediates through ``encode_image_sowed``."""
    jmodel, variables, model = _pair("vit")
    x = _images(64)
    jfeats, inter = jmodel.apply(variables, jnp.asarray(x), mutable=["intermediates"],
                                 method="encode_image_sowed")
    tree = inter["intermediates"]["image_tower"]
    jattns = [tree[f"layer_{i}"]["attention_weights"][0] for i in range(2)]
    with torch.no_grad():
        feats, attns = model.encode_image_sowed(torch.from_numpy(x))
    assert len(attns) == 2 and all(a.dtype == torch.float32 for a in attns)
    for a, ja in zip(attns, jattns):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-5, rtol=0)
    got = vit_rollout(model.image_tower, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattention_rollout(jattns)),
                               atol=1e-5, rtol=0)


def test_sowing_turns_flash_off_and_keeps_the_features():
    """With flash attention on, the sowing forward runs the plain attention
    (the kernel keeps no probabilities): its features are bit-equal to the
    forward of the same weights with flash off, and the ResNet and ViT
    towers refuse each other's paths."""
    _, _, flash = _pair("vit", flash=True)
    _, _, plain = _pair("vit")
    x = torch.from_numpy(_images(64))
    with torch.no_grad():
        feats, attns = flash.image_tower(x, sow_weights=True)
        assert torch.equal(feats, plain.image_tower(x))
        assert not torch.equal(flash.image_tower(x), feats)  # the flash route's own sums
    with pytest.raises(ValueError, match="resnet50"):
        _pair("resnet")[2].encode_image_sowed(x)


def test_save_attention_weights_writes_the_jax_files(tmp_path):
    """The same paths, the same .npy and PNG bytes for attention weights
    given as a numpy array to JAX and as a tensor to the port."""
    rng = np.random.default_rng(8)
    attn = rng.random((3, 16)).astype(np.float32)
    images = rng.random((3, 8, 8, 1)).astype(np.float32)
    names = [f"d{i}" for i in range(16)]
    want = jsave_attention_weights(attn, names, str(tmp_path / "jax"), epoch=1, batch_idx=2,
                                   images=images, max_samples=2)
    got = save_attention_weights(torch.from_numpy(attn), names, str(tmp_path / "port"),
                                 epoch=1, batch_idx=2, images=images, max_samples=2)
    assert [p.replace("port", "jax") for p in got] == want and len(got) == 3
    for p, q in zip(got, want):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read(), p
