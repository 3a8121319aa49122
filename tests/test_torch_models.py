"""Parity of the port's models (clip_for_dl_tpu_torch/models) with the JAX
package's, on the CPU in fp32.

A tiny JAX CXRClip's variables are drawn from a seed with numpy and carried
into the port's CXRClip by ``state_dict_from_jax``; the same numpy inputs
then go through both. Tolerances are stated per test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.models.torch_export import export_reference_checkpoint
from clip_for_dl_tpu_torch.core.config import ModelConfig
from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
from clip_for_dl_tpu_torch.models import CXRClip, init_weights, state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(
    image_size=32, max_text_length=12, vocab_size=64, text_embedding_dim=128,
    text_layers=2, text_heads=2, text_intermediate_dim=256, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=16,
)


def _fill(tree, rng, path=()):
    """Random values for every leaf of a shape tree: fan-in-scaled kernels,
    non-zero biases, LayerNorm/BatchNorm scales near 1 and BatchNorm
    statistics away from (0, 1), so that a misplaced or transposed weight
    cannot hide behind flax's default init."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("scale", "var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        v = rng.uniform(-0.5, 0.5, shape)
    elif name == "embedding":
        v = rng.standard_normal(shape) * 0.5
    else:  # bias
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables():
    """Tiny JAX CXRClip variables (shapes from eval_shape, values from a
    seed); the flash switch leaves the tree unchanged."""
    shapes = jax.eval_shape(
        JCXRClip(JModelConfig(**TINY)).init, jax.random.key(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 12), jnp.int32),
    )
    rng = np.random.default_rng(1)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _fill(shapes["batch_stats"], rng)}


@functools.lru_cache(maxsize=None)
def _pair(flash: bool):
    cfg = dict(TINY, flash_attention=flash)
    variables = _variables()
    model = CXRClip(ModelConfig(**cfg))
    model.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True
    )
    return JCXRClip(JModelConfig(**cfg)), variables, model.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["xla_attention", "flash"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def pair_plain():
    return _pair(False)


def _apply(jmodel, variables, *args, **kw):
    """Jitted JAX forward: one compile instead of op-by-op dispatch."""
    return np.asarray(jax.jit(functools.partial(jmodel.apply, **kw))(variables, *args))


def _images(seed=2, b=2):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def _tokens(seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 64, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


def test_resnet_tower_parity(pair_plain):
    """Pooled features, stages (1,1,1,1) width 16: 2e-4 (tests/test_resnet.py's bar)."""
    jmodel, variables, model = pair_plain
    x = _images()
    want = _apply(jmodel, variables, x, method=lambda m, x: m.image_tower(x))
    with torch.no_grad():
        got = model.image_tower(torch.from_numpy(x))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("head", ["image_projector", "text_projector", "view_fusion",
                                  "adapter", "shared_adapter"])
def test_heads_parity(pair_plain, head):
    """Each head on random inputs: 1e-5."""
    jmodel, variables, model = pair_plain
    rng = np.random.default_rng(4)
    dims = {"image_projector": [512], "text_projector": [128], "view_fusion": [64, 64],
            "adapter": [64], "shared_adapter": [64, 64]}[head]
    args = [rng.standard_normal((3, d)).astype(np.float32) for d in dims]
    want = _apply(jmodel, variables, *args, method=lambda m, *a: getattr(m, head)(*a))
    with torch.no_grad():
        got = getattr(model, head)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_bert_parity(pair):
    """2-layer BERT (hidden 128, 2 heads, intermediate 256) with padded
    keys, flash on and off: last hidden state within 1e-5."""
    jmodel, variables, model = pair
    ids, mask = _tokens()
    want = _apply(jmodel, variables, ids, mask, method=lambda m, i, k: m.text_tower(i, k))
    with torch.no_grad():
        got = model.text_tower(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_encode_image_and_text_parity(pair):
    """CXRClip.encode_image / encode_text, normalized, vs the JAX forward: 1e-5."""
    jmodel, variables, model = pair
    x = _images(5, 3)
    ids, mask = _tokens(6)
    want_img = _apply(jmodel, variables, x, normalize=True, method="encode_image")
    want_txt = _apply(jmodel, variables, ids, mask, normalize=True, method="encode_text")
    with torch.no_grad():
        got_img = model.encode_image(torch.from_numpy(x), normalize=True)
        got_txt = model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask),
                                    normalize=True)
        got_logits = model.adapter_logits(got_img)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), atol=1e-5, rtol=0)
    want_logits = _apply(jmodel, variables, want_img, method="adapter_logits")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-5, rtol=0)


_EXPORT_PREFIX = {
    "resnet": "image_tower.",
    "image_projector": "image_projector.",
    "text_projector": "text_projector.",
    "view_fusion": "view_fusion.",
    "text_model": "text_tower.",
    "classifier": "adapter.classifier.",
}


def test_state_dict_names_and_values_match_export(pair_plain):
    """state_dict_from_jax agrees with export_reference_checkpoint on every
    name it exports (exactly), and covers the port's whole state dict."""
    _, variables, model = pair_plain
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    ckpt = export_reference_checkpoint(variables, text_layers=TINY["text_layers"])
    exported = {}
    for name, part in ckpt["models"].items():
        for key, value in part.items():
            exported[_EXPORT_PREFIX[name] + key] = np.asarray(value)
    port_only = {k for k in sd if k.startswith("shared_adapter.")}
    assert set(sd) - port_only == set(exported)
    for key, value in exported.items():
        np.testing.assert_array_equal(sd[key].numpy(), value.astype(sd[key].numpy().dtype))
    assert set(sd) == set(model.state_dict())


def test_init_weights_is_seeded_and_casts_keep_norms_fp32():
    cfg = ModelConfig(**dict(TINY, flash_attention=True, bert_fused_mlp=True))
    a = init_weights(CXRClip(cfg), torch.Generator().manual_seed(7))
    b = init_weights(CXRClip(cfg), torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    cast_matmul_weights(a, torch.bfloat16)
    assert a.image_tower.conv1.weight.dtype == torch.bfloat16
    assert a.image_tower.bn1.weight.dtype == torch.float32
    assert a.text_tower.embeddings.LayerNorm.weight.dtype == torch.float32
    assert a.text_tower.encoder.layer[0].intermediate.dense.weight.dtype == torch.bfloat16
    assert a.image_tower.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        feats = a.eval().encode_image(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16),
                                      normalize=True)
        txt = a.encode_text(torch.ones(2, 12, dtype=torch.int32), normalize=True)
    assert feats.dtype == torch.bfloat16 and torch.isfinite(feats.float()).all()
    assert txt.shape == (2, 64) and torch.isfinite(txt.float()).all()


def test_unported_variants_raise():
    """The ViT tower is ported (tests/test_torch_vit.py); its training MLP
    and multimodal attention are not."""
    with pytest.raises(NotImplementedError, match="A8"):
        CXRClip(dataclasses.replace(ModelConfig(**TINY).with_vit(), vit_fused_mlp_train=True))
    with pytest.raises(NotImplementedError):
        CXRClip(dataclasses.replace(ModelConfig(**TINY), use_multimodal_attention=True))
