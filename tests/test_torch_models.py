"""Parity of the port's models (clip_for_dl_tpu_torch/models) with the JAX
package's, on the CPU in fp32.

A tiny JAX CXRClip's variables are drawn from a seed with numpy and carried
into the port's CXRClip by ``state_dict_from_jax``; the same numpy inputs
then go through both. Tolerances are stated per test.
"""

import copy
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
    """The ViT tower is ported (tests/test_torch_vit.py), and the
    multimodal attention (below); so is the ViT's training MLP now
    (tests/test_torch_vit_train.py): a model with ``vit_fused_mlp_train``
    builds, every ViT layer carrying the switch, and no variant raises."""
    model = CXRClip(dataclasses.replace(ModelConfig(**TINY).with_vit(), vit_fused_mlp_train=True))
    assert all(layer.fused_mlp_train for layer in model.image_tower.encoder.layers)


# -- the cross-modal attention and the fusion alternatives ----------------------------------


@functools.lru_cache(maxsize=None)
def _multimodal():
    """A tiny multimodal JAX CXRClip (the cross-modal attention built), its
    variables from a seed and the port's model holding them."""
    cfg = dict(TINY, use_multimodal_attention=True)
    jmodel = JCXRClip(JModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 12), jnp.int32))
    rng = np.random.default_rng(11)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    model = CXRClip(ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jmodel, variables, model.eval()


def test_multimodal_model_matches_jax():
    """The multimodal model in eval mode: encode_multiview of (frontal,
    lateral) pairs, enhance against a 16-class bank (the enhanced features
    and the attention weights) and the shared adapter's logits: 1e-5."""
    jmodel, variables, model = _multimodal()
    rng = np.random.default_rng(12)
    views = rng.standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    bank = rng.standard_normal((16, 64)).astype(np.float32)
    want_f = _apply(jmodel, variables, views, method="encode_multiview")
    want_e, want_w = jax.jit(functools.partial(jmodel.apply, method="enhance"))(
        variables, want_f, bank)
    want_s = _apply(jmodel, variables, want_f, bank[:3], method="shared_adapter_logits")
    with torch.no_grad():
        got_f = model.encode_multiview(torch.from_numpy(views))
        got_e, got_w = model.enhance(got_f, torch.from_numpy(bank))
        got_s = model.shared_adapter_logits(got_f, torch.from_numpy(bank[:3]))
    assert got_e.shape == (3, 64) and got_w.shape == (3, 16) and got_w.dtype == torch.float32
    for got, want in ((got_f, want_f), (got_e, want_e), (got_w, want_w), (got_s, want_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_multimodal_attention_in_bf16_matches_jax():
    """The attention with bf16 weights (``cast_matmul_weights``, the
    serving form) against the JAX module at dtype bf16: the Linears, tanh
    and img + attended in bf16, the softmax in fp32, the weighted sum
    accumulated in fp32. Enhanced features within two bf16 steps of their
    largest entry (2^-6 relative), weights within 2e-3 (softmax of scores
    that differ by a bf16 rounding)."""
    from clip_for_dl_tpu.models.attention_fusion import (
        AdditiveMultiModalAttention as JAttention,
    )

    _, variables, model = _multimodal()
    params = {"params": variables["params"]["multimodal_attention"]}
    rng = np.random.default_rng(13)
    img = rng.standard_normal((5, 64)).astype(np.float32)
    bank = rng.standard_normal((16, 64)).astype(np.float32)
    want_e, want_w = JAttention(64, dtype=jnp.bfloat16).apply(params, img, bank)
    attention = cast_matmul_weights(copy.deepcopy(model.multimodal_attention), torch.bfloat16)
    with torch.no_grad():
        got_e, got_w = attention(torch.from_numpy(img), torch.from_numpy(bank))
    assert got_e.dtype == torch.bfloat16 and got_w.dtype == torch.float32
    want_e = np.asarray(want_e.astype(jnp.float32))
    np.testing.assert_allclose(got_e.float().numpy(), want_e,
                               atol=2.0 ** -6 * float(np.abs(want_e).max()), rtol=0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=2e-3, rtol=0)


def test_multimodal_names_match_export_and_a_jax_pth_loads(tmp_path):
    """export_reference_checkpoint writes the attention under
    ``multimodal_attention`` with the names state_dict_from_jax gives
    (``image_proj``, ``text_proj``, ``attention``, ``output_proj``); a
    reference .pth the JAX package writes of the model imports into the
    port with every tensor the port's (exactly), all but the shared
    adapter's (which the reference file has none of)."""
    from clip_for_dl_tpu.models.torch_export import save_reference_checkpoint as jsave
    from clip_for_dl_tpu_torch.train.checkpoint import import_reference_checkpoint

    _, variables, model = _multimodal()
    ckpt = export_reference_checkpoint(variables, text_layers=TINY["text_layers"])
    part = ckpt["models"]["multimodal_attention"]
    assert sorted(part) == sorted(f"{n}.{w}" for n in ("image_proj", "text_proj", "attention",
                                                        "output_proj")
                                  for w in ("weight", "bias"))
    sd = model.state_dict()
    for key, value in part.items():
        np.testing.assert_array_equal(sd[f"multimodal_attention.{key}"].numpy(), value)
    path = str(tmp_path / "multimodal.pth")
    jsave(variables, path, epoch=2, text_layers=TINY["text_layers"])
    got = import_reference_checkpoint(path)
    assert got["epoch"] == 2
    assert set(sd) - set(got["state_dict"]) == {"shared_adapter.classifier.weight",
                                                "shared_adapter.classifier.bias"}
    for key, value in got["state_dict"].items():
        assert torch.equal(value.to(sd[key].dtype), sd[key]), key
    twin = CXRClip(ModelConfig(**dict(TINY, use_multimodal_attention=True)))
    missing, unexpected = twin.load_state_dict(got["state_dict"], strict=False)
    assert not unexpected and set(missing) == {"shared_adapter.classifier.weight",
                                               "shared_adapter.classifier.bias"}


def _torch_names(params, prefix=""):
    """A flax parameter tree of Dense and LayerNorm leaves → torch names:
    kernel [in, out] → weight [out, in], scale → weight, bias as is."""
    sd = {}
    for name, p in params.items():
        dst = f"{prefix}{name}"
        if "kernel" in p:
            sd[f"{dst}.weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
            sd[f"{dst}.bias"] = torch.from_numpy(np.asarray(p["bias"]))
        elif "scale" in p:
            sd[f"{dst}.weight"] = torch.from_numpy(np.asarray(p["scale"]))
            sd[f"{dst}.bias"] = torch.from_numpy(np.asarray(p["bias"]))
        else:
            sd.update(_torch_names(p, dst + "."))
    return sd


@pytest.mark.parametrize("which", ["additive", "mha", "cross_modal", "mld"])
def test_attention_fusion_modules_match_jax(which):
    """Each module of models/attention_fusion.py, forward in eval mode, on
    the state dict its flax twin's parameters map to by name: every output
    within 1e-5. The three alternatives have no caller in either package."""
    from clip_for_dl_tpu.models import attention_fusion as jfusion
    from clip_for_dl_tpu_torch.models import attention_fusion as fusion

    rng = np.random.default_rng(14)

    def x(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    jmod, mod, args = {
        "additive": (jfusion.AdditiveMultiModalAttention(32),
                     fusion.AdditiveMultiModalAttention(32), (x(5, 32), x(16, 32))),
        "mha": (jfusion.TorchStyleMHA(32, 4), fusion.TorchStyleMHA(32, 4),
                (x(3, 6, 32), x(3, 9, 32), x(3, 9, 32))),
        "cross_modal": (jfusion.CrossModalTransformerFusion(48, 40, 32, 4),
                        fusion.CrossModalTransformerFusion(48, 40, 32, 4),
                        (x(5, 48), x(16, 40))),
        "mld": (jfusion.MLDAdapterBlock(32, 4), fusion.MLDAdapterBlock(32, 4),
                (x(3, 16, 32), x(3, 10, 32))),
    }[which]
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), *args)
    params = _fill(shapes["params"], np.random.default_rng(15))
    want = jmod.apply({"params": params}, *args)
    mod.load_state_dict(_torch_names(params), strict=True)
    with torch.no_grad():
        got = mod.eval()(*map(torch.from_numpy, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
