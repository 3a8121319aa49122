"""The serving slice as a whole, port vs JAX package, on the CPU in fp32.

The JAX ``ZeroShotEngine`` (tiny config, flash attention on) and the port's
``ZeroShotEngine`` get the same weights (drawn from a seed, carried by
``state_dict_from_jax``), the same prompt bank and vocabulary, and the same
48x48 grey uint8 batch. Also: the copied pure-Python modules (config,
tokenizer, prompts, predictors) against their originals, and the
``ZeroShotService`` against the engine it serves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_for_dl_tpu.core import config as jconfig
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu.zeroshot import predict as jpredict
from clip_for_dl_tpu.zeroshot import prompts as jprompts
from clip_for_dl_tpu_torch.core import config
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.serving import ZeroShotService
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.zeroshot import (
    ZeroShotEngine,
    predict,
    prompts_for_family,
)

torch.set_num_threads(1)

LABELS = config.DISEASE_LABELS
FAMILIES = ("prediction", "basic", "showing")


# ---------------------------------------------------------------------------
# Copied pure-Python modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "ZeroShotConfig", "DataConfig",
                                  "AugmentConfig", "TrainConfig", "MeshConfig",
                                  "ExperimentConfig", "OptimGroup"])
def test_config_fields_and_defaults_match(name):
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
        (f.name, f.default) for f in dataclasses.fields(theirs)
    ]


@pytest.mark.parametrize("preset", ["pretrain_clip", "adapter", "zero_shot", "vit",
                                    "scripts_train", "multimodal_attention"])
def test_presets_match(preset):
    assert dataclasses.asdict(config.get_preset(preset)) == dataclasses.asdict(
        jconfig.get_preset(preset)
    )
    assert config.DISEASE_LABELS == jconfig.DISEASE_LABELS
    assert (config.CLIP_MEAN, config.CLIP_STD) == (jconfig.CLIP_MEAN, jconfig.CLIP_STD)


@pytest.mark.parametrize("family", FAMILIES)
def test_prompts_and_tokenizer_match(family):
    """Same prompts; same ids and masks from the JAX CLI's dev vocabulary."""
    ours = prompts_for_family(family, LABELS)
    assert ours == jprompts.prompts_for_family(family, LABELS)
    vocab = build_dev_vocab(LABELS)
    texts = [p for d in LABELS for p in ours[d]] + [""]
    got = BertTokenizer(vocab).encode(texts, max_length=200)
    want = JBertTokenizer(vocab).encode(texts, max_length=200)
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[key], want[key])


def test_dev_vocab_matches_the_jax_cli():
    from types import SimpleNamespace

    from clip_for_dl_tpu.cli.main import _tokenizer

    assert build_dev_vocab(LABELS) == _tokenizer(SimpleNamespace(vocab=None)).vocab


def test_unported_prompt_families_raise():
    """The report-built families need the reports table; without it they
    raise the JAX package's ValueError (tests/test_torch_prompts.py holds
    them with one)."""
    with pytest.raises(ValueError, match="rich prompts need the reports dataframe"):
        prompts_for_family("rich", LABELS)


@pytest.mark.parametrize("threshold,top_k", [(0.5, None), (0.7, 3), ({"Mass": 0.2}, 2)])
def test_predictors_match(threshold, top_k):
    rng = np.random.default_rng(0)
    probs = rng.random((6, 16)).astype(np.float32)
    assert predict.sigmoid_predictions(probs, LABELS, threshold, top_k) == \
        jpredict.sigmoid_predictions(probs, LABELS, threshold, top_k)
    logits = rng.standard_normal((6, 16)).astype(np.float32)
    assert predict.softmax_topk_predictions(logits, LABELS, 3) == \
        jpredict.softmax_topk_predictions(logits, LABELS, 3)


# ---------------------------------------------------------------------------
# The slice: port engine vs JAX engine
# ---------------------------------------------------------------------------

TINY = dict(
    image_size=32, max_text_length=16, text_embedding_dim=64, text_layers=2,
    text_heads=2, text_intermediate_dim=128, shared_embedding_dim=64,
    text_max_position=32, resnet_stages=(1, 1, 1, 1), resnet_width=8,
    flash_attention=True,
)


def _fill(tree, rng, path=()):
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
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def _engines(enhance: bool = False):
    """The JAX and the port's engine over one tiny model's weights (with the
    cross-modal attention and ``use_enhance`` when ``enhance``), their
    prompt banks built."""
    vocab = build_dev_vocab(LABELS)
    cfg = dict(TINY, vocab_size=len(vocab), use_multimodal_attention=enhance)
    jmodel = JCXRClip(jconfig.ModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    rng = np.random.default_rng(7)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    model = CXRClip(config.ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    prompts = prompts_for_family("prediction", LABELS)
    common = dict(image_size=32, max_text_length=16)
    jeng = JZeroShotEngine(jmodel, variables, JBertTokenizer(vocab), LABELS,
                           jconfig.ZeroShotConfig(), jconfig.CLIP_MEAN, jconfig.CLIP_STD,
                           compute_dtype=jnp.float32, use_enhance=enhance, **common)
    jeng.build_text_features(prompts)
    eng = ZeroShotEngine(model, BertTokenizer(vocab), LABELS, config.ZeroShotConfig(),
                         config.CLIP_MEAN, config.CLIP_STD,
                         compute_dtype=torch.float32, use_enhance=enhance, **common)
    eng.build_text_features(prompts)
    return jeng, eng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_enhance_engine_matches_jax():
    """``use_enhance`` (the multimodal_attention preset's zero-shot): the
    unit image features through the cross-modal attention against the
    bank, normalized again, then B1. Probabilities within 1e-4 of the JAX
    engine's and the same prediction sets; the attention moves them (the
    same weights without it score otherwise)."""
    jeng, eng = _engines(enhance=True)
    imgs = _batch(4, 6)
    got, want = eng.probs(imgs), jeng.probs(imgs)
    assert got.shape == (6, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert eng.predict(imgs)[0] == jeng.predict(imgs)[0]
    eng.use_enhance = False
    assert np.abs(eng.probs(imgs) - got).max() > 1e-3


def _batch(seed=0, b=5):
    return np.random.default_rng(seed).integers(0, 256, (b, 48, 48, 1), dtype=np.uint8)


def test_text_features_match(engines):
    """Prompt-bank features [16, 64]: 1e-5."""
    jeng, eng = engines
    assert eng.text_features.shape == (16, 64)
    np.testing.assert_allclose(eng.text_features.numpy(), np.asarray(jeng.text_features),
                               atol=1e-5, rtol=0)


def test_probs_and_predictions_match(engines):
    """Probabilities within 1e-4; identical prediction sets."""
    jeng, eng = engines
    imgs = _batch()
    got, want = eng.probs(imgs), jeng.probs(imgs)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert eng.predict(imgs)[0] == jeng.predict(imgs)[0]
    assert eng.predict(imgs, top_k=3)[0] == jeng.predict(imgs, top_k=3)[0]


def test_stream_logits_matches_logits(engines):
    _, eng = engines
    batches = [{"images": _batch(s, 3), "id": s} for s in range(3)]
    out = list(eng.stream_logits(iter(batches)))
    assert [b["id"] for b, _ in out] == [0, 1, 2]
    for b, logits in out:
        np.testing.assert_allclose(logits, eng.logits(b["images"]), atol=1e-6, rtol=0)


def test_service_answers_equal_engine_probs(engines):
    """Each single-image answer (bucket 1) equals engine.probs on that
    image: 1e-6 (host vs device sigmoid)."""
    _, eng = engines
    service = ZeroShotService(eng, LABELS, buckets=(1, 4), max_wait_ms=1.0)
    try:
        imgs = _batch(3, 3)
        for img in imgs:
            answer = service.predict_one(img)
            want = eng.probs(img[None])[0]
            np.testing.assert_allclose([answer["probs"][d] for d in LABELS], want,
                                       atol=1e-6, rtol=0)
            assert answer["predictions"] == [d for d, p in zip(LABELS, want) if p > 0.5]
    finally:
        service.close()


def test_micro_batcher_matches_the_original():
    """The copied MicroBatcher pads to the same buckets and resolves every
    request with its own row, like the JAX package's."""
    from clip_for_dl_tpu.serving import MicroBatcher as JMicroBatcher
    from clip_for_dl_tpu_torch.serving import MicroBatcher

    def predict(images):  # row i: its image's mean and the padded batch size
        means = images.reshape(len(images), -1).mean(1)
        return np.stack([means, np.full(len(images), len(images))], 1)

    imgs = np.random.default_rng(5).integers(0, 256, (7, 4, 4, 1), dtype=np.uint8)
    results = []
    for cls in (MicroBatcher, JMicroBatcher):
        batcher = cls(predict, buckets=(1, 4, 16), max_wait_ms=50.0)
        try:
            out = np.asarray([batcher.submit(im).result(timeout=30) for im in imgs])
            stats = batcher.stats()
        finally:
            batcher.close()
        assert set(out[:, 1]) <= {1, 4, 16}
        results.append((out[:, 0], stats["requests"], sorted(stats)))
    np.testing.assert_array_equal(results[0][0], imgs.reshape(7, -1).mean(1))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1:] == results[1][1:]
