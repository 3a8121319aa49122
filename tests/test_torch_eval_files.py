"""The evaluation path from files, port vs JAX package, on the CPU in fp32:
PNG and CSV files → labels, exam index, grey-packed image cache →
``ChestXrayMultiViewDataset`` → ``HostLoader`` → ``ZeroShotEngine`` →
``run_zero_shot_eval`` / ``run_dynamic_threshold_eval`` → metrics and the
result CSV; and ``inference.py``'s ``InferenceSession`` and
``AdapterEngine`` on the same batches.

The tiny model (flash attention on, as ``tests/test_torch_zeroshot.py``)
gets its weights from a seed in JAX and ``state_dict_from_jax`` carries them
over. Tolerances are stated per test.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from clip_for_dl_tpu import inference as jinference
from clip_for_dl_tpu.core import config as jconfig
from clip_for_dl_tpu.data import ChestXrayMultiViewDataset as JMultiView
from clip_for_dl_tpu.data import HostLoader as JHostLoader
from clip_for_dl_tpu.data import ImageCache as JImageCache
from clip_for_dl_tpu.data import build_exam_index as jbuild_exam_index
from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.ops.similarity import l2_normalize as jl2_normalize
from clip_for_dl_tpu.text import BertTokenizer as JBertTokenizer
from clip_for_dl_tpu.zeroshot import ZeroShotEngine as JZeroShotEngine
from clip_for_dl_tpu.zeroshot import driver as jdriver
from clip_for_dl_tpu.zeroshot import predict as jpredict
from clip_for_dl_tpu.zeroshot import thresholds as jthresholds
from clip_for_dl_tpu_torch import inference
from clip_for_dl_tpu_torch.core import config
from clip_for_dl_tpu_torch.data import (
    ChestXrayMultiViewDataset,
    HostLoader,
    build_exam_index,
    build_image_cache,
    prepare_labeled_csv,
    read_csv,
)
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.ops.similarity import l2_normalize, similarity
from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.text.tokenizer import build_dev_vocab
from clip_for_dl_tpu_torch.zeroshot import (
    ZeroShotEngine,
    driver,
    predict,
    prompts_for_family,
    run_dynamic_threshold_eval,
    run_zero_shot_eval,
    thresholds,
)

torch.set_num_threads(1)

LABELS = config.DISEASE_LABELS
TINY = dict(
    image_size=32, max_text_length=16, text_embedding_dim=128, text_layers=2, text_heads=2,
    text_intermediate_dim=256, shared_embedding_dim=64, text_max_position=64,
    resnet_stages=(1, 1, 1, 1), resnet_width=8, flash_attention=True, dropout=0.0,
)
METRIC_TOL = 1e-6


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


@pytest.fixture(scope="module")
def models():
    vocab = build_dev_vocab(LABELS)
    cfg = dict(TINY, vocab_size=len(vocab))
    jmodel = JCXRClip(jconfig.ModelConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16), jnp.int32))
    rng = np.random.default_rng(21)
    variables = {"params": _fill(shapes["params"], rng),
                 "batch_stats": _fill(shapes["batch_stats"], rng)}
    model = CXRClip(config.ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return jmodel, variables, model.eval(), vocab


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """24 exams of grey PNGs (64 × 64 and 72 × 60, every filter type), one
    with a single view, one file that is not a PNG, some empty findings; the
    labeled CSV; a grey-packed cache at the model's 32 px, built by the
    port and read by both packages."""
    root = str(tmp_path_factory.mktemp("kaggle"))
    paths = write_kaggle_layout(root, 24, sizes=((64, 64), (72, 60)), empty_findings_every=5,
                                single_view_uids=(3,), not_png_uids=(7,))
    labeled = os.path.join(root, "labeled.csv")
    prepare_labeled_csv(paths["reports"], labeled)
    index = build_exam_index(read_csv(labeled), read_csv(paths["projections"]),
                             paths["image_dir"])
    cache = build_image_cache([p for pair in zip(index.frontal_paths, index.lateral_paths)
                               for p in pair], 32, os.path.join(root, "cache"), workers=2)
    assert cache.channels == 1
    jindex = jbuild_exam_index(pd.read_csv(labeled), pd.read_csv(paths["projections"]),
                               paths["image_dir"])
    return {"root": root, "dataset": ChestXrayMultiViewDataset(index, 32, cache=cache),
            "jdataset": JMultiView(jindex, 32, cache=JImageCache(os.path.join(root, "cache")))}


def _loaders(files, batch=5):
    return (HostLoader(files["dataset"], batch, num_threads=2),
            JHostLoader(files["jdataset"], batch, num_threads=2))


@pytest.fixture(scope="module")
def engines(models):
    jmodel, variables, model, vocab = models
    common = dict(image_size=32, max_text_length=16)
    jeng = JZeroShotEngine(jmodel, variables, JBertTokenizer(vocab), LABELS,
                           jconfig.ZeroShotConfig(), jconfig.CLIP_MEAN, jconfig.CLIP_STD,
                           compute_dtype=jnp.float32, **common)
    eng = ZeroShotEngine(model, BertTokenizer(vocab), LABELS, config.ZeroShotConfig(),
                         config.CLIP_MEAN, config.CLIP_STD, compute_dtype=torch.float32, **common)
    for e in (jeng, eng):
        e.build_text_features(prompts_for_family("prediction", LABELS))
    return jeng, eng


def _metrics_close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=METRIC_TOL, rtol=0, err_msg=k)


def test_loader_batches_reach_the_engine_as_jax_flattens_them(files, engines):
    """Grey-packed [B, 2, S, S, 1] batches: the engine flattens the views
    as JAX's does, logits within 1e-5 of JAX's."""
    jeng, eng = engines
    loader, jloader = _loaders(files)
    for batch, jbatch in zip(loader, jloader):
        assert batch["images"].shape == (5, 2, 32, 32, 1)
        np.testing.assert_array_equal(batch["images"], jbatch["images"])
        got = eng.logits(batch["images"])
        assert got.shape == (10, 16)
        np.testing.assert_allclose(got, eng.logits(batch["images"].reshape(10, 32, 32, 1)),
                                   atol=0, rtol=0)
        np.testing.assert_allclose(got, jeng.logits(jbatch["images"]), atol=1e-5, rtol=0)


def test_run_zero_shot_eval_matches_jax(files, engines, tmp_path):
    """Prediction sets identical, metrics within 1e-6, result CSVs equal
    under ``pd.read_csv``; the padded rows of the last batch dropped."""
    jeng, eng = engines
    loader, jloader = _loaders(files)
    got = run_zero_shot_eval(eng, loader, 3, str(tmp_path / "port" / "zs.csv"))
    want = jdriver.run_zero_shot_eval(jeng, jloader, 3, str(tmp_path / "jax" / "zs.csv"))
    assert len(got["predictions"]) == len(files["dataset"]) == 24
    assert got["predictions"] == want["predictions"]
    np.testing.assert_array_equal(got["pred_matrix"], want["pred_matrix"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    _metrics_close(got["metrics"], want["metrics"])
    pd.testing.assert_frame_equal(pd.read_csv(got["csv_path"]), pd.read_csv(want["csv_path"]))


def test_run_dynamic_threshold_eval_matches_jax(files, engines, tmp_path):
    """Thresholds within 1e-6, prediction sets identical, metrics and the
    per-class report within 1e-6, CSVs equal."""
    jeng, eng = engines
    loader, jloader = _loaders(files, batch=4)
    got = run_dynamic_threshold_eval(eng, lambda: iter(loader), 0.5, 20, 1.0, 0.8,
                                     str(tmp_path / "p.csv"))
    want = jdriver.run_dynamic_threshold_eval(jeng, lambda: iter(jloader), 0.5, 20, 1.0, 0.8,
                                              str(tmp_path / "j.csv"))
    assert got["thresholds"].keys() == want["thresholds"].keys()
    np.testing.assert_allclose(list(got["thresholds"].values()),
                               list(want["thresholds"].values()), atol=METRIC_TOL, rtol=0)
    assert got["predictions"] == want["predictions"]
    np.testing.assert_array_equal(got["pred_matrix"], want["pred_matrix"])
    _metrics_close(got["metrics"], want["metrics"])
    assert got["per_class"].keys() == want["per_class"].keys()
    for d in want["per_class"]:
        _metrics_close(got["per_class"][d], want["per_class"][d])
    pd.testing.assert_frame_equal(pd.read_csv(got["csv_path"]), pd.read_csv(want["csv_path"]))


def test_inference_session_matches_jax(files, models):
    """InferenceSession probabilities within 1e-4 of JAX's (bf16 prep on
    both sides, as JAX's session preps), predictions where no probability
    lies within that of the threshold."""
    jmodel, variables, model, vocab = models
    common = dict(mean=config.CLIP_MEAN, std=config.CLIP_STD, image_size=32,
                  max_text_length=16)
    session = inference.InferenceSession(model, BertTokenizer(vocab), **common)
    jsession = jinference.InferenceSession(jmodel, variables, JBertTokenizer(vocab), **common)
    np.testing.assert_allclose(session.text_features.numpy(),
                               np.asarray(jsession.text_features), atol=1e-5, rtol=0)
    batch = next(iter(_loaders(files)[0]))["images"]
    preds, probs = session(batch)
    jpreds, jprobs = jsession(batch)
    assert probs.shape == (5, 16)
    np.testing.assert_allclose(probs, jprobs, atol=1e-4, rtol=0)
    edge = np.abs(jprobs - 0.5) <= 1e-4
    np.testing.assert_array_equal(preds[~edge], jpreds[~edge])
    p2, q2 = inference.get_model_predictions(model, batch, BertTokenizer(vocab), **common)
    np.testing.assert_array_equal(q2, probs)


def test_session_scoring_through_b1_matches_jax(models):
    """The session's scoring alone, ``sigmoid(l2_normalize(fused) · textᵀ ·
    4)``, through B1's ``similarity`` at T = 1/4: within 1e-5 of JAX's on
    the same features, and B1's second normalization of the unit text rows
    moves it by less than that."""
    rng = np.random.default_rng(3)
    fused = rng.standard_normal((7, 64)).astype(np.float32) * 3
    text = np.array(jl2_normalize(jnp.asarray(rng.standard_normal((16, 64)), jnp.float32)))
    want = np.asarray(jax.nn.sigmoid(jl2_normalize(jnp.asarray(fused)) @ text.T * 4.0))
    got = torch.sigmoid(similarity(torch.from_numpy(fused), torch.from_numpy(text), 1 / 4.0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    once = torch.sigmoid(l2_normalize(torch.from_numpy(fused)) @ torch.from_numpy(text).T * 4.0)
    np.testing.assert_allclose(got.numpy(), once.numpy(), atol=1e-5, rtol=0)


def test_adapter_engine_matches_jax(files, models):
    """AdapterEngine on multi-view batches (flattened): probabilities within
    1e-4 of JAX's."""
    jmodel, variables, model, _ = models
    common = dict(mean=config.CLIP_MEAN, std=config.CLIP_STD, image_size=32)
    eng = inference.AdapterEngine(model, compute_dtype=torch.float32, **common)
    jeng = jinference.AdapterEngine(jmodel, variables, compute_dtype=jnp.float32, **common)
    batch = next(iter(_loaders(files)[0]))["images"]
    got = eng.probs(batch)
    assert got.shape == (10, 16)
    np.testing.assert_allclose(got, jeng.probs(batch), atol=1e-4, rtol=0)
    np.testing.assert_allclose(eng.probs(batch.reshape(10, 32, 32, 1)), got, atol=0, rtol=0)


def test_encode_multiview_matches_jax(models):
    jmodel, variables, model, _ = models
    x = np.random.default_rng(4).standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method="encode_multiview"))
    with torch.no_grad():
        got = model.encode_multiview(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("grid", [5, 20])
def test_thresholds_match_jax(grid):
    """The copy's thresholds within 1e-6 of the original's, with the
    no-positive and no-negative fallbacks."""
    rng = np.random.default_rng(grid)
    scores = rng.random((40, 16))
    labels = (rng.random((40, 16)) < 0.3).astype(np.float32)
    labels[:, 0], labels[:, 1] = 0, 1
    got = thresholds.search_thresholds(scores, labels, LABELS, grid)
    want = jthresholds.search_thresholds(scores, labels, LABELS, grid)
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-6, rtol=0)
    assert got[LABELS[0]] == 0.8 and got[LABELS[1]] == 0.2


def _defined(module):
    return sorted(n for n, o in vars(module).items()
                  if inspect.isfunction(o) and o.__module__ == module.__name__)


def test_copied_functions_equal_originals():
    """thresholds.py whole, and predict.py's merging functions, are the
    originals' source text; the driver's functions likewise but for the
    CSV writer."""
    for port, original, names in (
            (thresholds, jthresholds, _defined(jthresholds)),
            (predict, jpredict, ["merge_views_union_max", "merge_views_weighted",
                                 "predictions_to_matrix"]),
            (driver, jdriver, [n for n in _defined(jdriver) if n != "_write_csv"])):
        for name in names:
            assert inspect.getsource(getattr(port, name)) == inspect.getsource(
                getattr(original, name)), name
