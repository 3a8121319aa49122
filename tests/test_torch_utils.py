"""The port's utilities against the JAX package's, on the CPU: the plots and
CSV writers of ``utils/visualization.py`` (the same bytes; the port's tables
where JAX takes pandas frames), the zero-shot label and threshold helpers,
``count_params`` and the FLOP count, and the debug and profiling tools.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from clip_for_dl_tpu.models import CXRClip as JCXRClip
from clip_for_dl_tpu.utils import FaultInjector as JFaultInjector
from clip_for_dl_tpu.utils import assert_finite as jassert_finite
from clip_for_dl_tpu.utils import count_params as jcount_params
from clip_for_dl_tpu.utils import validate_batch as jvalidate_batch
from clip_for_dl_tpu.utils import visualization as jviz
from clip_for_dl_tpu.utils.mfu import mfu_fields as jmfu_fields
from clip_for_dl_tpu.zeroshot import predict as jpredict
from clip_for_dl_tpu.zeroshot import prompts as jprompts
from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, ModelConfig
from clip_for_dl_tpu_torch.data.frame import Frame
from clip_for_dl_tpu_torch.models import CXRClip, state_dict_from_jax
from clip_for_dl_tpu_torch.train.loop import History
from clip_for_dl_tpu_torch.utils import (
    FaultInjector,
    FencedTimer,
    StepTimer,
    annotate,
    assert_finite,
    count_params,
    debug_mode,
    deterministic_run,
    device_memory_stats,
    fence,
    throughput,
    trace,
    validate_batch,
)
from clip_for_dl_tpu_torch.utils import visualization as viz
from clip_for_dl_tpu_torch.utils.mfu import compiled_flops, mfu_fields, peak_tflops
from clip_for_dl_tpu_torch.zeroshot import (
    adjust_predictions_by_cooccurrence,
    frequency_thresholds,
    unique_problem_labels,
)
from clip_for_dl_tpu_torch.zeroshot.prompts import (
    analyze_disease_distribution,
    disease_cooccurrence,
)

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- the zero-shot helpers ---------------------------------------------------------

PROBLEMS = ["Cardiomegaly;Effusion", "normal", None, "Effusion; Nodule;Cardiomegaly",
            "Nodule", "Cardiomegaly", "Effusion;Cardiomegaly", "Mass;Nodule"] * 3


def _tables():
    """The same Problems column as a pandas frame (JAX) and a Frame (port)."""
    frame = Frame(["uid", "Problems"], [{"uid": str(i), "Problems": p}
                                        for i, p in enumerate(PROBLEMS)])
    return pd.DataFrame({"uid": range(len(PROBLEMS)), "Problems": PROBLEMS}), frame


def test_unique_problem_labels_matches_jax():
    want = jpredict.unique_problem_labels(pd.Series(PROBLEMS))
    assert unique_problem_labels(PROBLEMS) == want
    assert sorted(want) == ["Cardiomegaly", "Effusion", "Mass", "Nodule", "normal"]


@pytest.mark.parametrize("cutoff", [0, 4, 100])
def test_frequency_thresholds_match_jax(cutoff):
    df, frame = _tables()
    want = jpredict.frequency_thresholds(jprompts.analyze_disease_distribution(df), cutoff)
    assert frequency_thresholds(analyze_disease_distribution(frame), cutoff) == want


@pytest.mark.parametrize("min_count", [0, 5, 8])
def test_adjust_predictions_by_cooccurrence_matches_jax(min_count):
    """Single-prediction rows, a row with two, a row with none, and a
    disease the co-occurrence table lacks."""
    df, frame = _tables()
    diseases = ["Cardiomegaly", "Effusion", "Nodule", "Mass", "Pneumonia"]
    pred = np.zeros((6, 5), np.float32)
    pred[0, 0] = pred[1, 1] = pred[2, 2] = pred[3, 4] = 1.0
    pred[4, [0, 3]] = 1.0
    want = jpredict.adjust_predictions_by_cooccurrence(
        pred, jprompts.disease_cooccurrence(df), diseases, min_count)
    got = adjust_predictions_by_cooccurrence(pred, disease_cooccurrence(frame), diseases,
                                             min_count)
    np.testing.assert_array_equal(got, want)
    assert (got != pred).any() or min_count == 8


# -- the CSV writers and the plots ---------------------------------------------------


@pytest.mark.parametrize("paths", [False, True, "none_correct"])
def test_save_top_correct_csv_writes_the_jax_bytes(tmp_path, paths):
    rng = np.random.default_rng(0)
    probs = rng.random((12, 16)).astype(np.float32)
    labels = (rng.random((12, 16)) < 0.3).astype(np.float32)
    labels[np.arange(12), probs.argmax(1)] = np.arange(12) % 3 != 0
    if paths == "none_correct":
        labels[np.arange(12), probs.argmax(1)] = 0
    col = [f"img/{i}.png" for i in range(12)] if paths is True else None
    want = jviz.save_top_correct_csv(probs, labels, DISEASE_LABELS,
                                     str(tmp_path / "jax.csv"), col)
    got = viz.save_top_correct_csv(probs, labels, DISEASE_LABELS,
                                   str(tmp_path / "out" / "port.csv"), col)
    assert _bytes(got) == _bytes(want)


def _history():
    rows = [dict(epoch=e, train_loss=1.0 / (e + 1), val_loss=1.2 / (e + 1),
                 **{"lr/default": 1e-4 * 0.9 ** e, "lr/text_tower": 3e-5 * 0.5 ** e})
            for e in range(4)]
    rows[2]["val_loss"] = float("nan")
    del rows[3]["lr/text_tower"]
    history = History()
    for r in rows:
        history.append(**r)
    return history


def test_save_history_csv_writes_the_jax_bytes(tmp_path):
    """A NaN cell and a cell missing from the last row, both empty."""
    history = _history()
    want = jviz.save_history_csv(pd.DataFrame(history.rows), str(tmp_path / "jax.csv"))
    got = viz.save_history_csv(history, str(tmp_path / "port.csv"))
    assert _bytes(got) == _bytes(want)


def _plot_cases(rng):
    """name -> draw(module, path) of every plot, the same data to both."""
    history = _history()
    img = rng.random((24, 24, 1)).astype(np.float32)
    matrix = rng.integers(0, 20, (4, 4))
    counts = {"Effusion": 7, "Mass": 2, "Nodule": 11}
    runs = {"a": {"auroc": 0.7, "f1": 0.4}, "b": {"auroc": 0.8, "f1": 0.35}}
    sims = rng.random(12)
    texts = [f"prompt number {i}" for i in range(12)]
    images = rng.random((3, 16, 16)).astype(np.float32)
    preds = [["Mass", "Nodule"], ["Effusion"], ["normal"]]
    return {
        "display_image": lambda m, p: m.save_or_show_image(img, p, "a title"),
        "training_history": lambda m, p: m.plot_training_history(
            history if m is viz else pd.DataFrame(history.rows), p),
        "confusion_matrix": lambda m, p: m.plot_confusion_matrix(matrix, list("abcd"), p),
        "top_predictions": lambda m, p: m.visualize_top_predictions(
            img, ["Mass", "Nodule"], [0.9, 0.4], p),
        "distribution": lambda m, p: m.visualize_disease_distribution(counts, p),
        "metrics": lambda m, p: m.plot_metrics_comparison(runs, path=p),
        "similarity": lambda m, p: m.visualize_image_text_similarity(sims, texts, 5, p),
        "predictions": lambda m, p: m.visualize_predictions(images, preds, preds[::-1], p),
    }


@pytest.mark.parametrize("name", list(_plot_cases(np.random.default_rng(1))))
def test_plots_write_the_jax_pngs(tmp_path, name):
    """Each plot of the module writes the JAX module's PNG, byte for byte
    (the same matplotlib calls on the same data; the history from the
    port's History where JAX takes its DataFrame); without a path, the
    figure."""
    draw = _plot_cases(np.random.default_rng(1))[name]
    want = draw(jviz, str(tmp_path / "jax" / f"{name}.png"))
    got = draw(viz, str(tmp_path / "port" / f"{name}.png"))
    assert got.endswith(f"port/{name}.png") and _bytes(got) == _bytes(want)
    fig = draw(viz, None)
    assert hasattr(fig, "savefig")
    viz._plt().close(fig)


# -- count_params and the FLOP count --------------------------------------------------


def test_count_params_matches_jax_on_converted_weights():
    """The port model's parameters against the JAX params, and the
    converted state dict's arrays against all the JAX variables (BatchNorm
    statistics are buffers in the port: counted in the state dict, not
    among the parameters)."""
    cfg = dict(image_size=32, max_text_length=8, vocab_size=64, text_embedding_dim=16,
               text_layers=1, text_heads=2, text_intermediate_dim=32,
               shared_embedding_dim=32, text_max_position=16, resnet_stages=(1, 1, 1, 1),
               resnet_width=8)
    from clip_for_dl_tpu.core.config import ModelConfig as JModelConfig

    shapes = jax.eval_shape(JCXRClip(JModelConfig(**cfg)).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8), jnp.int32))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = CXRClip(ModelConfig(**cfg))
    model.load_state_dict(sd, strict=True)
    assert count_params(model) == jcount_params(variables["params"]) > 0
    # torch's BatchNorm also keeps a step counter, which JAX has none of
    arrays = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert count_params(arrays) == jcount_params(variables)
    assert count_params([{"a": np.zeros((2, 3))}, (torch.zeros(4),)]) == 10


@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (128, 256, 8)])
def test_compiled_flops_of_a_matmul_matches_jax(m, k, n):
    """One [m, k] @ [k, n]: PyTorch's count equals XLA's cost_analysis flops
    for the same dot (2·m·n·k); the fields carry the JAX keys."""
    a, b = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    compiled = jax.jit(jnp.dot).lower(a, b).compile()
    want = compiled.cost_analysis()
    want = float((want[0] if isinstance(want, (list, tuple)) else want)["flops"])
    flops = compiled_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert flops == want == 2.0 * m * n * k
    got = mfu_fields(flops, 4, 100.0)
    assert got == {k: v for k, v in jmfu_fields(compiled, 4, 100.0).items() if k != "mfu_pct"}
    assert compiled_flops(torch.add, torch.ones(3), torch.ones(3)) is None
    assert mfu_fields(None, 4, 1.0) == {}
    assert peak_tflops() is None  # no card here


# -- debug and profiling ------------------------------------------------------------


def test_assert_finite_names_the_leaf_as_jax_does():
    tree = {"params": {"w": np.ones((2, 2), np.float32),
                       "b": np.array([1.0, np.nan, np.inf], np.float32)},
            "step": np.array(3)}
    with pytest.raises(FloatingPointError) as jerr:
        jassert_finite(tree, "state")
    with pytest.raises(FloatingPointError) as err:
        assert_finite({"params": {"w": torch.ones(2, 2, dtype=torch.bfloat16),
                                  "b": torch.from_numpy(tree["params"]["b"])},
                       "step": torch.tensor(3)}, "state")
    assert str(err.value) == str(jerr.value) == "non-finite values in state:params/b (nan=1, inf=1)"
    assert_finite([torch.ones(3), np.zeros(2)])


@pytest.mark.parametrize("batch,kw", [
    ({"images": np.zeros((4, 8, 8, 3), np.uint8), "labels": np.zeros((4, 16))}, {}),
    ({"images": np.zeros((4, 8, 8, 3), np.uint8)}, {"batch_size": 2}),
    ({"images": np.full((2, 4), np.nan, np.float32)}, {}),
    ({"labels": np.zeros((4, 15))}, {}),
    ({"labels": np.full((4, 16), 0.5)}, {}),
    ({"images": np.zeros((4, 2)), "mask": np.ones(3)}, {}),
], ids=["ok", "batch_size", "nan", "label_dim", "binary", "mask"])
def test_validate_batch_as_jax(batch, kw):
    """The same verdict and message as JAX, for numpy and torch batches."""
    try:
        jvalidate_batch(batch, **kw)
        want = None
    except ValueError as exc:
        want = str(exc)
    for b in (batch, {k: torch.from_numpy(v) for k, v in batch.items()}):
        if want is None:
            validate_batch(b, **kw)
        else:
            with pytest.raises(ValueError) as err:
                validate_batch(b, **kw)
            assert str(err.value) == want


@pytest.mark.parametrize("mode", ["drop", "nan", "zero"])
def test_fault_injector_as_jax(mode):
    batches = [{"images": np.full((2, 3), i, np.uint8), "labels": np.zeros((2, 16))}
               for i in range(4)]
    seen, jseen = [], []
    got = list(FaultInjector(batches, (1, 3), mode, lambda i, m: seen.append((i, m))))
    want = list(JFaultInjector(batches, (1, 3), mode, lambda i, m: jseen.append((i, m))))
    assert seen == jseen == [(1, mode), (3, mode)] and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
    assert batches[1]["images"][0, 0] == 1  # the loader's batches untouched


def test_deterministic_run_pins_and_restores_the_generators():
    np.random.seed(123)
    torch.manual_seed(123)
    before = np.random.random(), torch.rand(1)
    np.random.seed(123)
    torch.manual_seed(123)
    with deterministic_run(7) as gen:
        a = np.random.random(), torch.rand(1), torch.rand(1, generator=gen)
    with deterministic_run(7) as gen:
        b = np.random.random(), torch.rand(1), torch.rand(1, generator=gen)
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    after = np.random.random(), torch.rand(1)
    assert after[0] == before[0] and torch.equal(after[1], before[1])


def test_debug_mode_detects_a_nan_made_by_a_backward():
    x = torch.zeros(2, requires_grad=True)
    with debug_mode(), pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x * x).sum().backward()
    with debug_mode(nans=False):
        torch.sqrt(x * x).sum().backward()  # NaN gradient, no error
    assert torch.isnan(x.grad).all()


def test_profiling_tools_on_the_cpu(tmp_path):
    tree = {"a": [torch.ones(2), (np.zeros(1), 3)]}
    assert fence(tree) is tree
    with FencedTimer(tree) as t:
        pass
    assert t.seconds >= 0.0
    assert throughput(10, 2.0) == 5.0 and throughput(1, 0.0) > 0
    timer = StepTimer(window=2)
    assert np.isnan(timer.mean_step_seconds) and np.isnan(timer.items_per_sec(8))
    for _ in range(4):
        timer.tick()
    assert len(timer.times) == 2 and timer.items_per_sec(8) > 0
    assert device_memory_stats() == {}  # no card here, as JAX's CPU devices report none
    with trace(str(tmp_path / "trace")):
        with annotate("region"):
            torch.ones(8) @ torch.ones(8)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert '"region"' in (tmp_path / "trace" / files[0]).read_text()
