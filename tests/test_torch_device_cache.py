"""The port's device-resident feed on the CPU: ``data/device_cache.py``
against the JAX package's, ``data/loader.py prefetch_to_device``, and the
CLI's ``--device-cache``, ``--bucket-text`` and ``--length-grouped`` on a
miniature Kaggle layout, in the CLI's tiny geometry and fp32 under
``CLIP_FOR_DL_TPU_FORCE_CPU``.

On the CPU a "device" tensor is a CPU tensor; what is held here is that a
batch gathered from the cache reaches the model as that tensor (never
through numpy) and scores bit-equal to the streamed batch. The card's half
is in ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 9.
"""

import contextlib
import csv
import importlib
import io
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from clip_for_dl_tpu.data import DeviceCacheBudgetError as JDeviceCacheBudgetError
from clip_for_dl_tpu.data import DeviceImageCache as JDeviceImageCache
from clip_for_dl_tpu.data import ImageCache as JImageCache
from clip_for_dl_tpu_torch.core.device import to_device
from clip_for_dl_tpu_torch.data import (
    ChestXrayMultiViewDataset,
    DeviceCacheBudgetError,
    DeviceFeedLoader,
    DeviceImageCache,
    ExamIndex,
    HostLoader,
    ImageCache,
    build_image_cache,
    device_memory_budget,
    prefetch_to_device,
)
from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
from clip_for_dl_tpu_torch.testing.png import write_png
from clip_for_dl_tpu_torch.text import BertTokenizer
from clip_for_dl_tpu_torch.zeroshot.engine import ZeroShotEngine

cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
engine_module = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.engine")

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """Ten grey PNGs (48 × 40) in a grey-packed cache at 32 px."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(10):
        p = str(d / f"CXR{i}_IM.png")
        write_png(p, rng.integers(10, 240, (48, 40), np.uint8))
        paths.append(p)
    cdir = str(tmp_path_factory.mktemp("cache") / "c")
    assert build_image_cache(paths, 32, cdir, workers=2).channels == 1
    return cdir, paths


# -- the cache ---------------------------------------------------------------------


@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [[0, 1], [2, -1]], [-1, -1], [9, 0, 5], []])
def test_gather_equals_jax(cache_dir, rows):
    """Rows in range and −1 (the zero image): the JAX cache's bytes, shape
    [*rows.shape, S, S, 1] uint8, on the cache's device."""
    cdir, _ = cache_dir
    rows = np.array(rows, np.int64)
    got = DeviceImageCache(ImageCache(cdir), device="cpu").gather(rows)
    want = np.asarray(JDeviceImageCache(JImageCache(cdir)).gather(rows))
    assert isinstance(got, torch.Tensor) and got.device == CPU and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (*rows.shape, 32, 32, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [[-2], [10], [[0, 10]], [3, -5, 1]])
def test_gather_refuses_rows_out_of_range(cache_dir, rows):
    """Below −1 or at or past the cache's length raises IndexError (the JAX
    gather clips such rows to the last one)."""
    cdir, _ = cache_dir
    with pytest.raises(IndexError, match=r"\[-1, 10\)"):
        DeviceImageCache(ImageCache(cdir), device="cpu").gather(np.array(rows))


def test_budget_gate_as_jax(cache_dir, monkeypatch):
    """CLIP_FOR_DL_TPU_HBM_BYTES overrides the budget in both packages; a
    set over half of it is refused by both."""
    cdir, _ = cache_dir
    assert device_memory_budget("cpu") > 2**30
    monkeypatch.setenv("CLIP_FOR_DL_TPU_HBM_BYTES", "2048")
    assert device_memory_budget("cpu") == 2048
    with pytest.raises(DeviceCacheBudgetError, match="budget"):
        DeviceImageCache(ImageCache(cdir), device="cpu")
    with pytest.raises(JDeviceCacheBudgetError, match="budget"):
        JDeviceImageCache(JImageCache(cdir))
    monkeypatch.setenv("CLIP_FOR_DL_TPU_HBM_BYTES", str(2 * 11 * 32 * 32))
    assert len(DeviceImageCache(ImageCache(cdir), device="cpu")) == 10


def test_device_feed_equals_the_streamed_loader(cache_dir):
    """HostLoader over image_rows=True exams, wrapped in DeviceFeedLoader:
    the streamed loader's bytes, as tensors, in the same order, a missing
    view and the padded tail as the zero image; len and the resume state
    delegate."""
    cdir, paths = cache_dir
    cache = ImageCache(cdir)
    index = ExamIndex(uids=np.arange(5), frontal_paths=paths[:5],
                      lateral_paths=paths[5:9] + [None],
                      labels=np.eye(16, dtype=np.float32)[:5], findings=["f"] * 5,
                      view_types=[("frontal", "lateral")] * 5)

    def loader(rows):
        ds = ChestXrayMultiViewDataset(index, 32, cache=cache, image_rows=rows)
        return HostLoader(ds, 2, shuffle=True, seed=3, num_threads=2)

    feed = DeviceFeedLoader(loader(True), DeviceImageCache(cache, device="cpu"))
    streamed = list(loader(False))
    fed = list(feed)
    assert len(feed) == len(fed) == len(streamed) == 3
    assert feed.state_dict() == {"epoch": 1, "step": 3}
    for a, b in zip(fed, streamed):
        assert isinstance(a["images"], torch.Tensor) and "images_rows" not in a
        np.testing.assert_array_equal(a["images"].numpy(), b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert not fed[-1]["images"][1].any()  # the padded sample


# -- prefetch_to_device ----------------------------------------------------------------


def _batches(n=5):
    rng = np.random.default_rng(0)
    return [{"images": rng.integers(0, 255, (2, 4, 4, 1), np.uint8),
             "labels": rng.random((2, 16)).astype(np.float32),
             "findings": ["a", "b"], "tensor": torch.full((2,), i)} for i in range(n)]


@pytest.mark.parametrize("threaded", [False, True])
def test_prefetch_to_device_moves_arrays_and_passes_the_rest(threaded):
    """Numpy entries become equal tensors on the device, in order; lists and
    tensors pass untouched; ``keys`` limits what moves; ``transform`` runs
    first."""
    batches = _batches()
    got = list(prefetch_to_device(iter(batches), device="cpu", threaded=threaded, depth=2))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        for k in ("images", "labels"):
            assert isinstance(g[k], torch.Tensor) and g[k].device == CPU
            np.testing.assert_array_equal(g[k].numpy(), b[k])
        assert g["findings"] is b["findings"] and g["tensor"] is b["tensor"]
    only = next(prefetch_to_device(iter(batches), device="cpu", keys=("labels",),
                                   transform=lambda b: {**b, "labels": b["labels"] * 2},
                                   threaded=threaded))
    assert isinstance(only["images"], np.ndarray)
    np.testing.assert_array_equal(only["labels"].numpy(), batches[0]["labels"] * 2)


def test_prefetch_to_device_reraises_the_producers_error():
    def failing():
        yield _batches(1)[0]
        raise OSError("disk gone")

    for threaded in (False, True):
        it = prefetch_to_device(failing(), device="cpu", threaded=threaded)
        with pytest.raises(OSError, match="disk gone"):
            list(it)


def test_prefetch_to_device_stops_its_producer_when_left():
    """A consumer that leaves a threaded prefetch early stops its producer
    thread (an endless source)."""
    def endless():
        while True:
            yield _batches(1)[0]

    before = threading.active_count()
    it = prefetch_to_device(endless(), device="cpu", threaded=True, depth=2)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


# -- the CLI's flags ----------------------------------------------------------------------


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    assert rc == 0, out.getvalue()[-2000:]
    return out.getvalue()


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """24 exams (64 × 64 and 72 × 60 grey PNGs, one single-view exam, one
    file that is not a PNG) through the port's prep and cache-images, and a
    pretrain checkpoint directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
        root = str(tmp_path_factory.mktemp("feed"))
        paths = write_kaggle_layout(os.path.join(root, "kaggle"), 24, sizes=((64, 64), (72, 60)),
                                    single_view_uids=(4,), not_png_uids=(6,))
        labeled = os.path.join(root, "labeled.csv")
        run(["prep", "--reports", paths["reports"], "--out", labeled,
             "--unlabeled-out", os.path.join(root, "unlabeled.csv")])
        cache = os.path.join(root, "cache")
        run(["cache-images", "--image-dir", paths["image_dir"], "--out", cache,
             "--image-size", "64", "--workers", "2"])
        flags = ["--tiny", "--fp32", "--reports-csv", labeled, "--projections-csv",
                 paths["projections"], "--image-dir", paths["image_dir"], "--image-cache", cache,
                 "--batch-size", "4"]
        pre = os.path.join(root, "pretrain")
        run(["pretrain", *flags, "--epochs", "1", "--checkpoint-dir", pre,
             "--log-dir", os.path.join(root, "logs")])
        yield {"root": root, "flags": flags, "pretrain": pre}


@contextlib.contextmanager
def fed_batches():
    """The tensors the device cache gathers, and every batch that reaches
    an engine's or a step's prep, as (object, data pointer)."""
    gathered, reached = [], []
    gather = DeviceImageCache.gather

    def record_gather(self, rows):
        out = gather(self, rows)
        gathered.append(out.data_ptr())
        return out

    def record_to_device(images, device):
        reached.append(images)
        out = to_device(images, device)
        assert not isinstance(images, torch.Tensor) or out is images
        return out

    with mock.patch.object(DeviceImageCache, "gather", record_gather), \
            mock.patch.object(engine_module, "to_device", record_to_device), \
            mock.patch("clip_for_dl_tpu_torch.inference.to_device", record_to_device):
        yield gathered, reached


def _zeroshot_logits(layout, tmp_path, *extra):
    got = []
    original = ZeroShotEngine._dispatch

    def record(self, images):
        out, n = original(self, images)
        got.append(out.clone())
        return out, n

    with mock.patch.object(ZeroShotEngine, "_dispatch", record):
        run(["zeroshot", *layout["flags"], "--checkpoint", layout["pretrain"],
             "--log-dir", str(tmp_path / "zs"), *extra])
    return torch.cat(got)


@pytest.mark.parametrize("dynamic", [False, True])
def test_zeroshot_device_cache_is_the_streamed_feed(layout, tmp_path, monkeypatch, dynamic):
    """zeroshot --device-cache: logits bit-equal to the streamed feed's,
    every batch reaching the engine a gathered tensor, untouched."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    extra = ["--dynamic"] if dynamic else []
    streamed = _zeroshot_logits(layout, tmp_path, *extra)
    with fed_batches() as (gathered, reached):
        cached = _zeroshot_logits(layout, tmp_path, "--device-cache", *extra)
    assert torch.equal(cached, streamed)
    assert reached and all(isinstance(x, torch.Tensor) for x in reached)
    assert {x.data_ptr() for x in reached} <= set(gathered)


def _eval_csv(layout, tmp_path, name, *extra):
    log = str(tmp_path / name)
    run(["eval", *layout["flags"], "--checkpoint", layout["pretrain"], "--log-dir", log,
         *extra])
    with open(os.path.join(log, "eval_predictions.csv"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("head", ["zeroshot", "adapter"])
def test_eval_device_cache_is_the_streamed_feed(layout, tmp_path, monkeypatch, head):
    """eval --device-cache: eval_predictions.csv byte-equal to the streamed
    feed's (the probabilities written exactly), every batch reaching the
    scorer a gathered tensor or its frontal view."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    streamed = _eval_csv(layout, tmp_path, "streamed", "--head", head)
    with fed_batches() as (gathered, reached):
        cached = _eval_csv(layout, tmp_path, "cached", "--head", head, "--device-cache")
    assert cached == streamed
    assert reached and all(isinstance(x, torch.Tensor) for x in reached)
    assert {x.data_ptr() for x in reached} <= set(gathered)


def _history(log):
    name = "training_history.csv" if os.path.exists(os.path.join(log, "training_history.csv")) \
        else "adapter_history.csv"
    with open(os.path.join(log, name), newline="") as f:
        return [{k: v for k, v in r.items() if k != "epoch_time"} for r in csv.DictReader(f)]


@pytest.mark.parametrize("command", ["pretrain", "adapter"])
def test_training_device_cache_is_the_streamed_feed(layout, tmp_path, monkeypatch, command):
    """pretrain and adapter --device-cache: the history's losses and rates
    equal the streamed feed's, and the adapter's predictions byte-equal."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    logs = {}
    for tag, extra in (("streamed", []), ("cached", ["--device-cache"])):
        logs[tag] = str(tmp_path / tag)
        ckpt = ["--checkpoint", layout["pretrain"]] if command == "adapter" else []
        run([command, *layout["flags"], "--epochs", "1", "--log-dir", logs[tag], *ckpt, *extra])
    assert _history(logs["cached"]) == _history(logs["streamed"])
    if command == "adapter":
        predictions = []
        for log in logs.values():
            with open(os.path.join(log, "adapter_predictions.csv"), "rb") as f:
                predictions.append(f.read())
        assert predictions[0] == predictions[1]


def test_device_cache_past_the_budget_streams(layout, tmp_path, monkeypatch, caplog):
    """Past the budget --device-cache warns and streams: the same CSV."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    streamed = _eval_csv(layout, tmp_path, "streamed")
    monkeypatch.setenv("CLIP_FOR_DL_TPU_HBM_BYTES", "1024")
    with fed_batches() as (gathered, _):
        assert _eval_csv(layout, tmp_path, "over", "--device-cache") == streamed
    assert not gathered and "streaming instead" in caplog.text


def test_device_cache_needs_the_image_cache_and_the_files(layout, tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    flags = [f for f in layout["flags"]]
    i = flags.index("--image-cache")
    del flags[i:i + 2]
    with pytest.raises(SystemExit, match="requires --image-cache"):
        cli.main(["zeroshot", *flags, "--device-cache", "--log-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="requires the real dataset"):
        cli.main(["zeroshot", "--tiny", "--synthetic", "--device-cache",
                  "--log-dir", str(tmp_path)])


def test_bucket_text_and_length_grouped_reach_pretrain(layout, tmp_path, monkeypatch):
    """pretrain --bucket-text --length-grouped --device-cache: the loader
    gets one token length a report, every batch is encoded bucketed, and
    the run ends; --length-grouped alone is refused."""
    monkeypatch.setenv("CLIP_FOR_DL_TPU_FORCE_CPU", "1")
    lengths, widths = [], []
    set_lengths, encode_bucketed = HostLoader.set_lengths, BertTokenizer.encode_bucketed

    def record_lengths(self, values):
        lengths.append(np.asarray(values))
        return set_lengths(self, values)

    def record_encode(self, texts, **kw):
        enc = encode_bucketed(self, texts, **kw)
        widths.append(enc["input_ids"].shape[1])
        return enc

    with mock.patch.object(HostLoader, "set_lengths", record_lengths), \
            mock.patch.object(BertTokenizer, "encode_bucketed", record_encode):
        out = run(["pretrain", *layout["flags"], "--epochs", "1", "--bucket-text",
                   "--length-grouped", "--device-cache", "--log-dir", str(tmp_path)])
    assert "pretrain done: 1 epochs" in out
    assert len(lengths) == 1 and lengths[0].min() > 2 and widths and set(widths) == {32}
    with pytest.raises(SystemExit, match="requires --bucket-text"):
        cli.main(["pretrain", *layout["flags"], "--length-grouped", "--log-dir",
                  str(tmp_path)])
