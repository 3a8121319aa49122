"""The port's data side from files (``data/``: labels, splits, exam index,
datasets, image cache, host loader, synthetic data) against the JAX
package's, on the same files.

The files are the Kaggle layout at 24 uids, written two ways: by
``tools/real_data_dryrun.py make_miniature_dataset`` (cv2 and pandas, grey
and RGB) and by the port's ``testing/kaggle.py`` (standard library, with
empty findings, a single-view exam and a file that is not a PNG). Every
comparison is exact: tables under ``pd.read_csv``, arrays and paths, cache
bytes, batches.
"""

import importlib.util
import json
import logging
import os
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split

from clip_for_dl_tpu.data import cache as jcache
from clip_for_dl_tpu.data import datasets as jdatasets
from clip_for_dl_tpu.data import labels as jlabels
from clip_for_dl_tpu.data import loader as jloader
from clip_for_dl_tpu.data import synthetic as jsynthetic
from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
from clip_for_dl_tpu_torch.data import (
    ChestXrayMultiViewDataset,
    Frame,
    HostLoader,
    ImageCache,
    build_exam_index,
    build_image_cache,
    datasets,
    frame_to_image_text_dataset,
    frame_to_multilabel_dataset,
    label_matrix,
    labels,
    length_grouped_order,
    merge_image_report,
    prepare_labeled_csv,
    read_csv,
    split_by_uid,
    split_reports,
    split_unlabeled,
    synthetic,
    term_frequency_table,
    write_csv,
)
from clip_for_dl_tpu_torch.data import loader as port_loader
from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout

REPO = Path(__file__).resolve().parent.parent


def _dryrun():
    spec = importlib.util.spec_from_file_location(
        "real_data_dryrun", REPO / "tools" / "real_data_dryrun.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["dryrun_rgb", "dryrun_grey", "port_writer"])
def layout(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    if request.param == "port_writer":
        paths = write_kaggle_layout(root, 24, sizes=((64, 64), (72, 60)), empty_findings_every=5,
                                    single_view_uids=(3,), not_png_uids=(7,))
    else:
        paths = _dryrun().make_miniature_dataset(root, 24, gray=request.param == "dryrun_grey")
    paths["root"] = root
    paths["labeled"] = prepare_labeled_csv(paths["reports"], os.path.join(root, "labeled.csv"))
    jlabels.prepare_labeled_csv(paths["reports"], os.path.join(root, "jlabeled.csv"))
    return paths


def _port(layout):
    return read_csv(os.path.join(layout["root"], "labeled.csv")), read_csv(layout["projections"])


def _jax(layout):
    return (pd.read_csv(os.path.join(layout["root"], "jlabeled.csv")),
            pd.read_csv(layout["projections"]))


def _frame_equal(frame: Frame, df: pd.DataFrame, tmp_path, ignore=()):
    """``frame`` written by the port reads back under pandas to ``df``."""
    path = write_csv(frame, str(tmp_path / "frame.csv"))
    got = pd.read_csv(path).drop(columns=list(ignore))
    pd.testing.assert_frame_equal(got, df.reset_index(drop=True).drop(columns=list(ignore)),
                                  check_dtype=False)


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------


def test_labeled_csv_reads_back_to_the_jax_frame(layout):
    """Same columns in the same order, same values; ``extracted_labels``
    joins a set (its order follows PYTHONHASHSEED in JAX too), so it is held
    as a set."""
    got = pd.read_csv(os.path.join(layout["root"], "labeled.csv"))
    want = pd.read_csv(os.path.join(layout["root"], "jlabeled.csv"))
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got.drop(columns="extracted_labels"),
                                  want.drop(columns="extracted_labels"))
    split = lambda s: set() if pd.isna(s) else set(s.split(", "))  # noqa: E731
    assert list(map(split, got["extracted_labels"])) == list(map(split, want["extracted_labels"]))
    np.testing.assert_array_equal(label_matrix(read_csv(os.path.join(layout["root"],
                                                                     "labeled.csv"))),
                                  jlabels.label_matrix(want))


@pytest.mark.parametrize("problems", [None, "", "normal", "Normal", "Cardiomegaly/mild",
                                      "Hernia, Hiatal;Pulmonary Emphysema", "Lung / hypo; Mass",
                                      "Airspace Disease;Calcified Granuloma;Opacity"])
def test_extract_labels_matches_jax(problems):
    want = jlabels.extract_labels(np.nan if problems is None else problems)
    got = labels.extract_labels(None if problems in (None, "") else problems)
    assert set(got.split(", ")) == set(want.split(", "))


def test_missing_problems_and_unlabeled_split_match_jax(tmp_path):
    """Empty Problems cells are NaN to pandas; the unlabeled CSV and the
    term table agree with JAX's."""
    raw = tmp_path / "raw.csv"
    raw.write_text("uid,Problems,findings\n1,normal,a\n2,,b\n3,Cardiomegaly;Lung,c\n"
                   "4,Opacity,\n5,Mass/large;Mass,e\n6,NA,f\n")
    port = prepare_labeled_csv(str(raw), str(tmp_path / "p.csv"), str(tmp_path / "pu.csv"))
    jax_frame = jlabels.prepare_labeled_csv(str(raw), str(tmp_path / "j.csv"),
                                            str(tmp_path / "ju.csv"))
    for a, b in (("p.csv", "j.csv"), ("pu.csv", "ju.csv")):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / a), pd.read_csv(tmp_path / b))
    assert [len(f) for f in split_unlabeled(port)] == [
        len(f) for f in jlabels.split_unlabeled(jax_frame)]
    terms = term_frequency_table(read_csv(str(raw)))
    want = jlabels.term_frequency_table(pd.read_csv(raw))
    assert [tuple(r.values()) for r in terms.rows] == list(want.itertuples(index=False,
                                                                           name=None))


# ---------------------------------------------------------------------------
# frames, splits, exam index
# ---------------------------------------------------------------------------


def test_merge_image_report_matches_jax(layout, tmp_path):
    reports, projections = _port(layout)
    jreports, jprojections = _jax(layout)
    _frame_equal(merge_image_report(projections, reports),
                 jdatasets.merge_image_report(jprojections, jreports), tmp_path,
                 ignore=("extracted_labels",))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 10, 24, 101])
@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.3, 0.5, 0.9])
def test_train_test_split_equals_sklearn(n, test_size):
    """Positions drawn as scikit-learn draws them, the ceiling included
    (n = 7 at 0.2: 2 to test)."""
    items = np.arange(100, 100 + n)
    try:
        want = train_test_split(items, test_size=test_size, random_state=42)
    except ValueError:
        with pytest.raises(ValueError):
            datasets._train_test_split(n, test_size, 42)
        return
    train, test = datasets._train_test_split(n, test_size, 42)
    np.testing.assert_array_equal(items[train], want[0])
    np.testing.assert_array_equal(items[test], want[1])


@pytest.mark.parametrize("seed", [0, 42])
def test_splits_match_jax(layout, tmp_path, seed):
    reports, projections = _port(layout)
    jreports, jprojections = _jax(layout)
    merged = merge_image_report(projections, reports)
    jmerged = jdatasets.merge_image_report(jprojections, jreports)
    for got, want in zip(split_by_uid(merged, 0.2, seed),
                         jdatasets.split_by_uid(jmerged, 0.2, seed)):
        _frame_equal(got, want, tmp_path, ignore=("extracted_labels",))
    for got, want in zip(split_reports(reports, 0.25, seed),
                         jdatasets.split_reports(jreports, 0.25, seed)):
        _frame_equal(got, want, tmp_path, ignore=("extracted_labels",))


def test_exam_index_matches_jax(layout):
    reports, projections = _port(layout)
    jreports, jprojections = _jax(layout)
    got = build_exam_index(reports, projections, layout["image_dir"])
    want = jdatasets.build_exam_index(jreports, jprojections, layout["image_dir"])
    assert got.uids.dtype == want.uids.dtype
    np.testing.assert_array_equal(got.uids, want.uids)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.float32
    assert (got.frontal_paths, got.lateral_paths, got.findings, got.view_types) == (
        want.frontal_paths, want.lateral_paths, want.findings, want.view_types)


def test_frame_datasets_match_jax(layout):
    reports, projections = _port(layout)
    jreports, jprojections = _jax(layout)
    merged = merge_image_report(projections, reports)
    jmerged = jdatasets.merge_image_report(jprojections, jreports)
    ml = frame_to_multilabel_dataset(merged, layout["image_dir"], 32, with_text=True)
    jml = jdatasets.frame_to_multilabel_dataset(jmerged, layout["image_dir"], 32,
                                                with_text=True)
    it = frame_to_image_text_dataset(merged, layout["image_dir"], 32)
    jit = jdatasets.frame_to_image_text_dataset(jmerged, layout["image_dir"], 32)
    assert len(ml) == len(jml) and len(it) == len(jit)
    for i in range(len(ml)):
        a, b = ml[i], jml[i]
        assert a["path"] == b["path"] and a["text"] == b["text"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_array_equal(a["image"], b["image"])
        assert it[i]["text"] == jit[i]["text"]
        np.testing.assert_array_equal(it[i]["image"], jit[i]["image"])


# ---------------------------------------------------------------------------
# image cache
# ---------------------------------------------------------------------------


def _all_paths(layout):
    reports, projections = _port(layout)
    index = build_exam_index(reports, projections, layout["image_dir"])
    return [p for pair in zip(index.frontal_paths, index.lateral_paths) for p in pair]


@pytest.mark.parametrize("channels", ["auto", "rgb"])
def test_cache_files_are_byte_equal_to_jax(layout, tmp_path, channels):
    """Data file and meta JSON byte for byte; each package opens the
    other's cache."""
    paths = _all_paths(layout)
    port = build_image_cache(paths, 48, str(tmp_path / "port"), workers=3, channels=channels)
    jax_cache = jcache.build_image_cache(paths, 48, str(tmp_path / "jax"), workers=3,
                                         channels=channels)
    for name in (jcache.META_NAME, jcache.DATA_NAME):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    gray = "grey" in layout["root"] or "port_writer" in layout["root"]
    assert port.channels == jax_cache.channels == (1 if gray and channels == "auto" else 3)
    cross_j, cross_p = jcache.ImageCache(str(tmp_path / "port")), ImageCache(str(tmp_path / "jax"))
    for p in paths:
        np.testing.assert_array_equal(cross_j.get(p), port.get(p))
        np.testing.assert_array_equal(cross_p.get(p), jax_cache.get(p))
        assert port.row(p) == jax_cache.row(p)


def test_cache_refuses_what_jax_refuses(layout, tmp_path):
    paths = _all_paths(layout)
    cache = build_image_cache(paths, 32, str(tmp_path / "c"), workers=2)
    with pytest.raises(ValueError, match="size"):
        ChestXrayMultiViewDataset(build_exam_index(*_port(layout), layout["image_dir"]), 48,
                                  cache=cache)
    other = tmp_path / "elsewhere" / os.path.basename(paths[0])
    other.parent.mkdir()
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="collision"):
        build_image_cache([paths[0], str(other)], 32, str(tmp_path / "d"))
    meta = json.loads((tmp_path / "c" / "cache_meta.json").read_text())
    (tmp_path / "c" / "cache_meta.json").write_text(json.dumps({**meta, "version": 9}))
    with pytest.raises(ValueError, match="version"):
        ImageCache(str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# the multi-view dataset and the host loader
# ---------------------------------------------------------------------------


def _datasets(layout, tmp_path, cached: bool):
    reports, projections = _port(layout)
    jreports, jprojections = _jax(layout)
    index = build_exam_index(reports, projections, layout["image_dir"])
    jindex = jdatasets.build_exam_index(jreports, jprojections, layout["image_dir"])
    cache = jcache_ = None
    if cached:
        paths = [p for pair in zip(index.frontal_paths, index.lateral_paths) for p in pair]
        cache = build_image_cache(paths, 40, str(tmp_path / "cache"), workers=2)
        jcache_ = jcache.ImageCache(str(tmp_path / "cache"))
    return (ChestXrayMultiViewDataset(index, 40, cache=cache),
            jdatasets.ChestXrayMultiViewDataset(jindex, 40, cache=jcache_))


def _batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert list(a[k]) == list(b[k]), k


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
def test_loader_batches_match_jax(layout, tmp_path, cached):
    """Padded final batch and its mask, shuffled epochs, and a mid-epoch
    resume from ``state_dict``, all equal to JAX's."""
    ds, jds = _datasets(layout, tmp_path, cached)
    kw = dict(batch_size=5, shuffle=True, seed=3, num_threads=2)
    loader, jl = HostLoader(ds, **kw), jloader.HostLoader(jds, **kw)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        _batches_equal(list(loader), list(jl))
    it, jit = iter(loader), iter(jl)
    first = [next(it), next(it)]
    jfirst = [next(jit), next(jit)]
    _batches_equal(first, jfirst)
    state = loader.state_dict()
    assert state == jl.state_dict() == {"epoch": 3, "step": 2}
    it.close()
    jit.close()
    resumed, jresumed = HostLoader(ds, **kw), jloader.HostLoader(jds, **kw)
    resumed.load_state_dict(state)
    jresumed.load_state_dict(state)
    rest = list(resumed)
    _batches_equal(rest, list(jresumed))
    assert rest[-1]["mask"].tolist() == [1.0] * (len(ds) % 5 or 5) + [0.0] * (-len(ds) % 5)


@pytest.mark.parametrize("kw", [dict(drop_last=True), dict(num_shards=3, shard_index=1,
                                                           pad_shards=True),
                                dict(num_shards=2, shard_index=0, even_shards=True)])
def test_loader_options_match_jax(layout, tmp_path, kw):
    ds, jds = _datasets(layout, tmp_path, False)
    _batches_equal(list(HostLoader(ds, batch_size=4, **kw)),
                   list(jloader.HostLoader(jds, batch_size=4, **kw)))


def test_length_grouped_order_and_pad_batch_match_jax():
    rng = np.random.default_rng(0)
    order, lengths = rng.permutation(37), rng.integers(1, 99, 37)
    np.testing.assert_array_equal(length_grouped_order(order, lengths, 4, 3),
                                  jloader.length_grouped_order(order, lengths, 4, 3))
    batch = {"images_rows": np.arange(6, dtype=np.int32).reshape(3, 2),
             "labels": np.ones((3, 16), np.float32), "findings": ["a", "b", "c"]}
    _batches_equal([port_loader._pad_batch(batch, 5, 3)], [jloader._pad_batch(batch, 5, 3)])


class _Stuck:
    """A dataset whose item 1 blocks until released."""

    def __init__(self):
        self.release = threading.Event()

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 1:
            self.release.wait(30)
        return {"x": np.full(2, i)}


def test_stuck_producer_is_reported_by_name(caplog):
    """The JAX ``_drain_producer`` leaves a producer that does not stop
    without a word; the port logs an error naming the thread."""
    ds = _Stuck()
    it = iter(HostLoader(ds, batch_size=1, num_threads=1, prefetch=1))
    assert next(it)["x"].tolist() == [[0, 0]]
    stop = threading.Event()
    thread = next(t for t in threading.enumerate() if t.name.startswith("HostLoader-producer"))
    try:
        with caplog.at_level(logging.ERROR, logger="clip_for_dl_tpu_torch.loader"):
            assert not port_loader._drain_producer(port_loader.Queue(), stop, thread,
                                                   timeout=0.05)
        assert thread.name in caplog.text and "did not stop" in caplog.text
    finally:
        ds.release.set()
        it.close()
    thread.join(5)
    assert not thread.is_alive()


def test_abandoned_epoch_stops_its_producer_quietly(caplog):
    ds = _Stuck()
    ds.release.set()
    it = iter(HostLoader(ds, batch_size=1, num_threads=1, prefetch=1))
    next(it)
    with caplog.at_level(logging.ERROR, logger="clip_for_dl_tpu_torch.loader"):
        it.close()
    assert not caplog.text
    time.sleep(0.05)
    assert not [t for t in threading.enumerate() if t.name.startswith("HostLoader-producer")]


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def test_synthetic_data_matches_jax(tmp_path):
    """The same draws give equal arrays, labels and report text."""
    for name in ("SyntheticMultiViewDataset", "SyntheticImageTextDataset",
                 "SyntheticImageLabelDataset"):
        got, want = getattr(synthetic, name)(6, 24, 3), getattr(jsynthetic, name)(6, 24, 3)
        _batches_equal([got[i] for i in range(6)], [want[i] for i in range(6)])
    _frame_equal(synthetic.synthetic_report_frame(20, 1),
                 jsynthetic.synthetic_report_frame(20, 1), tmp_path)
    _frame_equal(synthetic.synthetic_projection_frame(40, 2),
                 jsynthetic.synthetic_projection_frame(40, 2), tmp_path)
    assert DISEASE_LABELS == jsynthetic.DISEASE_LABELS
