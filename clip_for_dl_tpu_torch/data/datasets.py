"""Indiana-CXR datasets: multi-view exams, image-text pairs, image-label
pairs (counterpart of ``clip_for_dl_tpu.data.datasets``, on ``data/frame.py``
tables instead of dataframes).

The host side stays thin (decode bytes → fixed-size uint8 arrays); resize to
the model's input, normalization and augmentation run on the card (kernel
B2). Batching is an index-sliced numpy assembly driven by ``data/loader.py``.

Reference behaviors preserved:
- merge reports × projections on uid, frontal/lateral picked by substring
  match on the projection column, a single view duplicated, zero images when
  a view is missing or fails to decode (0425/prepare_data.py:92-180);
- the notebook's flat image-report merge: reports with ≥ 1 label, inner-join
  projections, drop empty reports (02 nb cell 9);
- splits: grouped-uid and report-level ``train_test_split(seed 42)`` (02 nb
  cell 12; 0425/prepare_data.py:224-228), reproduced on numpy's
  ``RandomState`` as scikit-learn draws it.

Files: the JAX package decodes PNG with its native runtime and every other
format with ``cv2.imread`` then ``cv2.resize``; the port decodes PNG, JPEG,
BMP, TIFF and Netpbm to the same bytes (``native.decode_image``) and
resizes all of them with its one ``resize_u8``, which equals cv2.resize at
downscaling and is within 1 of it at upscaling (ROADMAP, "Reference behaviour not copied").
A format cv2 reads that the port does not (``native.unported_format``:
WebP, JPEG 2000, ...) raises, naming ROADMAP A2c. The whole Indiana set is PNG (``*.dcm.png``); MIMIC-CXR-JPG and
CheXpert ship JPEG.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import DISEASE_LABELS
from ..native import bindings as native
from .frame import Frame, key, merge, number, rename, unique
from .labels import label_matrix


def load_image(path: str, image_size: Optional[int] = None) -> np.ndarray:
    """Decode to RGB uint8 HWC, resized on the host only if ``image_size``
    is given; the zero image (``image_size`` or 224 square) when the file
    cannot be read or decoded. Any other error propagates, the refusal of
    a format the port does not decode (``native.UnportedFormat``) too."""
    size = image_size or 224
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        data = None
    img = native.decode_image(data, file=True) if data is not None else None
    if img is None:
        return np.zeros((size, size, 3), np.uint8)
    if image_size is not None:
        img = native.resize_u8(img, image_size, image_size)
    return img


# ---------------------------------------------------------------------------
# frame construction + splits
# ---------------------------------------------------------------------------


def _labeled(row) -> bool:
    return sum(number(row[c]) for c in DISEASE_LABELS) > 0


def merge_image_report(projections: Frame, reports: Frame) -> Frame:
    """The notebook's flat frame: labeled reports ⋈ projections, one row per
    image, empty reports dropped (02 nb cell 9)."""
    merged = merge(projections, reports.where(_labeled), on="uid")
    merged = rename(merged, {"filename": "image_path", "findings": "report"})
    return merged.where(lambda r: r["report"] is not None)


def _train_test_split(n: int, test_size: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions as ``sklearn.model_selection.train_test_split
    (..., test_size, random_state=seed)`` draws them: a ``RandomState(seed)``
    permutation, the first ceil(test_size · n) positions to test and the
    next n − that to train."""
    n_test = math.ceil(test_size * n) if isinstance(test_size, float) else int(test_size)
    n_train = n - n_test
    if n_test <= 0 or n_train <= 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size}, the train or test "
                         "set would be empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def split_by_uid(frame: Frame, test_size: float = 0.2, seed: int = 42) -> Tuple[Frame, Frame]:
    """Grouped-uid split: a patient's images never straddle the split. Rows
    keep their order."""
    uids = unique(key(u) for u in frame.column("uid"))
    train_idx, test_idx = _train_test_split(len(uids), test_size, seed)
    train_uids = {uids[i] for i in train_idx}
    test_uids = {uids[i] for i in test_idx}
    return (frame.where(lambda r: key(r["uid"]) in train_uids),
            frame.where(lambda r: key(r["uid"]) in test_uids))


def split_reports(reports: Frame, test_size: float = 0.2, seed: int = 42) -> Tuple[Frame, Frame]:
    """Script-semantics split of the reports, rows in the drawn order."""
    train_idx, test_idx = _train_test_split(len(reports), test_size, seed)
    return (Frame(list(reports.columns), [reports.rows[i] for i in train_idx]),
            Frame(list(reports.columns), [reports.rows[i] for i in test_idx]))


# ---------------------------------------------------------------------------
# exam index (multi-view)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExamIndex:
    """Flat arrays for one exam per row — all table work done up front so
    the per-item path is pure array indexing."""

    uids: np.ndarray  # [N]
    frontal_paths: List[Optional[str]]  # None = missing view
    lateral_paths: List[Optional[str]]
    labels: np.ndarray  # [N, 16] float32
    findings: List[str]
    view_types: List[Tuple[str, str]]

    def __len__(self) -> int:
        return len(self.uids)


def build_exam_index(
    reports: Frame,
    projections: Frame,
    image_dir: str = "",
    label_columns: Sequence[str] = DISEASE_LABELS,
) -> ExamIndex:
    """Group merged rows by uid (first appearance order); pick the first
    frontal and first lateral by substring match; record the
    duplication/blank policy in view_types."""
    exams: Dict[object, List[dict]] = {}
    for row in merge(reports, projections, on="uid").rows:
        exams.setdefault(key(row["uid"]), []).append(row)
    uids, frontals, laterals, labels, findings, vtypes = [], [], [], [], [], []
    for uid, exam in exams.items():
        row = exam[0]
        f_rows = [r for r in exam if "frontal" in str(r["projection"]).lower()]
        l_rows = [r for r in exam if "lateral" in str(r["projection"]).lower()]
        fp = os.path.join(image_dir, f_rows[0]["filename"]) if f_rows else None
        lp = os.path.join(image_dir, l_rows[0]["filename"]) if l_rows else None
        if fp is None and lp is None:
            vt = ("unknown", "unknown")
        elif fp is None:
            fp, vt = lp, ("lateral", "lateral")  # duplicate the single view
        elif lp is None:
            lp, vt = fp, ("frontal", "frontal")
        else:
            vt = ("frontal", "lateral")
        uids.append(uid)
        frontals.append(fp)
        laterals.append(lp)
        labels.append([number(row[c]) for c in label_columns])
        text = row.get("findings")
        findings.append("" if text is None else str(text))
        vtypes.append(vt)
    return ExamIndex(
        uids=np.asarray(uids),
        frontal_paths=frontals,
        lateral_paths=laterals,
        labels=np.asarray(labels, np.float32).reshape(len(uids), len(label_columns)),
        findings=findings,
        view_types=vtypes,
    )


def _check_cache(cache, image_size: int):
    """A cache built at a different size would silently feed wrong-scale
    pixels — reject at construction, not per item."""
    if cache is not None and cache.image_size != image_size:
        raise ValueError(
            f"image cache was built at size {cache.image_size}, dataset "
            f"wants {image_size} — rebuild it with build_image_cache"
        )
    return cache


def _cache_channels(cache) -> int:
    """1 when the cache is grayscale-packed (see data/cache.py), else 3.
    Every item a dataset emits uses this count so batches stack."""
    return getattr(cache, "channels", 3) if cache is not None else 3


def _check_image_rows(image_rows: bool, cache):
    """image_rows=True (the device-resident cache path) emits cache ROW
    INDICES instead of pixels — meaningless without a cache to index."""
    if image_rows and cache is None:
        raise ValueError("image_rows=True requires an image cache")
    return bool(image_rows)


def _row_ref(cache, path: Optional[str]) -> np.int32:
    """Cache row index for `path` (−1 = the missing-view zero image slot).
    Rows mode cannot fall back to a live decode — an uncached file fails
    loudly instead of silently feeding wrong rows."""
    if path is None:
        return np.int32(-1)
    row = cache.row(path)
    if row is None:
        raise KeyError(
            f"{path}: not in the image cache — the device-resident cache "
            "path (image_rows) needs full coverage; rebuild the cache over "
            "every dataset path"
        )
    return np.int32(row)


def _cached_load(cache, path: str, image_size: int) -> np.ndarray:
    if cache is not None:
        img = cache.get(path)
        if img is not None:
            return img
        if cache.channels == 1:
            # Straggler not in a gray-packed cache: live decode, keep
            # channel 0 (== the gray value for grayscale sources). A color
            # straggler cannot be represented in a gray-packed batch;
            # dropping two channels would be silent data corruption.
            img = load_image(path, image_size)
            if not (
                np.array_equal(img[..., 0], img[..., 1])
                and np.array_equal(img[..., 0], img[..., 2])
            ):
                raise ValueError(
                    f"{path}: color image fed through a grayscale-packed "
                    "image cache (its channels differ) — rebuild the cache "
                    "so this file gets the RGB layout"
                )
            return img[..., :1]
    return load_image(path, image_size)


class ChestXrayMultiViewDataset:
    """Exam-level dataset: (images [2, S, S, C] uint8, labels [16],
    findings str, view_types) — NHWC, the card does the rest. C is 3, or 1
    when fed from a grayscale-packed cache (the prep broadcasts back to 3
    on the card, bit-identically)."""

    def __init__(self, index: ExamIndex, image_size: int = 224, cache=None,
                 image_rows: bool = False):
        self.index = index
        self.image_size = image_size
        self.cache = _check_cache(cache, image_size)
        self.channels = _cache_channels(self.cache)
        self.image_rows = _check_image_rows(image_rows, cache)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Dict:
        s = self.image_size
        paths = (self.index.frontal_paths[i], self.index.lateral_paths[i])
        out = {
            "labels": self.index.labels[i],
            "findings": self.index.findings[i],
            "view_types": self.index.view_types[i],
        }
        if self.image_rows:
            out["images_rows"] = np.stack([_row_ref(self.cache, p) for p in paths])
            return out
        views = []
        for path in paths:
            if path is None:
                views.append(np.zeros((s, s, self.channels), np.uint8))
            else:
                views.append(_cached_load(self.cache, path, s))
        out["images"] = np.stack(views)
        return out


class ImageTextDataset:
    """(image uint8 HWC, report text) pairs — CLIP pretraining (02 nb cell 16)."""

    def __init__(
        self,
        image_paths: Sequence[str],
        texts: Sequence[str],
        image_size: int = 224,
        cache=None,
        image_rows: bool = False,
    ):
        if len(image_paths) != len(texts):
            raise ValueError(f"{len(image_paths)} image paths for {len(texts)} texts")
        self.image_paths = list(image_paths)
        self.texts = list(texts)
        self.image_size = image_size
        self.cache = _check_cache(cache, image_size)
        self.channels = _cache_channels(self.cache)
        self.image_rows = _check_image_rows(image_rows, cache)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> Dict:
        if self.image_rows:
            return {"image_rows": _row_ref(self.cache, self.image_paths[i]),
                    "text": self.texts[i]}
        return {"image": _cached_load(self.cache, self.image_paths[i], self.image_size),
                "text": self.texts[i]}


class ImageMultiLabelDataset:
    """(image uint8 HWC, labels [16], path) — adapter training / eval
    (02 nb cell 28; the 03-nb variant also carries the report text)."""

    def __init__(
        self,
        image_paths: Sequence[str],
        labels: np.ndarray,
        image_size: int = 224,
        texts: Optional[Sequence[str]] = None,
        cache=None,
        image_rows: bool = False,
    ):
        if len(image_paths) != len(labels):
            raise ValueError(f"{len(image_paths)} image paths for {len(labels)} label rows")
        self.image_paths = list(image_paths)
        self.labels = np.asarray(labels, np.float32)
        self.image_size = image_size
        self.texts = list(texts) if texts is not None else None
        self.cache = _check_cache(cache, image_size)
        self.channels = _cache_channels(self.cache)
        self.image_rows = _check_image_rows(image_rows, cache)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> Dict:
        out = {"labels": self.labels[i], "path": self.image_paths[i]}
        if self.image_rows:
            out["image_rows"] = _row_ref(self.cache, self.image_paths[i])
        else:
            out["image"] = _cached_load(self.cache, self.image_paths[i], self.image_size)
        if self.texts is not None:
            out["text"] = self.texts[i]
        return out


def frame_to_multilabel_dataset(
    frame: Frame, image_dir: str = "", image_size: int = 224,
    with_text: bool = False, cache=None, image_rows: bool = False,
) -> ImageMultiLabelDataset:
    paths = [os.path.join(image_dir, p) for p in frame.column("image_path")]
    texts = frame.column("report") if with_text else None
    return ImageMultiLabelDataset(paths, label_matrix(frame), image_size, texts, cache,
                                  image_rows)


def frame_to_image_text_dataset(
    frame: Frame, image_dir: str = "", image_size: int = 224,
    cache=None, image_rows: bool = False,
) -> ImageTextDataset:
    paths = [os.path.join(image_dir, p) for p in frame.column("image_path")]
    return ImageTextDataset(paths, frame.column("report"), image_size, cache, image_rows)
