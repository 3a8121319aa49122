"""Multi-label metric suite (copy of ``clip_for_dl_tpu.evals.metrics``).

The JAX package's module is numpy only, so it is copied here unchanged, body
for body: every function and class has its original's source text
(``tests/test_torch_phase_b.py`` holds them equal), and the phase-C metric
suite (``multilabel_metrics``, ``macro_auroc``, ...) runs on the GPU
machine, which has no JAX. Semantics are sklearn's (checked there against
sklearn in ``tests/test_metrics.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x)


# ---------------------------------------------------------------------------
# binary-prediction metrics
# ---------------------------------------------------------------------------


def sample_accuracy(pred: np.ndarray, true: np.ndarray) -> float:
    """Mean over samples of the per-sample fraction of correct labels (%)."""
    return float((_np(pred) == _np(true)).mean(axis=1).mean() * 100.0)


def label_accuracy(pred: np.ndarray, true: np.ndarray) -> float:
    return float((_np(pred) == _np(true)).mean(axis=0).mean() * 100.0)


def hamming_score(pred: np.ndarray, true: np.ndarray) -> float:
    return float((_np(pred) == _np(true)).mean() * 100.0)


def hamming_loss(pred: np.ndarray, true: np.ndarray) -> float:
    return float((_np(pred) != _np(true)).mean())


def exact_match(pred: np.ndarray, true: np.ndarray) -> float:
    return float((_np(pred) == _np(true)).all(axis=1).mean())


def jaccard_example_accuracy(pred: np.ndarray, true: np.ndarray) -> float:
    """Example-based Jaccard: |p∩t| / |p∪t| per sample (1 when both empty),
    averaged — the notebook's headline 'accuracy' 0.4473."""
    pred, true = _np(pred).astype(bool), _np(true).astype(bool)
    inter = (pred & true).sum(axis=1)
    union = (pred | true).sum(axis=1)
    return float(np.where(union == 0, 1.0, inter / np.maximum(union, 1)).mean())


def _prf_per_class(pred: np.ndarray, true: np.ndarray):
    pred, true = _np(pred).astype(bool), _np(true).astype(bool)
    tp = (pred & true).sum(axis=0).astype(np.float64)
    fp = (pred & ~true).sum(axis=0).astype(np.float64)
    fn = (~pred & true).sum(axis=0).astype(np.float64)
    prec = np.divide(tp, tp + fp, out=np.zeros_like(tp), where=(tp + fp) > 0)
    rec = np.divide(tp, tp + fn, out=np.zeros_like(tp), where=(tp + fn) > 0)
    denom = prec + rec
    f1 = np.divide(2 * prec * rec, denom, out=np.zeros_like(tp), where=denom > 0)
    support = true.sum(axis=0)
    return prec, rec, f1, tp, fp, fn, support


def f1_scores(pred: np.ndarray, true: np.ndarray) -> Dict[str, float]:
    """macro / micro / weighted / samples F1 (sklearn semantics)."""
    prec, rec, f1, tp, fp, fn, support = _prf_per_class(pred, true)
    micro_p = tp.sum() / max(tp.sum() + fp.sum(), 1e-12)
    micro_r = tp.sum() / max(tp.sum() + fn.sum(), 1e-12)
    micro = (
        2 * micro_p * micro_r / (micro_p + micro_r)
        if micro_p + micro_r > 0
        else 0.0
    )
    weighted = (
        float((f1 * support).sum() / support.sum()) if support.sum() else 0.0
    )
    # samples-F1
    p, t = _np(pred).astype(bool), _np(true).astype(bool)
    inter = (p & t).sum(axis=1).astype(np.float64)
    denom = p.sum(axis=1) + t.sum(axis=1)
    sf1 = np.where(denom == 0, 0.0, 2 * inter / np.maximum(denom, 1))
    return {
        "f1_macro": float(f1.mean()),
        "f1_micro": float(micro),
        "f1_weighted": weighted,
        "f1_samples": float(sf1.mean()),
    }


def per_class_report(
    pred: np.ndarray, true: np.ndarray, class_names: Sequence[str]
) -> Dict[str, Dict[str, float]]:
    prec, rec, f1, *_, support = _prf_per_class(pred, true)
    return {
        name: {
            "precision": float(prec[i]),
            "recall": float(rec[i]),
            "f1": float(f1[i]),
            "support": int(support[i]),
        }
        for i, name in enumerate(class_names)
    }


# ---------------------------------------------------------------------------
# score-based (ranking) metrics
# ---------------------------------------------------------------------------


def top_k_accuracy(scores: np.ndarray, true: np.ndarray, k: int) -> float:
    """Fraction of samples whose top-k scored classes include ≥1 true label
    (0425/train.py top-1/top-3; 02 nb cell 42 'soft accuracy' for k=1)."""
    scores, true = _np(scores), _np(true).astype(bool)
    topk = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    hit = np.take_along_axis(true, topk, axis=1).any(axis=1)
    valid = true.any(axis=1)
    return float(hit[valid].mean()) if valid.any() else 0.0


def top1_per_label_counts(
    scores: np.ndarray, true: np.ndarray
) -> Dict[int, Dict[str, int]]:
    """Per-label tally of correct top-1 predictions (02 nb cell 42's
    per-label correct counts): for each class c, how often it was the top-1
    prediction and that prediction was in the true set."""
    scores, true = _np(scores), _np(true).astype(bool)
    top1 = np.argmax(scores, axis=1)
    out: Dict[int, Dict[str, int]] = {}
    for c in range(scores.shape[1]):
        sel = top1 == c
        out[c] = {
            "predicted": int(sel.sum()),
            "correct": int((sel & true[:, c]).sum()),
        }
    return out


def average_precision(scores: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Per-class AP with sklearn's step-interpolation-free definition."""
    scores, true = _np(scores).astype(np.float64), _np(true).astype(bool)
    n_classes = scores.shape[1]
    aps = np.zeros(n_classes)
    for c in range(n_classes):
        y, s = true[:, c], scores[:, c]
        if not y.any():
            aps[c] = 0.0
            continue
        order = np.argsort(-s, kind="mergesort")
        y_sorted = y[order]
        s_sorted = s[order]
        tp_cum = np.cumsum(y_sorted)
        ranks = np.arange(1, len(y) + 1)
        precision = tp_cum / ranks
        recall = tp_cum / y.sum()
        # collapse tied scores to the last index of each tie block (sklearn)
        distinct = np.where(np.diff(s_sorted))[0]
        idx = np.r_[distinct, len(s_sorted) - 1]
        prec_at = precision[idx]
        rec_at = recall[idx]
        aps[c] = float(np.sum(np.diff(np.r_[0.0, rec_at]) * prec_at))
    return aps


def mean_average_precision(scores: np.ndarray, true: np.ndarray) -> float:
    """macro mAP over classes with ≥1 positive (sklearn macro behavior keeps
    zero-positive classes as 0 contributions — we mirror sklearn by averaging
    over all classes)."""
    return float(average_precision(scores, true).mean())


def lrap(scores: np.ndarray, true: np.ndarray) -> float:
    """Label-ranking average precision (sklearn definition, ties handled)."""
    scores, true = _np(scores).astype(np.float64), _np(true).astype(bool)
    n, c = scores.shape
    out = np.zeros(n)
    for i in range(n):
        y, s = true[i], scores[i]
        if not y.any() or y.all():
            out[i] = 1.0
            continue
        relevant = np.flatnonzero(y)
        score_i = 0.0
        for r in relevant:
            # rank among all labels: # scores >= s[r] (ties averaged via >=)
            rank = (s >= s[r]).sum()
            l_rank = (s[relevant] >= s[r]).sum()
            score_i += l_rank / rank
        out[i] = score_i / len(relevant)
    return float(out.mean())


def auroc_per_class(scores: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Per-class AUROC via the rank-sum (Mann-Whitney) formulation with tie
    correction; NaN for degenerate classes."""
    scores, true = _np(scores).astype(np.float64), _np(true).astype(bool)
    n_classes = scores.shape[1]
    out = np.full(n_classes, np.nan)
    for c in range(n_classes):
        y, s = true[:, c], scores[:, c]
        n_pos, n_neg = int(y.sum()), int((~y).sum())
        if n_pos == 0 or n_neg == 0:
            continue
        # average ranks with tie correction, vectorized: np.unique sorts,
        # each tie block of size m starting at position p gets rank
        # p + (m-1)/2 + 1 — identical values to the classic two-pointer scan
        _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
        starts = np.concatenate(([0.0], np.cumsum(counts)[:-1].astype(np.float64)))
        ranks = starts[inv] + (counts[inv] - 1) / 2.0 + 1.0
        rank_sum = ranks[y].sum()
        out[c] = (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return out


def macro_auroc(scores: np.ndarray, true: np.ndarray) -> float:
    per = auroc_per_class(scores, true)
    valid = ~np.isnan(per)
    return float(per[valid].mean()) if valid.any() else float("nan")


# ---------------------------------------------------------------------------
# aggregate entry points
# ---------------------------------------------------------------------------


def _suite_thunks(
    scores: np.ndarray,
    true: np.ndarray,
    threshold: float,
    class_names: Optional[Sequence[str]],
) -> Dict[str, Any]:
    """key → thunk map covering every :func:`multilabel_metrics` key.

    Shared intermediates (binarized predictions, the F1 family, per-class
    AUROC) are computed at most once per (scores, true) realization, and a
    key's metric is computed only when its thunk runs — this is what lets
    :func:`bootstrap_ci` evaluate a requested SUBSET per replicate instead
    of paying for the whole suite 1000 times."""
    pred = (scores > threshold).astype(np.int32)
    cache: Dict[str, Any] = {}

    def _f1(k: str) -> float:
        if "f1" not in cache:
            cache["f1"] = f1_scores(pred, true)
        return cache["f1"][k]

    def _per_auroc() -> np.ndarray:
        if "per" not in cache:
            cache["per"] = auroc_per_class(scores, true)
        return cache["per"]

    def _macro_auroc() -> float:
        per = _per_auroc()
        valid = ~np.isnan(per)
        return float(per[valid].mean()) if valid.any() else float("nan")

    thunks: Dict[str, Any] = {
        "sample_accuracy": lambda: sample_accuracy(pred, true),
        "label_accuracy": lambda: label_accuracy(pred, true),
        "hamming_score": lambda: hamming_score(pred, true),
        "hamming_loss": lambda: hamming_loss(pred, true),
        "exact_match": lambda: exact_match(pred, true),
        "jaccard": lambda: jaccard_example_accuracy(pred, true),
        "top1_accuracy": lambda: top_k_accuracy(scores, true, 1),
        "top3_accuracy": lambda: top_k_accuracy(scores, true, 3),
        "mAP": lambda: mean_average_precision(scores, true),
        "LRAP": lambda: lrap(scores, true),
        "auroc_macro": _macro_auroc,
    }
    for k in ("f1_macro", "f1_micro", "f1_weighted", "f1_samples"):
        thunks[k] = lambda k=k: _f1(k)
    if class_names is not None:
        for i, name in enumerate(class_names):
            thunks[f"auroc/{name}"] = lambda i=i: float(_per_auroc()[i])
    return thunks


def multilabel_metrics(
    scores: np.ndarray,
    true: np.ndarray,
    threshold: float = 0.5,
    class_names: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """The full suite from probabilities: everything in §2.6 plus AUROC."""
    scores, true = _np(scores), _np(true)
    thunks = _suite_thunks(scores, true, threshold, class_names)
    return {k: float(t()) for k, t in thunks.items()}


def bootstrap_ci(
    scores: np.ndarray,
    true: np.ndarray,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
    threshold: float = 0.5,
    metrics: Optional[Sequence[str]] = None,
    class_names: Optional[Sequence[str]] = None,
    point: Optional[Dict[str, float]] = None,
) -> Dict[str, Dict[str, float]]:
    """Nonparametric percentile-bootstrap confidence intervals over SAMPLES
    (the exam is the resampling unit — labels within a sample stay together,
    so label correlation is respected). Returns
    {metric: {"value": point, "lo": q_{α/2}, "hi": q_{1-α/2}, "n_boot": B}}.

    The reference reports bare point metrics (02 nb cell 30); on a 902-exam
    validation split the headline numbers move by several points between
    seeds, so CIs are what make model comparisons meaningful. Degenerate
    replicates (a class losing all its positives → NaN AUROC) are excluded
    per-metric from the percentile, mirroring macro_auroc's NaN policy.

    ``point``: pre-computed point metrics (the exact output of
    ``multilabel_metrics(scores, true, threshold, class_names)``) — pass it
    when the caller already computed them so they aren't recomputed here.
    """
    scores, true = _np(scores), _np(true)
    if point is None:
        point = multilabel_metrics(scores, true, threshold, class_names)
    keys = list(metrics) if metrics is not None else list(point)
    unknown = [k for k in keys if k not in point]
    if unknown:
        raise KeyError(f"unknown metric(s) {unknown}; have {sorted(point)}")
    rng = np.random.default_rng(seed)
    n = len(scores)
    reps = {k: np.empty(n_boot) for k in keys}
    for b in range(n_boot):
        idx = rng.integers(0, n, n)
        # only the REQUESTED metrics are computed per replicate (shared
        # intermediates cached inside the thunk map)
        thunks = _suite_thunks(scores[idx], true[idx], threshold, class_names)
        for k in keys:
            reps[k][b] = thunks[k]()
    lo_q, hi_q = 100.0 * alpha / 2.0, 100.0 * (1.0 - alpha / 2.0)
    out: Dict[str, Dict[str, float]] = {}
    for k in keys:
        r = reps[k]
        valid = r[~np.isnan(r)]
        if valid.size:
            lo, hi = np.percentile(valid, [lo_q, hi_q])
        else:
            lo = hi = float("nan")
        out[k] = {
            "value": float(point[k]),
            "lo": float(lo),
            "hi": float(hi),
            "n_boot": int(valid.size),
        }
    return out


@dataclass
class MeanAccumulator:
    """Running mean (the AverageMeter counterpart)."""

    total: float = 0.0
    count: int = 0
    last: float = 0.0
    history: List[float] = field(default_factory=list)

    def update(self, value: float, n: int = 1) -> None:
        self.last = float(value)
        self.total += float(value) * n
        self.count += n
        self.history.append(float(value))

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
