"""Dynamic per-disease threshold calibration.

Reproduces the reference's two-pass scheme
(multimodal_attention/zero_shot_predict.py:65-157): pass 1 collects per-
disease score/label distributions on a calibration fraction of the val set
(view-max merged), then a 20-point grid in
[max(0.1, μ_neg−σ_neg), min(0.9, μ_pos+σ_pos)] is searched per disease for
the F1-maximizing threshold, with 0.8 / 0.2 fallbacks when a disease has no
positive / no negative calibration samples.

Inherently data-dependent host logic — kept out of jit by design
(SURVEY.md §7 "hard parts"); it consumes device-computed score arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

DEFAULT_INIT = 0.3
NO_POSITIVES_THRESHOLD = 0.8
NO_NEGATIVES_THRESHOLD = 0.2


def binary_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def search_threshold(
    scores: np.ndarray, labels: np.ndarray, grid_points: int = 20
) -> float:
    """One disease's optimal threshold from calibration scores/labels."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    if scores.size == 0:
        return DEFAULT_INIT
    pos, neg = scores[labels == 1], scores[labels == 0]
    if pos.size == 0:
        return NO_POSITIVES_THRESHOLD
    if neg.size == 0:
        return NO_NEGATIVES_THRESHOLD
    lo = max(0.1, float(neg.mean() - neg.std()))
    hi = min(0.9, float(pos.mean() + pos.std()))
    best_f1, best_t = 0.0, 0.5
    for t in np.linspace(lo, hi, grid_points):
        f1 = binary_f1(labels, (scores >= t).astype(int))
        if f1 > best_f1:
            best_f1, best_t = f1, float(t)
    return best_t


def search_thresholds(
    scores: np.ndarray,
    labels: np.ndarray,
    disease_list: Sequence[str],
    grid_points: int = 20,
) -> Dict[str, float]:
    """scores/labels: [N, C] calibration matrices → per-disease thresholds."""
    scores, labels = np.asarray(scores), np.asarray(labels)
    return {
        d: search_threshold(scores[:, j], labels[:, j], grid_points)
        for j, d in enumerate(disease_list)
    }


def calibration_split(n_batches: int, frac: float = 0.25) -> int:
    """Number of leading batches used for calibration (len(loader)//4)."""
    return max(1, int(n_batches * frac))


def view_max_scores(view_probs: np.ndarray) -> np.ndarray:
    """[B, V, C] per-view probabilities → [B, C] view-max (pass-1 merge)."""
    return np.asarray(view_probs).max(axis=1)
