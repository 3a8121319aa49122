"""Zero-shot predictors and multi-view merging: host-side set logic over
the engine's score matrices (counterpart of ``clip_for_dl_tpu.zeroshot.predict``).

- sigmoid + scalar-or-per-disease threshold + top-k backfill
- softmax + top-k names/scores
- union/max view merging and weighted frontal/lateral merging with argmax
  fallback; prediction sets → binary matrix
- the label and threshold helpers (unique terms of a Problems column,
  frequency-conditioned thresholds, co-occurrence adjustment), over the
  port's tables where the JAX ones take pandas frames
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np

Threshold = Union[float, Mapping[str, float]]


def sigmoid_predictions(
    probs: np.ndarray,
    disease_list: Sequence[str],
    threshold: Threshold = 0.5,
    top_k: int | None = None,
) -> Tuple[List[List[str]], List[List[float]]]:
    """Per-sample prediction sets from sigmoid probabilities with threshold
    filtering, top-k backfill when empty/short, and top-k truncation."""
    probs = np.asarray(probs)
    batch_preds: List[List[str]] = []
    batch_scores: List[List[float]] = []
    for row in probs:
        if isinstance(threshold, Mapping):
            keep = [
                (d, float(row[j]))
                for j, d in enumerate(disease_list)
                if d in threshold and row[j] >= threshold[d]
            ]
        else:
            keep = [
                (disease_list[j], float(row[j]))
                for j in np.flatnonzero(row >= threshold)
            ]
        preds = [d for d, _ in keep]
        scores = [s for _, s in keep]
        if len(preds) == 0 or (top_k is not None and len(preds) < top_k):
            k = top_k if top_k is not None else 1
            order = np.argsort(-row, kind="stable")[:k]
            if preds:
                have = set(preds)
                for j in order:
                    d = disease_list[j]
                    if d not in have:
                        preds.append(d)
                        scores.append(float(row[j]))
                        if len(preds) >= k:
                            break
            else:
                preds = [disease_list[j] for j in order]
                scores = [float(row[j]) for j in order]
        elif top_k is not None and len(preds) > top_k:
            pairs = sorted(zip(preds, scores), key=lambda x: -x[1])[:top_k]
            preds, scores = [p for p, _ in pairs], [s for _, s in pairs]
        batch_preds.append(list(preds))
        batch_scores.append(list(scores))
    return batch_preds, batch_scores


def softmax_topk_predictions(
    logits: np.ndarray, disease_list: Sequence[str], k: int = 3
) -> Tuple[List[List[str]], List[List[float]]]:
    """Softmax over classes then top-k names + scores."""
    logits = np.asarray(logits, np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    order = np.argsort(-p, axis=1, kind="stable")[:, :k]
    preds = [[disease_list[j] for j in row] for row in order]
    scores = [
        [float(p[i, j]) for j in row] for i, row in enumerate(order)
    ]
    return preds, scores


def merge_views_union_max(
    preds_a: Sequence[str],
    scores_a: Sequence[float],
    preds_b: Sequence[str],
    scores_b: Sequence[float],
) -> Tuple[List[str], List[float]]:
    """Union the two views' prediction sets, keep each disease's max score."""
    merged: Dict[str, float] = {}
    for preds, scores in ((preds_a, scores_a), (preds_b, scores_b)):
        for d, s in zip(preds, scores):
            merged[d] = max(merged.get(d, -np.inf), float(s))
    out = sorted(merged.items(), key=lambda kv: -kv[1])
    return [d for d, _ in out], [s for _, s in out]


def merge_views_weighted(
    view_probs: np.ndarray,
    disease_list: Sequence[str],
    thresholds: Mapping[str, float],
    frontal_weight: float = 1.0,
    lateral_weight: float = 0.8,
) -> Tuple[List[List[str]], List[List[float]]]:
    """Weighted-max view merge with per-disease thresholds and argmax
    fallback when nothing clears threshold.

    view_probs: [B, 2, C] (frontal, lateral) probabilities.
    """
    view_probs = np.asarray(view_probs)
    weights = np.asarray([frontal_weight, lateral_weight])
    weighted = (view_probs * weights[None, :, None]).max(axis=1)  # [B, C]
    thresh = np.asarray([thresholds[d] for d in disease_list])
    all_preds: List[List[str]] = []
    all_scores: List[List[float]] = []
    for row in weighted:
        keep = np.flatnonzero(row >= thresh)
        if keep.size == 0:
            keep = np.asarray([int(np.argmax(row))])
        order = keep[np.argsort(-row[keep], kind="stable")]
        all_preds.append([disease_list[j] for j in order])
        all_scores.append([float(row[j]) for j in order])
    return all_preds, all_scores


def unique_problem_labels(problems_column) -> List[str]:
    """All unique semicolon-separated diagnosis terms of a Problems column
    (0425/prepare_data.py:15-30 process_multiple_labels); non-string cells
    (missing ones) are skipped."""
    seen = set()
    for problems in problems_column:
        if isinstance(problems, str):
            seen.update(p.strip() for p in problems.split(";"))
    return list(seen)


def frequency_thresholds(
    disease_stats: Mapping[str, Mapping[str, float]], common_cutoff: int = 100,
    common_threshold: float = 0.4, rare_threshold: float = 0.6,
) -> List[float]:
    """Frequency-conditioned thresholds, one a disease in the order of
    ``disease_stats`` (``prompts.analyze_disease_distribution``'s dict, the
    rows of the JAX DataFrame): lower for common diseases, higher for rare
    ones (the intent of 0425/prepare_data.py:288-301)."""
    return [
        common_threshold if stats["frequency"] > common_cutoff else rare_threshold
        for stats in disease_stats.values()
    ]


def adjust_predictions_by_cooccurrence(
    pred_matrix: np.ndarray,
    cooccurrence: Mapping[str, Mapping[str, int]],
    disease_list: Sequence[str],
    min_count: int = 5,
) -> np.ndarray:
    """For single-prediction samples, switch on the diseases that co-occur
    with the predicted one more than ``min_count`` times (the intent of
    0425/prepare_data.py:316-325), over ``prompts.disease_cooccurrence``'s
    dict of rows (the JAX DataFrame's ``.loc[row, column]`` as
    ``[row][column]``)."""
    pred = np.array(pred_matrix, copy=True)
    for i, row in enumerate(pred):
        if row.sum() == 1:
            disease = disease_list[int(np.argmax(row))]
            if disease not in cooccurrence:
                continue
            counts = cooccurrence[disease]
            for j, other in enumerate(disease_list):
                if other == disease or other not in counts:
                    continue
                if counts[other] > min_count:
                    pred[i, j] = 1.0
    return pred


def predictions_to_matrix(
    predictions: Sequence[Sequence[str]], disease_list: Sequence[str]
) -> np.ndarray:
    """Prediction sets → binary [B, C] matrix for the metric suite."""
    index = {d: j for j, d in enumerate(disease_list)}
    out = np.zeros((len(predictions), len(disease_list)), np.float32)
    for i, preds in enumerate(predictions):
        for d in preds:
            if d in index:
                out[i, index[d]] = 1.0
    return out
