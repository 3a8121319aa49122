"""Zero-shot evaluation drivers — the zero_shot_predict.py counterparts
(counterpart of ``clip_for_dl_tpu.zeroshot.driver``; the result CSV is
written with the ``csv`` module).

Two pipelines over a multi-view loader and a ZeroShotEngine:

- `run_zero_shot_eval` (0425/0426 semantics, 0425/zero_shot_predict.py:
  13-147): flatten views, per-view softmax top-3, union+max view merge,
  binary matrix, metric suite + optional CSV.
- `run_dynamic_threshold_eval` (multimodal semantics,
  multimodal_attention/zero_shot_predict.py:13-264): pass 1 collects
  view-max sigmoid scores on the calibration fraction, per-disease F1 grid
  search, pass 2 weighted frontal/lateral merge with argmax fallback,
  metrics + per-class precision/recall/F1.

Device work stays batched inside the engine (kernels B2 and B1 on the
card); only prediction-set logic runs on the host.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..evals.metrics import multilabel_metrics, per_class_report
from .engine import ZeroShotEngine
from .predict import (
    merge_views_union_max,
    merge_views_weighted,
    predictions_to_matrix,
    softmax_topk_predictions,
)
from .thresholds import calibration_split, search_thresholds


def _mask_of(batch) -> Optional[np.ndarray]:
    m = batch.get("mask")
    return None if m is None else np.asarray(m).astype(bool)


def run_zero_shot_eval(
    engine: ZeroShotEngine,
    loader: Iterable,
    top_k: int = 3,
    csv_path: Optional[str] = None,
) -> Dict:
    """Per-view top-k + union/max merge over [B, 2, H, W, 3] batches."""
    disease_list = engine.disease_list
    all_preds: List[List[str]] = []
    all_scores: List[List[float]] = []
    all_labels: List[np.ndarray] = []
    for batch, logits in engine.stream_logits(loader):  # overlapped H2D/fetch
        mask = _mask_of(batch)
        preds, scores = softmax_topk_predictions(logits, disease_list, top_k)
        b = len(batch["labels"])
        for i in range(b):
            if mask is not None and not mask[i]:
                continue
            p, s = merge_views_union_max(
                preds[2 * i], scores[2 * i], preds[2 * i + 1], scores[2 * i + 1]
            )
            all_preds.append(p)
            all_scores.append(s)
            all_labels.append(np.asarray(batch["labels"][i]))
    pred_matrix = predictions_to_matrix(all_preds, disease_list)
    labels = np.stack(all_labels)
    score_matrix = _scores_to_matrix(all_preds, all_scores, disease_list)
    metrics = multilabel_metrics(score_matrix, labels, class_names=disease_list)
    metrics.update(_set_metrics(pred_matrix, labels))
    out = {
        "metrics": metrics,
        "predictions": all_preds,
        "pred_matrix": pred_matrix,
        "labels": labels,
    }
    if csv_path:
        _write_csv(all_preds, all_scores, labels, disease_list, csv_path)
        out["csv_path"] = csv_path
    return out


def run_dynamic_threshold_eval(
    engine: ZeroShotEngine,
    loader_fn,
    calib_frac: float = 0.25,
    grid_points: int = 20,
    frontal_weight: float = 1.0,
    lateral_weight: float = 0.8,
    csv_path: Optional[str] = None,
) -> Dict:
    """Two-pass dynamic-threshold pipeline. `loader_fn()` returns a fresh
    iterator over the val loader (two passes needed)."""
    disease_list = engine.disease_list

    # pass 1: calibration distributions from view-max probabilities on the
    # leading fraction of batches (streamed — batches are not retained)
    first_pass = loader_fn()
    try:
        n_batches = len(first_pass)
    except TypeError:
        first_pass = list(first_pass)
        n_batches = len(first_pass)
    n_calib = calibration_split(n_batches, calib_frac)
    calib_scores: List[np.ndarray] = []
    calib_labels: List[np.ndarray] = []
    for i, batch in enumerate(first_pass):
        if i >= n_calib:
            break
        mask = _mask_of(batch)
        probs = engine.probs(batch["images"])  # [B*2, C]
        b = len(batch["labels"])
        vm = probs.reshape(b, 2, -1).max(axis=1)
        keep = slice(None) if mask is None else mask
        calib_scores.append(vm[keep])
        calib_labels.append(np.asarray(batch["labels"])[keep])
    thresholds = search_thresholds(
        np.concatenate(calib_scores),
        np.concatenate(calib_labels),
        disease_list,
        grid_points,
    )

    # pass 2: weighted view merge with per-disease thresholds
    all_preds: List[List[str]] = []
    all_scores: List[List[float]] = []
    all_labels: List[np.ndarray] = []
    raw_probs: List[np.ndarray] = []
    for batch in loader_fn():
        mask = _mask_of(batch)
        probs = engine.probs(batch["images"])
        b = len(batch["labels"])
        vp = probs.reshape(b, 2, -1)
        preds, scores = merge_views_weighted(
            vp, disease_list, thresholds, frontal_weight, lateral_weight
        )
        for i in range(b):
            if mask is not None and not mask[i]:
                continue
            all_preds.append(preds[i])
            all_scores.append(scores[i])
            all_labels.append(np.asarray(batch["labels"][i]))
            raw_probs.append(vp[i].max(axis=0))
    pred_matrix = predictions_to_matrix(all_preds, disease_list)
    labels = np.stack(all_labels)
    probs_matrix = np.stack(raw_probs)
    metrics = multilabel_metrics(probs_matrix, labels, class_names=disease_list)
    metrics.update(_set_metrics(pred_matrix, labels))
    out = {
        "metrics": metrics,
        "thresholds": thresholds,
        "predictions": all_preds,
        "pred_matrix": pred_matrix,
        "labels": labels,
        "per_class": per_class_report(pred_matrix, labels, disease_list),
    }
    if csv_path:
        _write_csv(all_preds, all_scores, labels, disease_list, csv_path)
        out["csv_path"] = csv_path
    return out


def _set_metrics(pred_matrix: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Metrics on the discrete prediction sets (reference's
    evaluate_predictions: accuracy + F1 family on the binary matrix)."""
    from ..evals.metrics import exact_match, f1_scores

    out = {f"set_{k}": v for k, v in f1_scores(pred_matrix, labels).items()}
    out["set_exact_match"] = exact_match(pred_matrix, labels)
    return out


def _scores_to_matrix(preds, scores, disease_list) -> np.ndarray:
    index = {d: j for j, d in enumerate(disease_list)}
    out = np.zeros((len(preds), len(disease_list)), np.float32)
    for i, (ps, ss) in enumerate(zip(preds, scores)):
        for d, s in zip(ps, ss):
            if d in index:
                out[i, index[d]] = s
    return out


def _write_csv(preds, scores, labels, disease_list, path: str) -> None:
    """One row a sample: its prediction set, their scores to 4 places and its
    true labels, each "; "-joined (the JAX function's frame, read back by
    ``pd.read_csv`` to the same values)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["predictions", "scores", "true_labels"])
        for p, s, l in zip(preds, scores, labels):
            w.writerow(["; ".join(p), "; ".join(f"{x:.4f}" for x in s),
                        "; ".join(d for d, v in zip(disease_list, l) if v)])
