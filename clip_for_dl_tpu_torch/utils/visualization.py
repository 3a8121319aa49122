"""Plotting and reporting (counterpart of
``clip_for_dl_tpu.utils.visualization``, the 0426/visualization.py surface).

One definition per function. Matplotlib loads lazily with the Agg backend,
inside the functions that draw; every plot returns the written path (with
``path``) or the figure. Where the JAX module takes a pandas frame, these
take the port's tables: anything with ``columns`` and ``rows`` (a list of
row dicts), such as ``train.loop.History`` or ``data.frame.Frame``.

The CSVs are written with the ``csv`` module: each number is the ``str`` of
its value, the shortest text that reads back to it, as pandas' ``to_csv``
writes a float32 or float64 column; a missing cell is empty, as pandas
writes NaN. Each file is byte-equal to the JAX module's.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from ..data.frame import Frame, write_csv


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, path: Optional[str]):
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        _plt().close(fig)
        return path
    return fig


def _column(table, name: str) -> list:
    """A column of a table with ``rows``, missing cells as NaN."""
    return [r.get(name, np.nan) for r in table.rows]


def display_image(image: np.ndarray, title: str = "", path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.asarray(image).squeeze(), cmap="gray")
    ax.set_title(title)
    ax.axis("off")
    return _finish(fig, path)


def save_or_show_image(image: np.ndarray, path: Optional[str] = None, title: str = ""):
    return display_image(image, title, path)


def plot_training_history(history, path: Optional[str] = None):
    """Loss (+ any lr/*) curves from a history table (training_history.csv
    layout: ``epoch``, ``train_loss``, ``val_loss``, ``lr/<group>``)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    epochs = _column(history, "epoch")
    for col in ("train_loss", "val_loss"):
        if col in history.columns:
            axes[0].plot(epochs, _column(history, col), label=col)
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("loss")
    axes[0].legend()
    axes[0].grid(alpha=0.3)
    for col in history.columns:
        if col.startswith("lr/"):
            axes[1].plot(epochs, _column(history, col), label=col)
    axes[1].set_xlabel("epoch")
    axes[1].set_ylabel("lr")
    axes[1].set_yscale("log")
    axes[1].legend(fontsize=7)
    axes[1].grid(alpha=0.3)
    fig.tight_layout()
    return _finish(fig, path)


def plot_confusion_matrix(
    matrix: np.ndarray,
    class_names: Sequence[str],
    path: Optional[str] = None,
    title: str = "Confusion matrix",
):
    plt = _plt()
    m = np.asarray(matrix)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(m, cmap="Blues")
    fig.colorbar(im)
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=75, fontsize=7)
    ax.set_yticklabels(class_names, fontsize=7)
    thresh = m.max() / 2 if m.size else 0
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            ax.text(j, i, f"{m[i, j]:.0f}", ha="center", va="center",
                    fontsize=6, color="white" if m[i, j] > thresh else "black")
    ax.set_title(title)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    return _finish(fig, path)


def visualize_top_predictions(
    image: np.ndarray,
    diseases: Sequence[str],
    scores: Sequence[float],
    path: Optional[str] = None,
):
    """Image + horizontal score bars (visualize_top_predictions)."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.imshow(np.asarray(image).squeeze(), cmap="gray")
    ax1.axis("off")
    y = np.arange(len(diseases))
    ax2.barh(y, list(scores))
    ax2.set_yticks(y)
    ax2.set_yticklabels(diseases, fontsize=8)
    ax2.invert_yaxis()
    ax2.set_xlabel("score")
    fig.tight_layout()
    return _finish(fig, path)


def visualize_disease_distribution(counts: Mapping[str, int], path: Optional[str] = None):
    plt = _plt()
    names = list(counts)
    vals = [counts[n] for n in names]
    order = np.argsort(vals)[::-1]
    fig, ax = plt.subplots(figsize=(11, 4.5))
    ax.bar([names[i] for i in order], [vals[i] for i in order])
    ax.set_ylabel("count")
    ax.grid(axis="y", linestyle="--", alpha=0.5)
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right", fontsize=8)
    fig.tight_layout()
    return _finish(fig, path)


def plot_metrics_comparison(
    metrics_by_run: Mapping[str, Mapping[str, float]],
    metric_names: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
):
    plt = _plt()
    runs = list(metrics_by_run)
    names = list(metric_names or next(iter(metrics_by_run.values())))
    x = np.arange(len(names))
    width = 0.8 / max(len(runs), 1)
    fig, ax = plt.subplots(figsize=(1.2 * len(names) + 2, 4))
    for i, run in enumerate(runs):
        vals = [metrics_by_run[run].get(n, np.nan) for n in names]
        ax.bar(x + i * width, vals, width, label=run)
    ax.set_xticks(x + width * (len(runs) - 1) / 2)
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    return _finish(fig, path)


def visualize_image_text_similarity(
    similarities: np.ndarray,
    texts: Sequence[str],
    top: int = 10,
    path: Optional[str] = None,
):
    plt = _plt()
    sims = np.asarray(similarities).ravel()
    order = np.argsort(-sims)[:top]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.barh(range(len(order)), sims[order])
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([texts[i][:60] for i in order], fontsize=7)
    ax.invert_yaxis()
    ax.set_xlabel("similarity")
    fig.tight_layout()
    return _finish(fig, path)


def visualize_predictions(
    images: np.ndarray,
    predictions: Sequence[Sequence[str]],
    true_labels: Optional[Sequence[Sequence[str]]] = None,
    path: Optional[str] = None,
    max_samples: int = 5,
):
    """Grid of images titled with predicted (and true) label sets."""
    plt = _plt()
    n = min(len(images), max_samples)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.6))
    axes = np.atleast_1d(axes)
    for i in range(n):
        axes[i].imshow(np.asarray(images[i]).squeeze(), cmap="gray")
        title = "pred: " + ", ".join(predictions[i][:3])
        if true_labels is not None:
            title += "\ntrue: " + ", ".join(true_labels[i][:3])
        axes[i].set_title(title, fontsize=7)
        axes[i].axis("off")
    fig.tight_layout()
    return _finish(fig, path)


def save_history_csv(history, path: str) -> str:
    """training_history.csv (0425/train.py:893-895) from a history table; a
    NaN cell is written empty, as pandas writes it."""
    rows = [{k: None if isinstance(v, float) and v != v else v for k, v in r.items()}
            for r in history.rows]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_csv(Frame(list(history.columns), rows), path)


def save_top_correct_csv(
    probs: np.ndarray,
    labels: np.ndarray,
    disease_list: Sequence[str],
    path: str,
    paths_col: Optional[Sequence[str]] = None,
) -> str:
    """Rows whose top-1 prediction is in the true label set (02 nb cell 32's
    top-correct filter): image, top1, top1_prob, true_labels."""
    probs, labels = np.asarray(probs), np.asarray(labels).astype(bool)
    top1 = np.argmax(probs, axis=1)
    keep = labels[np.arange(len(labels)), top1]
    rows = [{
        "image": paths_col[i] if paths_col is not None else i,
        "top1": disease_list[top1[i]],
        "top1_prob": float(probs[i, top1[i]]),
        "true_labels": "; ".join(d for d, v in zip(disease_list, labels[i]) if v),
    } for i in np.flatnonzero(keep)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # no row: pandas writes an empty header line
    return write_csv(Frame(list(rows[0]) if rows else [], rows), path)


def save_predictions_csv(
    probs: np.ndarray,
    labels: np.ndarray,
    disease_list: Sequence[str],
    path: str,
    paths_col: Optional[Sequence[str]] = None,
) -> str:
    """Per-image probability / true-label dump (02 nb cell 30 CSV): an
    ``image`` column when ``paths_col`` is given, then ``prob/{d}`` and
    ``true/{d}`` for each disease."""
    probs, labels = np.asarray(probs), np.asarray(labels)
    header = ["image"] if paths_col is not None else []
    header += [f"{kind}/{d}" for d in disease_list for kind in ("prob", "true")]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for i in range(len(probs)):
            row = [paths_col[i]] if paths_col is not None else []
            for j in range(len(disease_list)):
                row += [str(probs[i, j]), str(labels[i, j])]
            w.writerow(row)
    return path
