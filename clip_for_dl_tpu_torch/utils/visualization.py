"""The prediction CSV of the adapter and eval commands (counterpart of
``save_predictions_csv`` in ``clip_for_dl_tpu.utils.visualization``; the
plots there wait for ROADMAP A9).

Written with the ``csv`` module: each number is the ``str`` of its numpy
scalar, the shortest text that reads back to the same value, as pandas'
``to_csv`` writes a float32 or float64 column.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np


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
