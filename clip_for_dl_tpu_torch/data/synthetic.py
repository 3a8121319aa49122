"""Synthetic Indiana-CXR-shaped data for tests and benchmarks (counterpart of
``clip_for_dl_tpu.data.synthetic``: the same ``rng`` draws, the frames as
``data/frame.py`` tables).

The reference dataset's images are not redistributable with the repo; this
generates deterministic exams with the real label marginals' shape (16-dim
multi-hot skewed toward Normal), plausible report text drawn from a small
clinical template bank, and gradient-textured pseudo-radiographs, so every
pipeline (pretrain → adapter → zero-shot → Grad-CAM) runs end-to-end without
the Kaggle download.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.config import DISEASE_LABELS
from .frame import Frame

_FINDING_TEMPLATES = [
    "The cardiac silhouette and mediastinum size are within normal limits.",
    "There is {d} in the right lower lobe.",
    "Findings consistent with {d}.",
    "Stable appearance of {d} compared to prior exam.",
    "No acute cardiopulmonary abnormality. {d} is again noted.",
    "Mild {d} without associated effusion.",
]


def synthetic_labels(n: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-hot [n, 16]: ~37% Normal-only, diseases with geometric-ish
    marginals, every row has ≥1 positive (the labeled subset's invariant)."""
    labels = np.zeros((n, len(DISEASE_LABELS)), np.float32)
    for i in range(n):
        if rng.random() < 0.37:
            labels[i, -1] = 1.0
            continue
        k = 1 + rng.geometric(0.6)
        idx = rng.choice(len(DISEASE_LABELS) - 1, size=min(k, 5), replace=False)
        labels[i, idx] = 1.0
    return labels


def synthetic_image(
    rng: np.random.Generator, size: int = 224, seed_val: Optional[int] = None
) -> np.ndarray:
    """Gradient + blob texture (lung-field-ish) uint8 RGB."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = 120 + 60 * np.exp(-((x - 0.3) ** 2 + (y - 0.5) ** 2) / 0.08)
    base += 60 * np.exp(-((x - 0.7) ** 2 + (y - 0.5) ** 2) / 0.08)
    base += rng.normal(0, 12, (size, size))
    img = np.clip(base, 0, 255).astype(np.uint8)
    return np.repeat(img[:, :, None], 3, axis=2)


def synthetic_report(labels: np.ndarray, rng: np.random.Generator) -> str:
    pos = [DISEASE_LABELS[i] for i in np.flatnonzero(labels[:-1])]
    if not pos:
        return _FINDING_TEMPLATES[0]
    parts = [
        _FINDING_TEMPLATES[rng.integers(1, len(_FINDING_TEMPLATES))].format(
            d=d.lower()
        )
        for d in pos
    ]
    return " ".join(parts)


class SyntheticMultiViewDataset:
    """Drop-in for ChestXrayMultiViewDataset."""

    def __init__(self, n: int = 64, image_size: int = 224, seed: int = 0):
        self.n = n
        self.image_size = image_size
        rng = np.random.default_rng(seed)
        self.labels = synthetic_labels(n, rng)
        self.findings = [synthetic_report(l, rng) for l in self.labels]
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        img = synthetic_image(rng, self.image_size)
        return {
            "images": np.stack([img, img[:, ::-1]]),
            "labels": self.labels[i],
            "findings": self.findings[i],
            "view_types": ("frontal", "lateral"),
        }


class SyntheticImageTextDataset:
    def __init__(self, n: int = 64, image_size: int = 224, seed: int = 0):
        self.base = SyntheticMultiViewDataset(n, image_size, seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        s = self.base[i]
        return {"image": s["images"][0], "text": s["findings"]}


class SyntheticImageLabelDataset:
    def __init__(self, n: int = 64, image_size: int = 224, seed: int = 0):
        self.base = SyntheticMultiViewDataset(n, image_size, seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        s = self.base[i]
        return {
            "image": s["images"][0],
            "labels": s["labels"],
            "path": f"synthetic_{i}.png",
        }


def synthetic_report_frame(n: int = 128, seed: int = 0) -> Frame:
    """A labeled-reports-like table (uid, Problems-derived columns,
    findings) for exercising split/index logic."""
    rng = np.random.default_rng(seed)
    labels = synthetic_labels(n, rng)
    rows = []
    for i in range(n):
        rows.append({
            "uid": i + 1,
            "findings": synthetic_report(labels[i], rng),
            **{c: int(labels[i, j]) for j, c in enumerate(DISEASE_LABELS)},
        })
    return Frame(["uid", "findings", *DISEASE_LABELS], rows)


def synthetic_projection_frame(n: int = 128, seed: int = 1) -> Frame:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        uid = i + 1
        has_f, has_l = rng.random() > 0.05, rng.random() > 0.15
        if has_f:
            rows.append({"uid": uid, "filename": f"{uid}_f.png",
                         "projection": "Frontal"})
        if has_l:
            rows.append({"uid": uid, "filename": f"{uid}_l.png",
                         "projection": "Lateral"})
        if not (has_f or has_l):
            rows.append({"uid": uid, "filename": f"{uid}_x.png",
                         "projection": "Oblique"})
    return Frame(["uid", "filename", "projection"], rows)
