"""The Kaggle Indiana-CXR layout, miniature and seeded: the
``images/images_normalized/CXR{uid}_IM-....dcm.png`` files and the
``indiana_reports.csv`` / ``indiana_projections.csv`` tables that
``tools/real_data_dryrun.py`` writes, here with ``testing/png.py`` and the
``csv`` module. Test scaffolding."""

from __future__ import annotations

import csv
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from .png import write_png

PROBLEMS = (
    "normal", "Cardiomegaly", "Cardiomegaly;Pulmonary Atelectasis",
    "Bullous Emphysema", "Pleural Effusion", "Nodule", "Mass",
    "Cicatrix", "Opacity", "normal",
)
REPORT_COLUMNS = ("uid", "MeSH", "Problems", "image", "indication", "comparison",
                  "findings", "impression")


def _image(rng, shape: Tuple[int, int], channels: int) -> np.ndarray:
    """A smooth field with grain, different in every image (its level, a
    gradient of random direction and one to four bright or dark blobs), so
    that a model's outputs differ between images; rows that the filters
    can predict."""
    h, w = shape
    y, x = np.linspace(0, 1, h)[:, None], np.linspace(0, 1, w)[None, :]
    base = rng.uniform(40, 160) + rng.uniform(-60, 60) * y + rng.uniform(-60, 60) * x
    for _ in range(rng.integers(1, 5)):
        cy, cx = rng.uniform(0, 1, 2)
        base = base + rng.uniform(-90, 90) * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * rng.uniform(0.05, 0.3) ** 2))
    img = np.clip(base + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
    return img if channels == 1 else np.repeat(img[..., None], channels, axis=2)


def write_kaggle_layout(
    root: str,
    n_uids: int = 24,
    sizes: Sequence[Tuple[int, int]] = ((256, 208),),
    channels: int = 1,
    seed: int = 42,
    empty_findings_every: int = 0,
    single_view_uids: Sequence[int] = (),
    not_png_uids: Sequence[int] = (),
    filters="random",
) -> Dict[str, str]:
    """Write ``n_uids`` exams under ``root``: a frontal and a lateral PNG
    each (sizes taken in turn; grey, or RGB with ``channels`` 3), except
    the uids in ``single_view_uids`` (frontal only); the frontal file of the
    uids in ``not_png_uids`` holds bytes that are not a PNG; every
    ``empty_findings_every``-th report has empty findings. Returns the
    paths of the two CSVs and the image directory."""
    img_dir = os.path.join(root, "images", "images_normalized")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    reports, projections = [], []
    for uid in range(1, n_uids + 1):
        empty = empty_findings_every and uid % empty_findings_every == 0
        reports.append({
            "uid": uid,
            "MeSH": PROBLEMS[uid % len(PROBLEMS)],
            "Problems": PROBLEMS[uid % len(PROBLEMS)],
            "image": f"CXR{uid}",
            "indication": "chest pain",
            "comparison": "none",
            "findings": "" if empty else (
                f"The cardiac silhouette of patient {uid} is within normal limits. "
                "No acute cardiopulmonary abnormality."),
            "impression": "No acute disease.",
        })
        views = (("Frontal", "IM-0001-1001"),)
        if uid not in single_view_uids:
            views += (("Lateral", "IM-0001-2001"),)
        for view, tag in views:
            fname = f"CXR{uid}_{tag}.dcm.png"
            path = os.path.join(img_dir, fname)
            if view == "Frontal" and uid in not_png_uids:
                with open(path, "wb") as f:
                    f.write(b"this file is not a PNG\n")
            else:
                shape = sizes[(2 * uid + len(projections)) % len(sizes)]
                write_png(path, _image(rng, shape, channels), filters=filters, rng=rng)
            projections.append({"uid": uid, "filename": fname, "projection": view})
    paths = {"reports": os.path.join(root, "indiana_reports.csv"),
             "projections": os.path.join(root, "indiana_projections.csv"),
             "image_dir": img_dir}
    for name, rows, columns in (("reports", reports, REPORT_COLUMNS),
                                ("projections", projections, ("uid", "filename", "projection"))):
        with open(paths[name], "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
            w.writeheader()
            w.writerows(rows)
    return paths
