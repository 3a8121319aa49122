"""Offline label extraction for the Indiana University CXR reports
(counterpart of ``clip_for_dl_tpu.data.labels``, on ``csv`` rows instead of
a dataframe).

Reproduces the reference's labeling pass (01_datapreprocess.ipynb cells
1-10): parse the semicolon-separated ``Problems`` column, take the main term
before any slash, normalize synonyms, and emit one binary column per
disease plus ``Normal``. A missing ``Problems`` cell (None, pandas' NaN) has
no labels.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.config import DISEASE_LABELS
from .frame import Frame, number, read_csv, write_csv

# 15 disease columns (DISEASE_LABELS minus the appended "Normal").
FINAL_LABELS: Tuple[str, ...] = DISEASE_LABELS[:-1]

# Synonym normalization (01_datapreprocess.ipynb cell 5 label_mapping).
LABEL_MAPPING: Dict[str, str] = {
    "Bullous Emphysema": "Emphysema",
    "Pulmonary Fibrosis": "Fibrosis",
    "Hernia, Hiatal": "Hernia",
    "Pulmonary Emphysema": "Emphysema",
    "Calcified Granuloma": "Granuloma",
    "Granulomatous Disease": "Granuloma",
    "Airspace Disease": "Consolidation",
}

# Term taxonomy used by the exploratory classification pass (cell 1).
DISEASE_KEYWORDS = frozenset({
    "Cardiomegaly", "Pulmonary Atelectasis", "Bullous Emphysema",
    "Pulmonary Fibrosis", "Pneumonia", "Tuberculosis",
    "Chronic Obstructive Pulmonary Disease", "COPD", "Emphysema", "Neoplasm",
    "Hernia", "Edema", "Infiltration", "Mass", "Nodule", "Consolidation",
    "Fibrosis", "Pleural Thickening", "Effusion", "Pleural Effusion",
    "Pneumothorax", "Pulmonary Edema", "Hernia, Hiatal", "Infiltrate",
    "Thickening", "Calcified Granuloma", "Granulomatous Disease",
    "Airspace Disease",
})

STRUCTURE_KEYWORDS = frozenset({
    "Lung", "Pulmonary Artery", "Thoracic Vertebrae", "Diaphragm", "Heart",
    "Rib", "Chest Wall", "Mediastinum", "Trachea", "Pleura",
})


def classify_term(term: str) -> str:
    """Disease / Anatomical Structure / Uncategorized taxonomy."""
    if term in DISEASE_KEYWORDS:
        return "Disease"
    if term in STRUCTURE_KEYWORDS:
        return "Anatomical Structure"
    return "Uncategorized"


def main_terms(problems: str) -> List[str]:
    """Split 'Problems' on ';', keep the main term before any '/'."""
    return [part.strip().split("/")[0] for part in problems.split(";")]


def term_frequency_table(reports: Frame) -> Frame:
    """Frequency + category of every main term (excluding 'normal' rows),
    most frequent first."""
    series = [p for p in reports.column("Problems") if p is not None and p.lower() != "normal"]
    counts = Counter(t for problems in series for t in (s.strip() for s in main_terms(problems)))
    rows = [{"Term": t, "Frequency": n, "Category": classify_term(t)}
            for t, n in sorted(counts.items(), key=lambda kv: -kv[1])]
    return Frame(["Term", "Frequency", "Category"], rows)


def extract_labels(problem_str: Optional[str]) -> str:
    """One row's normalized disease-label set as a comma-joined string (a
    set's order, as in the reference: compare it as a set)."""
    if problem_str is None or str(problem_str).lower() == "normal":
        return ""
    mapped = (LABEL_MAPPING.get(t, t) for t in main_terms(str(problem_str)))
    found = {m for m in mapped if m in FINAL_LABELS}
    return ", ".join(found) if found else ""


def label_reports(reports: Frame) -> Frame:
    """reports → reports with ``extracted_labels``, 15 binary disease
    columns and ``Normal``, in the reference's output column order."""
    rows = []
    for r in reports.rows:
        row = dict(r)
        row["extracted_labels"] = extract_labels(r.get("Problems"))
        found = set(row["extracted_labels"].split(", ")) - {""}
        for label in FINAL_LABELS:
            row[label] = 1 if label in found else 0
        row["Normal"] = 1 if str(r.get("Problems")).lower() == "normal" else 0
        rows.append(row)
    added = ["extracted_labels", *FINAL_LABELS, "Normal"]
    # a column the input already has keeps its place, as in pandas
    return Frame(reports.columns + [c for c in added if c not in reports.columns], rows)


def _labeled(row) -> bool:
    return sum(number(row[c]) for c in DISEASE_LABELS) > 0


def split_unlabeled(labeled: Frame) -> Tuple[Frame, Frame]:
    """(labeled_rows, unlabeled_rows) by any-label-set (cells 9-10)."""
    return labeled.where(_labeled), labeled.where(lambda r: not _labeled(r))


def label_matrix(frame: Frame) -> np.ndarray:
    """[N, 16] float32 multi-hot matrix in DISEASE_LABELS order."""
    return np.asarray([[number(r[c]) for c in DISEASE_LABELS] for r in frame.rows],
                      np.float32).reshape(len(frame), len(DISEASE_LABELS))


def prepare_labeled_csv(reports_csv: str, out_csv: str,
                        unlabeled_csv: Optional[str] = None) -> Frame:
    """Read raw reports, label them, write the CSV(s)."""
    labeled = label_reports(read_csv(reports_csv))
    write_csv(labeled, out_csv)
    if unlabeled_csv:
        write_csv(split_unlabeled(labeled)[1], unlabeled_csv)
    return labeled
