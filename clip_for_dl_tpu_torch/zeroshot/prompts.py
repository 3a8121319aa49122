"""Prompt engineering for zero-shot CXR classification (counterpart of
``clip_for_dl_tpu.zeroshot.prompts``), on the port's ``data.frame.Frame``
instead of a pandas DataFrame:

- prediction prompts  "This chest X-ray shows {d}." with the Normal special
  case (0425/disease_analysis.py:152-208)
- basic prompts       "a chest x-ray of {d.lower()}" (0426/load_model.py:6-33)
- showing prompts     "This is a chest X-ray showing {d}." (02 nb cells 36/41)
- rich prompts        frequency- and primacy-conditioned template banks from
  the disease distribution (0425/disease_analysis.py:12-115)
- findings prompts    per-disease templates embedding report Findings text
  (0425/disease_analysis.py:412-447)

The report-built families read the table's cells as ``pd.read_csv`` would
type them (:func:`typed_rows`), so that the strings are the JAX package's:
a column whose every cell is a number holds numbers, and a Findings cell
"1" reads "1", or "1.0" in a column that also has an empty cell. Diseases
come in order of first appearance, as the JAX functions give them.
"""

from __future__ import annotations

from collections import Counter
from itertools import permutations
from typing import Any, Dict, List, Optional, Sequence

from ..data.frame import Frame

_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _int(v: str) -> Optional[int]:
    if "_" in v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def _float(v: str) -> Optional[float]:
    if "_" in v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def _column_type(cells: List[Optional[str]]) -> str:
    """The dtype ``pd.read_csv`` gives a column of these cells: "int",
    "float", "bool" or "str" (the object column of strings)."""
    present = [c for c in cells if c is not None]
    if not present:
        return "float"  # an all-NA column reads as float64 NaN
    if all(_int(c) is not None for c in present):
        return "int" if len(present) == len(cells) else "float"
    if all(_float(c) is not None for c in present):
        return "float"
    if all(c in _TRUE + _FALSE for c in present):
        return "bool"
    return "str"


def _cast(cell: Optional[str], kind: str) -> Any:
    if cell is None or kind == "str":
        return cell
    if kind == "int":
        return int(cell)
    if kind == "float":
        return float(cell)
    return cell in _TRUE


def typed_rows(frame: Frame) -> List[Dict[str, Any]]:
    """``frame``'s rows with each cell as ``pd.read_csv`` types it and as
    ``DataFrame.iterrows`` hands it out: a frame whose every column is
    numeric gives float rows when any column is float."""
    kinds = {c: _column_type(frame.column(c)) for c in frame.columns}
    if kinds and all(k in ("int", "float") for k in kinds.values()) and "float" in kinds.values():
        kinds = dict.fromkeys(kinds, "float")
    return [{c: _cast(r.get(c), kinds[c]) for c in frame.columns} for r in frame.rows]


def _problems(frame: Frame, column: str = "Problems") -> List[Any]:
    if column not in frame.columns:
        return []
    kind = _column_type(frame.column(column))
    return [_cast(v, kind) for v in frame.column(column)]


def analyze_disease_distribution(frame: Frame) -> Dict[str, Dict[str, float]]:
    """Per-disease stats from the semicolon-separated Problems column, in
    order of first appearance: total_count, first_position_count,
    percentage_as_first, frequency (the rows of the JAX DataFrame)."""
    stats: Dict[str, Dict[str, float]] = {}
    for problems in _problems(frame):
        if not isinstance(problems, str):
            continue
        for pos, disease in enumerate(d.strip() for d in problems.split(";")):
            entry = stats.setdefault(disease, {"total_count": 0, "first_position_count": 0})
            entry["total_count"] += 1
            if pos == 0:
                entry["first_position_count"] += 1
    for entry in stats.values():
        entry["percentage_as_first"] = (
            entry["first_position_count"] / entry["total_count"] * 100.0)
        entry["frequency"] = entry["total_count"]
    return stats


def create_rich_prompts(disease_stats: Dict[str, Dict[str, float]]) -> Dict[str, List[str]]:
    """5 base templates + frequency-conditioned (>10 / >5 / else) +
    primacy-conditioned (>80% / >50% / else) templates per disease."""
    prompts: Dict[str, List[str]] = {}
    for disease, stats in disease_stats.items():
        t = [
            f"This chest X-ray shows {disease}.",
            f"The radiological findings indicate {disease}.",
            f"The image reveals characteristics of {disease}.",
            f"Diagnostic features of {disease} are present.",
            f"The X-ray demonstrates {disease}.",
        ]
        freq = stats["frequency"]
        if freq > 10:
            t += [
                f"This is a typical case of {disease}.",
                f"Clear radiological signs of {disease} are visible.",
                f"The X-ray shows classic features of {disease}.",
            ]
        elif freq > 5:
            t += [
                f"This X-ray exhibits features consistent with {disease}.",
                f"Radiological patterns suggest {disease}.",
            ]
        else:
            t += [
                f"This X-ray shows possible signs of {disease}.",
                f"Some features in this X-ray may indicate {disease}.",
            ]
        primacy = stats["percentage_as_first"]
        if primacy > 80:
            t += [
                f"The primary finding in this chest X-ray is {disease}.",
                f"This X-ray primarily shows {disease}.",
            ]
        elif primacy > 50:
            t += [
                f"One of the main findings in this X-ray is {disease}.",
                f"This X-ray shows significant evidence of {disease}.",
            ]
        else:
            t += [
                f"Among other findings, this X-ray shows {disease}.",
                f"This X-ray reveals {disease} as one of multiple conditions.",
            ]
        prompts[disease] = t
    return prompts


def disease_cooccurrence(frame: Frame) -> Dict[str, Dict[str, int]]:
    """Symmetric disease co-occurrence counts from the Problems column
    (0425/disease_analysis.py:268-289), row by row in sorted order: the JAX
    DataFrame's ``to_dict(orient="index")``."""
    counts: Counter = Counter()
    names: set = set()
    for problems in _problems(frame):
        if problems is None:
            continue
        diseases = [d.strip() for d in str(problems).split(";")]
        names.update(diseases)
        for a, b in permutations(set(diseases), 2):
            counts[(a, b)] += 1
    order = sorted(names)
    return {a: {b: counts[(a, b)] for b in order} for a in order}


def create_prediction_prompts(diseases: Sequence[str]) -> List[str]:
    return [
        "This is a normal chest X-ray without any significant findings."
        if d == "Normal"
        else f"This chest X-ray shows {d}."
        for d in diseases
    ]


def create_basic_prompts(diseases: Sequence[str]) -> List[str]:
    return [f"a chest x-ray of {d.lower()}" for d in diseases]


def create_showing_prompts(diseases: Sequence[str]) -> List[str]:
    return [f"This is a chest X-ray showing {d}." for d in diseases]


def create_enhanced_prompts_with_findings(
    frame: Frame,
    problems_col: str = "Problems",
    findings_col: str = "Findings",
) -> Dict[str, List[str]]:
    """Per-disease templates embedding each report's Findings text."""
    prompts: Dict[str, List[str]] = {}
    for row in typed_rows(frame):
        if row.get(problems_col) is None or row.get(findings_col) is None:
            continue
        findings = str(row[findings_col]).strip()
        for disease in (d.strip() for d in str(row[problems_col]).split(";")):
            prompts.setdefault(disease, []).extend([
                f"This chest X-ray shows {disease}.",
                f"The radiological findings indicate {disease}, specifically: {findings}",
                f"Based on the following observations: {findings}, this X-ray demonstrates {disease}.",
                f"The X-ray reveals {disease}, characterized by: {findings}",
                f"Diagnostic features seen in this X-ray include: {findings}, indicating {disease}.",
            ])
    return prompts


def prompts_for_family(
    family: str, diseases: Sequence[str], df: Optional[Frame] = None
) -> Dict[str, List[str]]:
    """Uniform access: disease → list of prompts. ``df`` is the reports
    table the "rich" and "findings" families are built from."""
    if family == "prediction":
        return {d: [p] for d, p in zip(diseases, create_prediction_prompts(diseases))}
    if family == "basic":
        return {d: [p] for d, p in zip(diseases, create_basic_prompts(diseases))}
    if family == "showing":
        return {d: [p] for d, p in zip(diseases, create_showing_prompts(diseases))}
    if family == "rich":
        if df is None:
            raise ValueError("rich prompts need the reports dataframe")
        rich = create_rich_prompts(analyze_disease_distribution(df))
        return {d: rich.get(d, [f"This is a chest X-ray showing {d}."]) for d in diseases}
    if family == "findings":
        if df is None:
            raise ValueError("findings prompts need the reports dataframe")
        enh = create_enhanced_prompts_with_findings(df)
        return {d: enh.get(d, [f"This is a chest X-ray showing {d}."]) for d in diseases}
    raise ValueError(f"unknown prompt family {family!r}")
