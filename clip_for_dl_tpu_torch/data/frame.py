"""A minimal table on the standard library's ``csv``: what the port's data
side needs of pandas, which the GPU machine's port may not import.

A :class:`Frame` is a column order and a list of row dicts. :func:`read_csv`
reads cells as strings, with pandas' default missing-value strings (the
empty cell among them) read as None, so that ``pd.isna`` / ``pd.notna``
tests become ``is None`` tests; :func:`write_csv` writes None as the empty
cell, as ``DataFrame.to_csv`` writes NaN. A file this module writes reads
back under ``pd.read_csv`` to the frame pandas would have written.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Any, Callable, Dict, Iterable, List

# pandas.read_csv's default na_values
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


@dataclasses.dataclass
class Frame:
    columns: List[str]
    rows: List[Dict[str, Any]]

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        return [r.get(name) for r in self.rows]

    def where(self, keep: Callable[[Dict[str, Any]], bool]) -> "Frame":
        """The rows for which ``keep`` holds, in order."""
        return Frame(list(self.columns), [r for r in self.rows if keep(r)])


def read_csv(path: str) -> Frame:
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = [{k: (None if v in NA_STRINGS else v) for k, v in zip(header, line)}
                for line in reader if line]
    return Frame(list(header), rows)


def _cell(v: Any) -> str:
    return "" if v is None else str(v)


def write_csv(frame: Frame, path: str) -> str:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(frame.columns)
        w.writerows([_cell(r.get(c)) for c in frame.columns] for r in frame.rows)
    return path


def key(v: Any) -> Any:
    """A join key as pandas compares it: an integer cell as its int."""
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            return v
    return v


def number(v: Any) -> float:
    """A numeric cell's value (a label column's 0/1)."""
    return float(v)


def merge(left: Frame, right: Frame, on: str) -> Frame:
    """``pd.merge(left, right, on=on, how="inner")``: for each left row in
    order, its matches in ``right`` in order; left columns, then the right's
    other columns. Neither frame may share another column name."""
    shared = (set(left.columns) & set(right.columns)) - {on}
    if shared:
        raise ValueError(f"merge: columns {sorted(shared)} are on both sides")
    index: Dict[Any, List[Dict[str, Any]]] = {}
    for r in right.rows:
        index.setdefault(key(r[on]), []).append(r)
    columns = list(left.columns) + [c for c in right.columns if c != on]
    rows = [{**lr, **{c: rr[c] for c in right.columns if c != on}}
            for lr in left.rows for rr in index.get(key(lr[on]), ())]
    return Frame(columns, rows)


def unique(values: Iterable[Any]) -> List[Any]:
    """``Series.unique()``: distinct values in order of first appearance."""
    seen: Dict[Any, None] = {}
    for v in values:
        seen.setdefault(v, None)
    return list(seen)


def rename(frame: Frame, names: Dict[str, str]) -> Frame:
    return Frame([names.get(c, c) for c in frame.columns],
                 [{names.get(k, k): v for k, v in r.items()} for r in frame.rows])

