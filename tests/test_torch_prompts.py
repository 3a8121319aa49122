"""Parity of the port's report-built prompt families
(clip_for_dl_tpu_torch/zeroshot/prompts.py, on ``data.frame.Frame``) with
the JAX package's (on pandas): the same strings in the same order, on the
Kaggle layout's reports (``testing/kaggle.py``) and on hand-made tables
with missing cells, repeated diseases, an empty Problems cell and Findings
that pandas reads as numbers."""

import numpy as np
import pandas as pd
import pytest

from clip_for_dl_tpu.core.config import DISEASE_LABELS
from clip_for_dl_tpu.zeroshot import prompts as jp
from clip_for_dl_tpu_torch.data.frame import read_csv, rename
from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
from clip_for_dl_tpu_torch.zeroshot import prompts as pp

# Problems: a repeat, an empty cell, "NA" (pandas' missing value), an empty
# disease after a trailing ";", a case that differs only in case. Findings:
# numbers in a column that also has an empty cell (pandas: float, "1.0"),
# text with a comma inside quotes.
HAND = """uid,Problems,Findings,MeSH
1,Cardiomegaly;Pleural Effusion,"Heart is enlarged, effusion.",a
2,Cardiomegaly,The heart is large.,b
3,,No findings.,c
4,NA,Something,d
5,Nodule;,Small nodule.,e
6,normal,,f
7,Cardiomegaly;Nodule;Mass,Mixed picture,g
8,Pleural Effusion;Cardiomegaly,Fluid,h
9,nodule,lower case,i
"""
NUMERIC = """uid,Problems,Findings
1,Cardiomegaly,1
2,Nodule;Mass,2
3,Cardiomegaly;Nodule,
4,Mass,3.5
5,Cardiomegaly,0042
"""
INTS = """Problems,Findings
Cardiomegaly,1
Mass;Nodule,7
"""
ALL_NUMERIC = """uid,Problems,Findings
1,3,1
2,4,2.5
"""
BOOLS = """Problems,Findings
Cardiomegaly,True
Mass,false
"""


@pytest.fixture(scope="module")
def kaggle(tmp_path_factory):
    root = tmp_path_factory.mktemp("kaggle")
    paths = write_kaggle_layout(str(root), n_uids=40, empty_findings_every=7)
    return paths["reports"]


def _tables(tmp_path, text):
    path = tmp_path / "t.csv"
    path.write_text(text)
    return pd.read_csv(path), read_csv(str(path))


CASES = ["hand", "numeric", "ints", "all_numeric", "bools"]
TEXTS = dict(zip(CASES, [HAND, NUMERIC, INTS, ALL_NUMERIC, BOOLS]))


@pytest.mark.parametrize("case", CASES)
def test_typed_rows_read_cells_as_pandas_iterrows_gives_them(tmp_path, case):
    df, frame = _tables(tmp_path, TEXTS[case])
    want = [{c: (None if pd.isna(v) else v) for c, v in row.items()} for _, row in df.iterrows()]
    got = pp.typed_rows(frame)
    assert [{c: str(v) for c, v in r.items()} for r in got] == \
        [{c: str(v) for c, v in r.items()} for r in want]


@pytest.mark.parametrize("case", CASES)
def test_analyze_disease_distribution_matches_jax(tmp_path, case):
    df, frame = _tables(tmp_path, TEXTS[case])
    want = jp.analyze_disease_distribution(df)
    got = pp.analyze_disease_distribution(frame)
    assert list(got) == list(want.index)
    assert got == want.to_dict(orient="index")


@pytest.mark.parametrize("case", CASES)
def test_disease_cooccurrence_matches_jax(tmp_path, case):
    df, frame = _tables(tmp_path, TEXTS[case])
    want = jp.disease_cooccurrence(df)
    got = pp.disease_cooccurrence(frame)
    assert list(got) == list(want.index)
    assert got == {a: {b: int(n) for b, n in row.items()}
                   for a, row in want.to_dict(orient="index").items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("family", ["rich", "findings"])
def test_report_families_match_jax_on_hand_made_tables(tmp_path, case, family):
    df, frame = _tables(tmp_path, TEXTS[case])
    diseases = list(DISEASE_LABELS) + ["Nodule", "Mass", "", "nodule"]
    assert pp.prompts_for_family(family, diseases, frame) == \
        jp.prompts_for_family(family, diseases, df)


def test_numeric_findings_read_as_pandas_does(tmp_path):
    """The difference the hand-made table shows: the csv module reads "1"
    and "0042", pandas reads a float column (an empty cell makes it float)
    and the JAX prompts say "1.0" and "42.0"; the port says the same."""
    df, frame = _tables(tmp_path, NUMERIC)
    got = pp.create_enhanced_prompts_with_findings(frame)
    assert got == jp.create_enhanced_prompts_with_findings(df)
    assert "The X-ray reveals Cardiomegaly, characterized by: 1.0" in got["Cardiomegaly"]
    assert "The X-ray reveals Cardiomegaly, characterized by: 42.0" in got["Cardiomegaly"]


@pytest.mark.parametrize("findings_col", ["findings", "Findings"])
def test_report_families_match_jax_on_the_kaggle_reports(kaggle, findings_col):
    """The raw reports name the column "findings": the JAX function's
    default "Findings" finds nothing there, so every disease falls back;
    renamed, each report's findings enter its diseases' prompts."""
    df = pd.read_csv(kaggle).rename(columns={"findings": findings_col})
    frame = rename(read_csv(kaggle), {"findings": findings_col})
    for family in ("rich", "findings"):
        got = pp.prompts_for_family(family, DISEASE_LABELS, frame)
        assert got == jp.prompts_for_family(family, DISEASE_LABELS, df)
    enh = pp.create_enhanced_prompts_with_findings(frame)
    assert enh == jp.create_enhanced_prompts_with_findings(df)
    assert bool(enh) == (findings_col == "Findings")
    stats = pp.analyze_disease_distribution(frame)
    assert stats == jp.analyze_disease_distribution(df).to_dict(orient="index")
    assert np.sum([s["total_count"] for s in stats.values()]) > 40


@pytest.mark.parametrize("family", ["rich", "findings"])
def test_without_the_table_both_packages_raise_the_same_error(family):
    with pytest.raises(ValueError) as want:
        jp.prompts_for_family(family, DISEASE_LABELS)
    with pytest.raises(ValueError) as got:
        pp.prompts_for_family(family, DISEASE_LABELS)
    assert str(got.value) == str(want.value) == f"{family} prompts need the reports dataframe"


@pytest.mark.parametrize("family", ["prediction", "basic", "showing", "unknown"])
def test_the_other_families_match_jax(family):
    if family == "unknown":
        with pytest.raises(ValueError, match="unknown prompt family"):
            pp.prompts_for_family(family, DISEASE_LABELS)
        return
    assert pp.prompts_for_family(family, DISEASE_LABELS) == \
        jp.prompts_for_family(family, DISEASE_LABELS)
