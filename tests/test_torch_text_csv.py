"""The port's report and VinDr CSV builders (``mammo_clip_tpu_torch/preprocess/
text.py``, ``vindr_csv.py``) and its CSV writer (``data.metadata.write_table``)
against the JAX package's pandas code.

Each package reads the same CSV with its own ``load_metadata`` (pandas there,
``csv`` here); the rows must be equal (float32-equal for the rescaled boxes)
and ``write_table``'s bytes must be ``DataFrame.to_csv(index=False)``'s. The
cases cover ids ``"9"`` / ``"10"`` (pandas' groupby sorts them as strings), a
missing laterality (the row is dropped), an empty report, and the rule
paraphraser's output. Nothing here runs torch.
"""

import csv
import math
import sys

import numpy as np
import pandas as pd
import pytest

from mammo_clip_tpu.data.metadata import load_metadata as jax_load_metadata
from mammo_clip_tpu.preprocess import text as jax_text
from mammo_clip_tpu.preprocess import vindr_csv as jax_vindr
from mammo_clip_tpu_torch.data.metadata import Table, load_metadata, write_table
from mammo_clip_tpu_torch.preprocess import text, vindr_csv

REPORTS = [
    "FINDINGS: There is a MASS in the upper outer quadrant. Ok. No evidence of calcification.",
    "The breast is unremarkable. Scattered calcifications are seen in the left breast.",
    "",
    "Café report with ’weird’ chars here. Consistent with benign findings overall.",
    "a spiculated mass is noted in the upper outer quadrant. no suspicious calcification "
    "is identified.",
]


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def report_csv(tmp_path_factory):
    """One row per image: patients "9", "10", "11", "2" (string order differs
    from numeric), both lateralities, one row without a laterality, one
    patient whose first report is empty."""
    rows = []
    for k, pid in enumerate(["9", "10", "11", "2", "10", "9"]):
        for j, (lat, view) in enumerate([("L", "CC"), ("L", "MLO"), ("R", "CC")]):
            rows.append({"patient_id": pid, "laterality": lat, "image_id": f"{pid}_{k}{j}",
                         "view_position": view,
                         "findings": REPORTS[(k + j) % len(REPORTS)],
                         "impressions": REPORTS[(k + 2 * j + 1) % len(REPORTS)]})
    rows.append({"patient_id": "11", "laterality": "", "image_id": "11_x",
                 "view_position": "CC", "findings": REPORTS[0], "impressions": ""})
    return _write(tmp_path_factory.mktemp("reports") / "reports.csv", rows)


def _same(a, b):
    """Cell equality with NaN (pandas) equal to None (the port)."""
    if isinstance(a, float) and math.isnan(a):
        return b is None or (isinstance(b, float) and math.isnan(b))
    return a == b


def _assert_rows_equal(df: pd.DataFrame, table: Table):
    assert list(df.columns) == list(table.columns)
    assert len(df) == len(table)
    for want, got in zip(df.to_dict("records"), table):
        for c in df.columns:
            assert _same(want[c], got[c]), (c, want[c], got[c])


def _assert_same_bytes(df: pd.DataFrame, table: Table, tmp_path, name):
    df.to_csv(tmp_path / f"{name}_pandas.csv", index=False)
    write_table(table, str(tmp_path / f"{name}_port.csv"))
    assert (tmp_path / f"{name}_port.csv").read_bytes() == \
        (tmp_path / f"{name}_pandas.csv").read_bytes()


def test_clean_report_segment_matches_jax():
    for raw in REPORTS + ["nan", "None", "  ", "One two three! Four five. six seven eight?"]:
        for min_words in (1, 3):
            assert text.clean_report_segment(raw, min_words) == \
                jax_text.clean_report_segment(raw, min_words)
    assert text.clean_report_segment(None) == jax_text.clean_report_segment(None) == ""


@pytest.mark.parametrize("view_col", ["view_position", "view"])
def test_build_pretrain_rows_and_folds_match_jax(report_csv, tmp_path, view_col):
    """build_pretrain_rows + assign_group_folds on each package's own reading of
    the CSV: the same groups in the same order ("10" < "11" < "2" < "9"), the
    row without a laterality dropped, the empty report cleaned to nothing.
    With ``view_col="view"`` the views are list cells (as ``load_metadata``
    parses a ``view`` column), so, in both packages, no view is CC or MLO."""
    df, tab = jax_load_metadata(report_csv), load_metadata(report_csv)
    if view_col == "view":
        df["view"] = df["view_position"].map(lambda v: [v])
        tab = Table([dict(r, view=[r["view_position"]]) for r in tab], (*tab.columns, "view"))
    want = jax_text.build_pretrain_rows(df, view_col=view_col)
    got = text.build_pretrain_rows(tab, view_col=view_col)
    assert [(r["patient_id"], r["laterality"]) for r in got] == [
        (p, lat) for p in ("10", "11", "2", "9") for lat in ("L", "R")]
    _assert_rows_equal(want, got)
    assert all("11_x" not in r["image"] for r in got)
    assert any(r["impressions"] == "" for r in got) or any(r["findings"] == "" for r in got)
    for n_folds, seed in ((2, 0), (4, 3)):
        _assert_rows_equal(jax_text.assign_group_folds(want, n_folds=n_folds, seed=seed),
                           text.assign_group_folds(got, n_folds=n_folds, seed=seed))
    _assert_same_bytes(jax_text.assign_group_folds(want), text.assign_group_folds(got),
                       tmp_path, "pretrain")


def test_missing_report_cleans_like_pandas_nan():
    """A report cell missing in the file is NaN in pandas and None in the port;
    both clean to "" (pandas' str(nan) is "nan", one word)."""
    df = pd.DataFrame({"patient_id": ["1"], "laterality": ["L"], "image_id": ["a"],
                       "view": ["CC"], "findings": [np.nan], "impressions": ["x y z w."]})
    tab = Table([{"patient_id": "1", "laterality": "L", "image_id": "a", "view": "CC",
                  "findings": None, "impressions": "x y z w."}], df.columns)
    _assert_rows_equal(jax_text.build_pretrain_rows(df), text.build_pretrain_rows(tab))
    assert text.build_pretrain_rows(tab)[0]["findings"] == ""


class _NoWeights:
    """A translator without MarianMT weights, as both packages' BackTranslator
    is offline: augment_pretrain_csv then takes the rule paraphraser."""

    available = False


def test_back_translator_degrades_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # an import raises
    with pytest.warns(UserWarning, match="MarianMT weights unavailable"):
        bt = text.BackTranslator()
    assert not bt.available and bt("some text") == "some text"


def test_paraphraser_and_augment_match_jax(report_csv, tmp_path):
    texts = [text.clean_report_segment(r) for r in REPORTS if r] + [
        "there is no evidence of mass. the breast is unremarkable. scattered "
        "calcifications are seen in the left breast."]
    for seed in (0, 1, 7):
        ours, ref = text.RuleParaphraser(seed), jax_text.RuleParaphraser(seed)
        assert [ours(t) for t in texts] == [ref(t) for t in texts]
    bt_ours = bt_ref = _NoWeights()
    df = jax_text.build_pretrain_rows(jax_load_metadata(report_csv), view_col="view_position")
    tab = text.build_pretrain_rows(load_metadata(report_csv), view_col="view_position")
    want = jax_text.augment_pretrain_csv(jax_text.assign_group_folds(df), bt_ref)
    got = text.augment_pretrain_csv(text.assign_group_folds(tab), bt_ours)
    _assert_rows_equal(want, got)
    assert any(a != t for r in got for a, t in zip(r["text_augment"], r["text"]))
    _assert_same_bytes(want, got, tmp_path, "augmented")
    # the written CSV reads back the same in both packages
    write_table(got, str(tmp_path / "back.csv"))
    _assert_rows_equal(jax_load_metadata(str(tmp_path / "back.csv")),
                       load_metadata(str(tmp_path / "back.csv")))


@pytest.fixture(scope="module")
def annotation_csv(tmp_path_factory):
    """finding_annotations-style rows: studies "9" and "10", both views, a
    study with a missing laterality row, boxes for some findings."""
    rng = np.random.default_rng(4)
    rows = []
    cats = [["Mass"], ["Mass", "Skin Thickening"], ["No Finding"], ["Suspicious Calcification"],
            ["Unknown"], ["Focal Asymmetry", "Mass"]]
    for k, (sid, lat, view) in enumerate([("9", "R", "CC"), ("9", "R", "MLO"), ("10", "L", "CC"),
                                          ("10", "L", "CC"), ("10", "R", "MLO"),
                                          ("12", "", "CC"), ("2", "L", "MLO")]):
        x0, y0 = (float(v) for v in rng.uniform(50, 900, 2))
        rows.append({"study_id": sid, "laterality": lat, "image_id": f"img{k if k != 3 else 2}",
                     "view_position": view, "finding_categories": str(cats[k % len(cats)]),
                     "xmin": round(x0, 2), "ymin": round(y0, 2), "xmax": round(x0 + 123.4, 2),
                     "ymax": round(y0 + 77.7, 2), "split": "training" if k < 4 else "test"})
    return _write(tmp_path_factory.mktemp("vindr") / "finding_annotations.csv", rows)


def test_build_vindr_clip_csv_matches_jax(annotation_csv, tmp_path):
    want = jax_vindr.build_vindr_clip_csv(jax_load_metadata(annotation_csv))
    got = vindr_csv.build_vindr_clip_csv(load_metadata(annotation_csv))
    assert [(r["patient_id"], r["laterality"]) for r in got] == [
        ("10", "L"), ("10", "R"), ("2", "L"), ("9", "R")]
    _assert_rows_equal(want, got)
    assert got[0]["CC"] == ["img2"]  # one image id, listed once
    _assert_same_bytes(want, got, tmp_path, "vindr_clip")


def test_rescale_detection_boxes_matches_jax(annotation_csv, tmp_path):
    """float32-equal boxes; an image missing from the bounds passes through."""
    bounds_rows = [{"image_id": f"img{k}", "y0": 10 * k, "y1": 2000 + 7 * k, "x0": 3 * k,
                    "x1": 1100 - k} for k in range(6) if k != 4]
    bounds_path = _write(tmp_path / "bounds.csv", bounds_rows)
    for out_size in ((512, 512), (1520, 912)):
        want = jax_vindr.rescale_detection_boxes(jax_load_metadata(annotation_csv),
                                                 jax_load_metadata(bounds_path), out_size)
        got = vindr_csv.rescale_detection_boxes(load_metadata(annotation_csv),
                                                load_metadata(bounds_path), out_size)
        _assert_rows_equal(want, got)
        for c in vindr_csv.BOX_COLUMNS:
            assert want[c].dtype == np.float32
            col = np.asarray([r[c] for r in got])
            assert col.dtype == np.float32
            np.testing.assert_array_equal(col, want[c].to_numpy())
        _assert_same_bytes(want, got, tmp_path, f"boxes{out_size[0]}")


def test_rescale_passes_nan_boxes_through():
    ann = {"image_id": ["a", "b", "c"], "xmin": [100.0, np.nan, 5.0],
           "ymin": [200.0, 3.0, 6.0], "xmax": [300.0, 4.0, 7.0], "ymax": [400.0, 5.0, 8.0]}
    bounds = {"image_id": ["a", "b"], "y0": [100, 0], "y1": [1100, 9], "x0": [50, 0],
              "x1": [550, 9]}
    want = jax_vindr.rescale_detection_boxes(pd.DataFrame(ann), pd.DataFrame(bounds),
                                             out_size=(2000, 1000))
    tab = lambda d: Table([dict(zip(d, v)) for v in zip(*d.values())], list(d))  # noqa: E731
    got = vindr_csv.rescale_detection_boxes(
        tab({**ann, "xmin": [100.0, None, 5.0]}), tab(bounds), out_size=(2000, 1000))
    assert got[0]["resized_xmin"] == (100 - 50) * 2 and got[0]["resized_ymax"] == (400 - 100) * 2
    assert np.isnan(got[1]["resized_xmin"]) and got[1]["resized_ymin"] == np.float32(3.0)
    assert got[2]["resized_xmax"] == np.float32(7.0)  # no bounds: unchanged
    for c in vindr_csv.BOX_COLUMNS:
        np.testing.assert_array_equal(np.asarray([r[c] for r in got]), want[c].to_numpy())


def test_write_table_matches_to_csv(tmp_path):
    """The cells the preprocessing writes: strings needing quotes, ints,
    float64 and float32 (numpy's shortest form), lists, booleans, missing
    cells; and the frames of no rows pandas writes."""
    cols = {
        "s": ["plain", "a,b", 'q"u', "two\nlines", None, " lead", ""],
        "i": [0, -3, 7, 12345678901, 5, 6, 1],
        "f64": [1 / 3, 1.0, 1e-7, 1e20, np.nan, 0.1 + 0.2, -2.5],
        "f32": list(np.float32([1 / 3, 1.0, 100.5, 1e-7, 123456789.0, np.nan, 2.5e20])),
        "lst": [["a", "b"], [], [["Mass"], []], ["x, y"], [1.5, 2], ["it's"], ['say "hi"']],
        "b": [True, False, True, True, False, False, True],
    }
    df = pd.DataFrame(cols).astype({"f32": np.float32})
    tab = Table([dict(zip(cols, v)) for v in zip(*cols.values())], list(cols))
    _assert_same_bytes(df, tab, tmp_path, "cells")
    _assert_same_bytes(pd.DataFrame({"only": [np.nan, 1.5]}),
                       Table([{"only": None}, {"only": 1.5}], ["only"]), tmp_path, "single")
    _assert_same_bytes(pd.DataFrame([]), Table(), tmp_path, "empty")
    _assert_same_bytes(pd.DataFrame(columns=["a", "b"]), Table([], ["a", "b"]), tmp_path,
                       "header_only")
