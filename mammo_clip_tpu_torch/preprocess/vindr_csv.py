"""VinDr metadata builders (port of ``mammo_clip_tpu/preprocess/vindr_csv.py``
over the port's ``data.metadata.Table``).

Replaces the reference's preprocess-clip notebook (reference:
notebooks/preprocess-clip/VinDr.ipynb cells 4-18) and the detector bbox-rescale
script (preprocess_VinDr_detector.py:61-126):

* ``build_vindr_clip_csv``: finding_annotations.csv -> per (study, laterality) rows
  with CC/MLO image lists and ``[[+right], [+left], [-right], [-left]]`` finding
  lists (the image-label pretraining schema consumed by ImageTextDataset);
* ``rescale_detection_boxes``: remap GT boxes through the stored crop bounds into the
  resized frame (resized_{x,y}{min,max} columns, float32).

The annotation rows come from the port's ``load_metadata``, which parses
``finding_categories`` into lists; groups follow pandas' ``groupby`` (sorted
keys, rows with a missing key dropped).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..data.metadata import Table
from ..data.prompts import VINDR_FINDINGS
from .breast_crop import remap_boxes
from .text import _pd_str, _with_column, group_rows

BOX_COLUMNS = ("resized_xmin", "resized_ymin", "resized_xmax", "resized_ymax")


def _findings_of(rows: Sequence[dict], has_column: bool) -> List[str]:
    cats: List[str] = []
    for r in rows if has_column else ():
        v = r["finding_categories"]
        vals = v if isinstance(v, list) else [v]
        for c in vals:
            if c in VINDR_FINDINGS and c not in cats:
                cats.append(c)
    return cats or ["No Finding"]


def build_vindr_clip_csv(annotations: Table) -> Table:
    """finding_annotations-style rows -> image-label pretraining rows."""
    has_findings = "finding_categories" in annotations.columns
    rows = []
    for (study, lat), g in group_rows(annotations, ["study_id", "laterality"]):
        views: Dict[str, List[str]] = {"CC": [], "MLO": []}
        view_findings: Dict[str, List[str]] = {}
        for view in ("CC", "MLO"):
            sub = [r for r in g if r["view_position"] == view]
            views[view] = list(dict.fromkeys(_pd_str(r["image_id"]) for r in sub))
            view_findings[view] = _findings_of(sub, has_findings) if sub else ["No Finding"]
        present = [v for v in ("CC", "MLO") if views[v]]
        if not present:
            continue

        def finding_struct(view: str) -> List[List[str]]:
            pos = view_findings.get(view, ["No Finding"])
            neg = [f for f in VINDR_FINDINGS if f not in pos and f != "No Finding"]
            right = pos if lat == "R" else []
            left = pos if lat == "L" else []
            neg_right = neg if lat == "R" else []
            neg_left = neg if lat == "L" else []
            return [right, left, neg_right, neg_left]

        rows.append(
            {
                "patient_id": study,
                "laterality": lat,
                "image": [i for v in present for i in views[v]],
                "view": present,
                "CC": views["CC"],
                "MLO": views["MLO"],
                "CC_FINDING": finding_struct("CC"),
                "MLO_FINDING": finding_struct("MLO"),
                "split": g[0]["split"] if "split" in annotations.columns else "training",
            }
        )
    return Table(rows, tuple(rows[0]) if rows else ())


def _coord(value) -> float:
    return np.nan if value is None else value


def rescale_detection_boxes(
    annotations: Table,
    bounds: Table,  # image_id, y0, y1, x0, x1 from the DICOM tool
    out_size=(1520, 912),
) -> Table:
    """Add resized_{x,y}{min,max} columns (float32) by replaying crop+resize per
    image; a box with a NaN, or of an image missing from ``bounds``, passes
    through unchanged."""
    bmap = {str(r["image_id"]): (int(r["y0"]), int(r["y1"]), int(r["x0"]), int(r["x1"]))
            for r in bounds}
    rows = []
    for r in annotations:
        b = bmap.get(str(r["image_id"]))
        box = np.asarray([[_coord(r[k]) for k in ("xmin", "ymin", "xmax", "ymax")]], np.float32)
        if b is not None and not np.any(np.isnan(box)):
            box = remap_boxes(box, b, out_size)
        rows.append(dict(r, **dict(zip(BOX_COLUMNS, box[0]))))
    columns = annotations.columns
    for c in BOX_COLUMNS:
        columns = _with_column(columns, c)
    return Table(rows, columns)
