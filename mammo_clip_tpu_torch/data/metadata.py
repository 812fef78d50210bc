"""CSV metadata layer (port of ``mammo_clip_tpu/data/metadata.py``).

The JAX package reads the CSVs with pandas; the card machine has none, so the
port reads them with the standard library's ``csv`` into a ``Table``: a list of
row dicts that also carries its column names. The loading rules are pandas'
as the JAX module uses them:

* a column whose non-empty cells all parse as integers holds ints, or floats
  when some cells are empty (pandas' NaN turns the column float); a column
  whose non-empty cells all parse as floats holds floats; empty numeric cells
  become 0 (``fillna(0)``, reference datamodule.py:33-41); any other column
  holds strings, with None for an empty cell (pandas' NaN);
* ``patient_id``, ``image_id`` and ``study_id`` stay the strings in the file;
* list-typed columns (image/view/text/CC/MLO/*_FINDING) hold python-list
  literals and are parsed once here;
* split selection: a ``split`` column (VinDr) gives train <- 'training' and
  valid/test <- 'test'; a ``fold`` column gives train <- fold != cur_fold and
  valid <- fold == cur_fold (datamodule.py:59-64);
* ``subsample`` draws the rows ``DataFrame.sample(frac, random_state=seed)``
  draws (numpy's RandomState permutation).

``write_table`` is the counterpart of ``DataFrame.to_csv(index=False)``: the
same bytes for the columns the port's preprocessing writes (strings, ints,
float64 and float32, lists as ``str(list)``, None and NaN as empty cells).
"""

from __future__ import annotations

import ast
import csv
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

LIST_COLUMNS = [
    "image", "view", "CC", "MLO", "text", "text_augment",
    "CC_FINDING", "MLO_FINDING", "finding_categories",
]
ID_COLUMNS = ("patient_id", "image_id", "study_id")


class Table(list):
    """Rows (dicts keyed by column name) plus the column names in file order."""

    def __init__(self, rows: Iterable[Dict[str, Any]] = (), columns: Sequence[str] = ()):
        super().__init__(rows)
        self.columns = tuple(columns)

    def select(self, indices: Iterable[int]) -> "Table":
        return Table((self[i] for i in indices), self.columns)


def parse_list_cell(value: Any) -> List:
    """Parse a CSV cell that may hold a python-list literal or a scalar."""
    if isinstance(value, list):
        return value
    if isinstance(value, str):
        s = value.strip()
        if s.startswith("[") and s.endswith("]"):
            try:
                parsed = ast.literal_eval(s)
                return list(parsed) if isinstance(parsed, (list, tuple)) else [parsed]
            except (ValueError, SyntaxError):
                return [value]
        return [value]
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return []
    return [value]


def _parses(cells: List[str], kind) -> bool:
    try:
        for c in cells:
            kind(c)
    except ValueError:
        return False
    return True


def _column(cells: List[str]) -> List[Any]:
    """One column's typed values (see the module docstring)."""
    present = [c for c in cells if c != ""]
    missing = len(present) < len(cells)
    if present and _parses(present, int):
        kind = float if missing else int
    elif present and _parses(present, float):
        kind = float
    else:
        return [c if c != "" else None for c in cells]
    return [kind(c) if c != "" else kind(0) for c in cells]


def load_metadata(path: str, parse_lists: bool = True) -> Table:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        raw = [r + [""] * (len(header) - len(r)) for r in reader]
    columns = {}
    for j, name in enumerate(header):
        cells = [r[j] for r in raw]
        if name in ID_COLUMNS:
            columns[name] = cells
        else:
            columns[name] = _column(cells)
            if parse_lists and name in LIST_COLUMNS:
                columns[name] = [parse_list_cell(v) for v in columns[name]]
    rows = [{name: columns[name][i] for name in header} for i in range(len(raw))]
    return Table(rows, header)


def split_dataframe(table: Table, split: str, cur_fold: int = 0) -> Table:
    """train/valid selection (reference datamodule.py:59-64)."""
    if split not in ("train", "valid", "test"):
        raise ValueError(f"unknown split: {split}")
    if "split" in table.columns:
        want = "training" if split == "train" else "test"
        keep = [i for i, r in enumerate(table) if r["split"] == want]
    elif "fold" in table.columns:
        train = split == "train"
        keep = [i for i, r in enumerate(table) if (r["fold"] != cur_fold) == train]
    else:
        keep = range(len(table))
    return table.select(keep)


def subsample(table: Table, data_frac: float, seed: int = 0) -> Table:
    """Reference's base.data_frac knob: the rows pandas' ``sample`` would keep."""
    if data_frac >= 1.0:
        return table
    n = len(table)
    order = np.random.RandomState(seed).choice(n, size=round(data_frac * n), replace=False)
    return table.select(int(i) for i in order)


def format_cell(value: Any) -> str:
    """One cell as ``DataFrame.to_csv`` writes it: None and NaN empty, a numpy
    float32 in numpy's shortest form (``str(np.float32(v))``), any other value
    (a list too) as ``str``."""
    if value is None:
        return ""
    if isinstance(value, (float, np.floating)) and np.isnan(value):
        return ""
    return str(value)


def write_table(table: Table, path: str) -> None:
    """Write ``table`` as pandas' ``to_csv(index=False)`` would: the standard
    library's csv writer with QUOTE_MINIMAL quoting and ``\n`` line ends. Each
    column must hold one type, as in a DataFrame (pandas writes an int in a
    float column as a float)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(table.columns)
        for row in table:
            w.writerow([format_cell(row.get(c)) for c in table.columns])
