"""Synthetic-report prompt bank + report generation for image-label pretraining
(a copy of ``mammo_clip_tpu/data/prompts.py``, which imports nothing of JAX; the
port keeps its own copy rather than importing the JAX package).

The reference converts VinDr per-view finding labels into synthetic radiology sentences
sampled from a combinatorial template bank (reference:
breastclip/prompts/prompts.py:4-47 with templates in
breastclip/data/datasets/prompts.json: 11 finding types x {pos,neg} x {left,right}).
The reference's JSON is itself combinatorially generated ("there is a {qualifier}
{finding} in the {region} {side} breast at {depth} depth"); we regenerate an equivalent
bank from the grammar instead of shipping a frozen JSON — same phrase space, fewer
artifacts.

Behavioral contract (prompts.py:4-47):
* findings come as [[+right], [+left], [-right], [-left]];
* any 'No Finding' in the positive lists suppresses ALL negative sentences;
* one sentence is sampled per finding (first template when deterministic);
* sentences are deduplicated, shuffled (unless deterministic), and joined.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

VINDR_FINDINGS: List[str] = [
    "Mass",
    "Suspicious Calcification",
    "Architectural Distortion",
    "Global Asymmetry",
    "Focal Asymmetry",
    "Asymmetry",
    "Suspicious Lymph Node",
    "Nipple Retraction",
    "Skin Retraction",
    "Skin Thickening",
    "No Finding",
]

_QUALIFIERS = ["", "possible", "questionable", "questioned", "suspicious", "new",
               "irregular", "spiculated", "obscured", "indeterminant"]
_CALC_QUALIFIERS = ["", "indeterminant", "possible", "questionable", "questioned", "suspicious"]
_CALC_FORMS = ["", "clustered", "grouped", "linear", "new", "segmental"]
_REGIONS = ["", "upper", "lower", "inner", "outer", "upper inner", "upper outer",
            "lower inner", "lower outer", "subareolar"]
_DEPTHS = ["", "anterior", "mid", "posterior"]

_NO_EVIDENCE = "no mammographic evidence of malignancy"
_COMBINED_NEG = "there are no suspicious masses, suspicious calcifications or architectural distortion"

# finding -> (noun phrase, article/verb plurality, qualifier list)
_FINDING_GRAMMAR = {
    "Mass": ("mass", "is a", _QUALIFIERS),
    "Architectural Distortion": ("architectural distortion", "is", ["", "possible", "questionable", "new", "subtle"]),
    "Global Asymmetry": ("global asymmetry", "is a", ["", "new", "possible", "questionable"]),
    "Focal Asymmetry": ("focal asymmetry", "is a", ["", "new", "possible", "questionable", "developing", "persistent"]),
    "Asymmetry": ("asymmetry", "is an", ["", "new", "possible", "questionable", "developing", "persistent", "one view"]),
    "Suspicious Lymph Node": ("enlarged lymph node", "is an", ["", "new", "possible", "prominent", "dense"]),
    "Nipple Retraction": ("nipple retraction", "is", ["", "new"]),
    "Skin Retraction": ("skin retraction", "is", ["", "new", "possible", "questionable"]),
    "Skin Thickening": ("skin thickening", "is", ["", "new", "possible", "questionable", "focal"]),
}


def _phrase(article: str, qualifier: str, noun: str) -> str:
    q = f"{qualifier} " if qualifier else ""
    return f"there {article} {q}{noun}".replace("  ", " ")


def _locate(sentence: str, region: str, side: str, depth: str) -> str:
    loc = f"{region} {side}".strip()
    s = f"{sentence} in the {loc} breast"
    if depth:
        s += f" at {depth} depth"
    return s


def _positive_templates(finding: str, side: str) -> List[str]:
    out: List[str] = []
    if finding == "No Finding":
        return [
            _NO_EVIDENCE,
            _COMBINED_NEG,
            "there are no suspicious findings",
            f"the {side} breast is unremarkable",
        ]
    if finding == "Suspicious Calcification":
        for q in _CALC_QUALIFIERS:
            for form in _CALC_FORMS:
                noun = " ".join(x for x in [q, form, "calcification"] if x)
                base = f"there are {noun}"
                for region in _REGIONS:
                    for depth in _DEPTHS:
                        out.append(_locate(base, region, side, depth))
        return out
    noun, article, qualifiers = _FINDING_GRAMMAR[finding]
    for q in qualifiers:
        base = _phrase(article, q, noun)
        for region in _REGIONS:
            for depth in _DEPTHS:
                out.append(_locate(base, region, side, depth))
    return out


def _negative_templates(finding: str, side: str) -> List[str]:
    if finding == "No Finding":
        return []
    noun = {
        "Mass": "suspicious mass",
        "Suspicious Calcification": "suspicious calcification",
        "Architectural Distortion": "architectural distortion",
        "Global Asymmetry": "global asymmetry",
        "Focal Asymmetry": "focal asymmetry",
        "Asymmetry": "asymmetry",
        "Suspicious Lymph Node": "enlarged lymph node",
        "Nipple Retraction": "nipple retraction",
        "Skin Retraction": "skin retraction",
        "Skin Thickening": "skin thickening",
    }[finding]
    verb = "are" if finding == "Suspicious Calcification" else "is"
    out = [_NO_EVIDENCE, _COMBINED_NEG, f"there is no {noun} in the {side} breast"]
    # negation matrix (reference prompts_all.json neg_* structure: with/without
    # "there is", with/without the "suspicious" qualifier, verb-phrase variants)
    bare = noun.replace("suspicious ", "")
    for n in dict.fromkeys([noun, bare]):
        for prefix in (f"there {verb} no ", "no "):
            for suffix in (" seen", " present", " identified", ""):
                out.append(f"{prefix}{n}{suffix}")
    # benign located variants — a benign finding is a NEGATIVE for "suspicious X"
    # (reference: prompts_all.json 'benign ... with associated biopsy marker' rows)
    if finding in ("Mass", "Suspicious Calcification"):
        art = "there are" if verb == "are" else "there is a"
        for q in (f"benign {bare}", f"benign {bare} with associated biopsy marker"):
            base = f"{art} {q}"
            for region in _REGIONS:
                for depth in _DEPTHS:
                    out.append(_locate(base, region, side, depth))
    return out


def build_prompt_bank() -> Dict[str, Dict[str, List[str]]]:
    """finding -> {pos_right, pos_left, neg_right, neg_left} template lists."""
    bank: Dict[str, Dict[str, List[str]]] = {}
    for f in VINDR_FINDINGS:
        bank[f] = {
            "pos_right": _positive_templates(f, "right"),
            "pos_left": _positive_templates(f, "left"),
            "neg_right": _negative_templates(f, "right"),
            "neg_left": _negative_templates(f, "left"),
        }
    return bank


def generate_report_from_labels(
    findings: Sequence[Sequence[str]],
    prompt_bank: Dict[str, Dict[str, List[str]]],
    deterministic: bool = False,
    rng: Optional[random.Random] = None,
) -> str:
    """[[+right],[+left],[-right],[-left]] finding lists -> synthetic report string.

    Matches reference prompts.py:4-47: 'No Finding' in either positive list clears the
    negative lists; deterministic mode takes template[0] and keeps sentence order.
    """
    rng = rng or random
    pos_right, pos_left, neg_right, neg_left = (list(x) for x in findings)
    if "No Finding" in pos_right or "No Finding" in pos_left:
        neg_right, neg_left = [], []

    report: List[str] = []
    for labels, key in (
        (pos_right, "pos_right"),
        (pos_left, "pos_left"),
        (neg_right, "neg_right"),
        (neg_left, "neg_left"),
    ):
        for name in labels:
            candidates = prompt_bank[name][key]
            if not candidates:
                continue
            sentence = candidates[0] if deterministic else rng.choice(candidates)
            if sentence:
                report.append(sentence)

    # dedup preserving insertion order (the reference uses set(), which is
    # order-unstable; deterministic mode here is genuinely deterministic)
    seen = set()
    unique = [s for s in report if not (s in seen or seen.add(s))]
    if not deterministic:
        rng.shuffle(unique)
    return " ".join(unique)
