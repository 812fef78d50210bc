"""Zero-shot prompt classification (port of ``mammo_clip_tpu/eval/zeroshot.py``;
reference: evaluator.py:146-194).

For each label, embed its prompt pair (e.g. ["no mass", "mass"]; prompts from
configs/zs_clip.yaml:28-39), compute softmax over the raw cosine similarities
between image embeddings and the prompt embeddings (no logit scale), then score:
* mass / suspicious_calcification / cancer / malignancy -> AUROC of the positive column;
* density -> argmax accuracy over 4 prompt classes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy.special import softmax

from .metrics import accuracy, auroc

# default prompt pairs, mirroring configs/zs_clip.yaml:28-39
DEFAULT_ZS_PROMPTS: Dict[str, Dict[str, List[str]]] = {
    "vindr": {
        "mass": ["no mass", "mass"],
        "suspicious_calcification": ["no suspicious calcification", "suspicious calcification"],
    },
    "rsna": {
        "malignancy": ["no malignancy", "malignancy"],
    },
}

# label name used in embeddings dict per prompt key (evaluator.py:175-190)
_LABEL_KEY = {
    "mass": "mass",
    "suspicious_calcification": "calc",
    "cancer": "cancer",
    "malignancy": "cancer",
    "density": "density",
}


def eval_zeroshot(
    extractor,
    tokenizer,
    image_embeddings: np.ndarray,
    labels: Dict[str, np.ndarray],
    zs_prompts: Dict[str, Sequence[str]],
    max_length: int = 256,
) -> Dict[str, float]:
    """extractor: eval.EmbeddingExtractor; labels: e.g. {'mass': (N,), 'calc': (N,)}."""
    results: Dict[str, float] = {}
    for label_text, prompts in zs_prompts.items():
        enc = tokenizer(list(prompts), max_length=max_length)
        text_emb = extractor.encode_texts(enc["input_ids"], enc["attention_mask"])
        # embeddings are L2-normalized, so cosine similarity = dot product
        sims = softmax(image_embeddings @ text_emb.T, axis=1)
        key = _LABEL_KEY.get(label_text.lower())
        if key is None or key not in labels:
            continue
        y = np.asarray(labels[key])
        if label_text.lower() == "density":
            results[label_text] = accuracy(y, np.argmax(sims, axis=1))
        else:
            results[label_text] = auroc(y, sims[:, 1])
    return results
