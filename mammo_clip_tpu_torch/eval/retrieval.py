"""Image->text retrieval recall@K (port of ``mammo_clip_tpu/eval/retrieval.py``;
reference: evaluator.py:197-252).

Texts are deduplicated in first-seen order; for each image the rank of its
paired (deduped) text among all unique texts is computed from cosine
similarity. Reports Recall@{1,5,10,15} and mean rank. It runs on the host in
numpy, with ``np.argsort``'s default kind, so that tied similarities rank as
they do in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def eval_image_text_retrieval(
    image_embeddings: np.ndarray,
    text_embeddings: np.ndarray,
    texts: Sequence[str],
    recall_ks: Sequence[int] = (1, 5, 10, 15),
) -> Dict[str, Dict[str, float]]:
    texts = list(texts)
    unique: Dict[str, int] = {}
    keep_rows: List[int] = []
    labels = np.empty(len(texts), np.int64)
    for i, t in enumerate(texts):
        if t not in unique:
            unique[t] = len(unique)
            keep_rows.append(i)
        labels[i] = unique[t]

    t_emb = np.asarray(text_embeddings)[keep_rows]  # (M, D)
    sims = np.asarray(image_embeddings) @ t_emb.T  # cosine (embeddings normalized)
    n_text = t_emb.shape[0]
    n = sims.shape[0]

    # rank convention as in the reference: rank = n_text - position_in_ascending_sort,
    # so the best match has rank 1
    order = np.argsort(sims, axis=1)  # ascending
    pos = np.empty_like(order)
    np.put_along_axis(pos, order, np.arange(n_text)[None, :].repeat(n, 0), axis=1)
    ranks = n_text - pos[np.arange(n), labels]

    result = {f"Recall@{k}": float(np.mean(ranks <= k)) for k in recall_ks}
    result["MeanRank"] = float(np.mean(ranks))
    return {"retrieval_i2t": result}
