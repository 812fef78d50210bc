"""Evaluation layer of the port: metrics, zero-shot, retrieval, batched
embeddings and checkpoint loading (port of ``mammo_clip_tpu/eval/``)."""

from .metrics import auroc, auprc, pr_auc, accuracy, pfbeta, pfbeta_binarized
from .zeroshot import eval_zeroshot
from .retrieval import eval_image_text_retrieval
from .embeddings import EmbeddingExtractor
