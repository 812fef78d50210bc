"""Batched embedding extraction (port of ``mammo_clip_tpu/eval/embeddings.py``;
reference: evaluator.py:62-144 get_embeddings + encode_image/encode_text helpers).

The model runs in eval mode under ``torch.inference_mode()`` on its device:
BatchNorm uses its running statistics, so a row's embedding does not depend on
the other rows of its batch. Batches keep one shape, as in the JAX package: the
last partial batch is padded with copies of the last row and the padding rows
are dropped on the host. Inputs are numpy arrays on the host; outputs are fp32
numpy arrays on the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from ..ops.augment import minmax_standardize


class EmbeddingExtractor:
    """Wraps a MammoCLIP module (its weights loaded) for bulk image/text embedding;
    batches go to the module's device (``eval.loading.load_clip_for_eval``'s
    ``device``)."""

    def __init__(self, model: torch.nn.Module, mean: float, std: float, batch_size: int = 32):
        self.model = model.eval()
        self.mean = mean
        self.std = std
        self.batch_size = batch_size
        self.device = next(model.parameters()).device

    def _batches(self, arr: np.ndarray):
        """Batches of ``arr`` (the last one padded) as tensors on the device."""
        n = arr.shape[0]
        pad = (-n) % self.batch_size
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
        for i in range(0, arr.shape[0], self.batch_size):
            t = torch.from_numpy(np.ascontiguousarray(arr[i:i + self.batch_size]))
            yield t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 1) uint8/float -> (N, D) L2-normalized fp32 embeddings."""
        images = np.asarray(images)
        outs = []
        for x in self._batches(images):
            x = minmax_standardize(x, self.mean, self.std)
            outs.append(self.model.embed_image(x, train=False).float().cpu().numpy())
        return np.concatenate(outs, axis=0)[:images.shape[0]]

    @torch.inference_mode()
    def encode_texts(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        """(N, S) token ids and mask -> (N, D) L2-normalized fp32 embeddings."""
        input_ids = np.asarray(input_ids, dtype=np.int64)
        attention_mask = np.asarray(attention_mask, dtype=np.int64)
        outs = []
        for ids, mask in zip(self._batches(input_ids), self._batches(attention_mask)):
            outs.append(self.model.embed_text(ids, mask, train=False).float().cpu().numpy())
        return np.concatenate(outs, axis=0)[:input_ids.shape[0]]

    def run_dataset(self, batches: Iterable[Dict], label_keys: Iterable[str] = ()) -> Dict[str, np.ndarray]:
        """Stream a Batcher's host batches through the model, collecting embeddings +
        labels + texts: the reference's get_embeddings loop (evaluator.py:62-124)."""
        img_emb: List[np.ndarray] = []
        txt_emb: List[np.ndarray] = []
        labels: Dict[str, List] = {k: [] for k in label_keys}
        texts: List[str] = []
        for batch in batches:
            if "images" in batch:
                img_emb.append(self.encode_images(batch["images"]))
            if "input_ids" in batch:
                txt_emb.append(self.encode_texts(batch["input_ids"], batch["attention_mask"]))
            if "texts" in batch:
                texts.extend(batch["texts"])
            for k in label_keys:
                if k in batch:
                    labels[k].extend(np.asarray(batch[k]).tolist())
        out: Dict[str, np.ndarray] = {}
        if img_emb:
            out["image_embeddings"] = np.concatenate(img_emb, axis=0)
        if txt_emb:
            out["text_embeddings"] = np.concatenate(txt_emb, axis=0)
        if texts:
            out["texts"] = texts
        for k, v in labels.items():
            if v:
                out[k] = np.asarray(v)
        return out
