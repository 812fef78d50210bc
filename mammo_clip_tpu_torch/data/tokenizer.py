"""Tokenization (a copy of ``mammo_clip_tpu/data/tokenizer.py``, which imports
nothing of JAX; ``transformers`` is imported only inside the HF branch of
``load_tokenizer``).

The reference uses HF AutoTokenizer for BioClinicalBERT with a bos<-cls fallback
(reference: breastclip/data/data_utils.py:8-23) and pads/truncates every report to a
fixed 256 tokens (imagetext.py:214-234) — fixed shapes, which is exactly what TPU wants.

This module provides:
* ``WordPieceTokenizer`` — a self-contained BERT WordPiece implementation (basic
  whitespace/punctuation split + greedy longest-match-first subwords) that loads any
  BERT vocab.txt, so the framework has no network dependency. Given the public
  Bio_ClinicalBERT vocab file it reproduces HF tokenization for the clinical reports.
* ``HashTokenizer`` — deterministic hashing tokenizer for tests/synthetic runs.
* ``load_tokenizer`` — tries HF (if cached), falls back to vocab-file WordPiece, then
  hashing; mirrors the reference's tokenizer factory role.

All encoders emit fixed (B, max_length) int32 ``input_ids``/``attention_mask``.
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = False) -> List[str]:
    """Whitespace cleanup + punctuation splitting (BERT BasicTokenizer behavior)."""
    if lowercase:
        text = text.lower()
    text = unicodedata.normalize("NFC", text)
    out: List[str] = []
    buf: List[str] = []
    for ch in text:
        if ch.isspace():
            if buf:
                out.append("".join(buf))
                buf = []
        elif _is_punct(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


class WordPieceTokenizer:
    """BERT-style WordPiece with greedy longest-match-first subword splitting."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = False,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_word_chars: int = 100,
    ):
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_word_chars = max_word_chars

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: Optional[bool] = None) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        if lowercase is None:
            # cased vocabs (e.g. Bio_ClinicalBERT's bert-base-cased vocab) contain
            # uppercase entries
            lowercase = not any(t[:1].isupper() for t in list(vocab)[:2000])
        return cls(vocab, lowercase=lowercase)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = 256) -> Dict[str, np.ndarray]:
        """Encode to fixed-shape [CLS] ... [SEP] + pad arrays."""
        B = len(texts)
        input_ids = np.full((B, max_length), self.pad_id, np.int32)
        mask = np.zeros((B, max_length), np.int32)
        for i, t in enumerate(texts):
            body = self.tokenize_ids(t)[: max_length - 2]
            seq = [self.cls_id] + body + [self.sep_id]
            input_ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


class HashTokenizer:
    """Deterministic fallback: word -> stable hash bucket. For tests and synthetic
    pipelines only (no linguistic merit, but preserves shapes/special-token layout)."""

    def __init__(self, vocab_size: int = 28996, lowercase: bool = True):
        self._vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3
        self._reserved = 4

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def tokenize_ids(self, text: str) -> List[int]:
        words = basic_tokenize(text, self.lowercase)
        span = self._vocab_size - self._reserved
        out = []
        for w in words:
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            out.append(self._reserved + (h % span))
        return out

    def __call__(self, texts: Sequence[str], max_length: int = 256) -> Dict[str, np.ndarray]:
        B = len(texts)
        input_ids = np.full((B, max_length), self.pad_id, np.int32)
        mask = np.zeros((B, max_length), np.int32)
        for i, t in enumerate(texts):
            body = self.tokenize_ids(t)[: max_length - 2]
            seq = [self.cls_id] + body + [self.sep_id]
            input_ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


def load_tokenizer(config: Dict) -> object:
    """Factory mirroring the reference's load_tokenizer (data_utils.py:8-23).

    Order: explicit vocab_file -> HF cache (if present offline) -> hashing fallback.
    """
    vocab_file = config.get("vocab_file")
    if vocab_file and os.path.exists(vocab_file):
        return WordPieceTokenizer.from_vocab_file(vocab_file)
    name = config.get("name") or config.get("tokenizer_name")
    if name:
        try:  # works only when the HF tokenizer is cached locally (zero-egress env)
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(name, local_files_only=True)

            class _HFWrapper:
                vocab_size = tok.vocab_size

                def __call__(self, texts, max_length=256):
                    enc = tok(
                        list(texts),
                        padding="max_length",
                        truncation=True,
                        max_length=max_length,
                        return_tensors="np",
                    )
                    return {
                        "input_ids": enc["input_ids"].astype(np.int32),
                        "attention_mask": enc["attention_mask"].astype(np.int32),
                    }

            return _HFWrapper()
        except Exception:
            pass
    return HashTokenizer(vocab_size=config.get("vocab_size", 28996))
