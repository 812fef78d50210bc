"""Host-side data layer of the port: metadata (csv), image stores, datasets,
batching and device prefetch, tokenizer and prompts."""

from .prompts import VINDR_FINDINGS, build_prompt_bank, generate_report_from_labels
from .tokenizer import HashTokenizer, WordPieceTokenizer, load_tokenizer

__all__ = ["HashTokenizer", "VINDR_FINDINGS", "WordPieceTokenizer", "build_prompt_bank",
           "generate_report_from_labels", "load_tokenizer"]
