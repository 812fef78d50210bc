"""Tutorials of the port (twins of the repository's ``examples/``), run with
``python -m mammo_clip_tpu_torch.examples.<name>``."""
