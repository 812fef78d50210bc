"""The benchmark of ``mammo_clip_tpu_torch`` on NVIDIA GPUs (see README.md)."""
