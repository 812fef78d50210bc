"""Downstream heads on the CLIP encoder: the classifiers (``classify.py``) and
their training loop (``experiments.py``)."""

from .classify import MammoClassifier, MammoEfficientNetClassifier, POS_WEIGHTS

__all__ = ["MammoClassifier", "MammoEfficientNetClassifier", "POS_WEIGHTS"]
