"""Downstream heads on the CLIP encoder: the classifiers (``classify.py``), the
detector's evaluation (``detect.py``) and their training steps and loop
(``experiments.py``)."""

from .classify import MammoClassifier, MammoEfficientNetClassifier, POS_WEIGHTS
from .detect import VINDR_DETECTION_CLASSES, evaluate_map

__all__ = ["MammoClassifier", "MammoEfficientNetClassifier", "POS_WEIGHTS",
           "VINDR_DETECTION_CLASSES", "evaluate_map"]
