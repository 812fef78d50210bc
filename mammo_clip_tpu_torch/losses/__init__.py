from .classification import bce_with_logits_loss, softmax_ce_loss
from .clip_loss import contrastive_clip_loss, cross_entropy, multi_positive_clip_loss
from .combined import build_loss

__all__ = ["bce_with_logits_loss", "build_loss", "contrastive_clip_loss", "cross_entropy",
           "multi_positive_clip_loss", "softmax_ce_loss"]
