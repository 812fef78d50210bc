"""Evaluation metrics in numpy (port of ``mammo_clip_tpu/eval/metrics.py``;
reference: src/codebase/metrics.py:6-89 and evaluator.py:301-346).

The JAX package computes AUROC, AUPRC and the PR-curve area with scikit-learn,
which the card machine does not have. These are the same definitions, for a
binary ``gt`` and a 1-D score:

* ``auroc``: sklearn's ``roc_auc_score``. Scores are sorted descending
  (stably); each distinct score is one threshold, so tied scores move the
  curve diagonally and count one half; points collinear with their
  neighbours are dropped (sklearn's ``drop_intermediate``) and the curve from
  (0, 0) is integrated by the trapezoid rule. The larger of the two labels is
  the positive one. With one class present the score is undefined: a
  warning, and NaN.
* ``auprc``: ``average_precision_score``, the step sum
  ``sum_n (R_n - R_{n-1}) P_n`` over the same distinct thresholds; label 1 is
  the positive one. With no positive, recall is one at every threshold (a
  warning) and the sum is 0.
* ``pr_auc``: ``auc(recall, precision)`` of ``precision_recall_curve``: the
  trapezoid area of the curve, which ends at (recall 0, precision 1). Labels
  must be {0, 1}, {-1, 1} or one of them.

Inputs of other shapes, lengths, label sets or with non-finite scores raise
``ValueError`` as sklearn does. pfbeta is the Kaggle RSNA probabilistic F1.
"""

from __future__ import annotations

import warnings

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined for the given labels (sklearn's warning of this name)."""


def _binary_inputs(gt, pred):
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if gt.ndim != 1 or pred.ndim != 1:
        raise ValueError(f"expected 1-D labels and scores, got shapes {gt.shape} and "
                         f"{pred.shape}")
    if gt.shape[0] != pred.shape[0]:
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{gt.shape[0]}, {pred.shape[0]}]")
    if not np.all(np.isfinite(pred.astype(np.float64))):
        raise ValueError("Input y_score contains NaN or infinity.")
    return gt, pred


def _curve(pos: np.ndarray, pred: np.ndarray):
    """(fps, tps) at each distinct score, scores descending (sklearn's
    ``confusion_matrix_at_thresholds``)."""
    # the order inside a run of tied scores does not matter: a tie is one threshold
    order = np.argsort(pred, kind="stable")[::-1]
    score = pred[order]
    y = pos[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def _trapezoid_area(x: np.ndarray, y: np.ndarray) -> float:
    """sklearn's ``auc``: the trapezoid area under y(x), x monotonic."""
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve, "
                         f"but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * _trapezoid(y, x))


def auroc(gt, pred) -> float:
    gt, pred = _binary_inputs(gt, pred)
    labels = np.unique(gt)
    if labels.size > 2:
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if labels.size != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined "
                      "in that case.", UndefinedMetricWarning)
        return float("nan")
    fps, tps = _curve(gt == labels[1], pred)
    if fps.shape[0] > 2:  # drop the points collinear with their neighbours
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return _trapezoid_area(fpr, tpr)


def _precision_recall(pos: np.ndarray, pred: np.ndarray):
    """sklearn's ``precision_recall_curve`` (recall decreasing, ending at (0, 1))."""
    fps, tps = _curve(pos, pred)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds.", UndefinedMetricWarning)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def auprc(gt, pred) -> float:
    gt, pred = _binary_inputs(gt, pred)
    labels = np.unique(gt)
    if labels.size > 2:
        raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since "
                         f"`y_true` contains multiple classes. Got `y_score.shape={pred.shape}`.")
    if labels.size == 2 and 1 not in labels:
        raise ValueError(f"pos_label=1 is not a valid label. It should be one of {labels}")
    precision, recall = _precision_recall(gt == 1, pred)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def pr_auc(gt, pred) -> float:
    gt, pred = _binary_inputs(gt, pred)
    labels = np.unique(gt)
    if labels.size > 2:
        raise ValueError("multiclass format is not supported")
    if not any(labels.tolist() == ok for ok in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(f"y_true takes value in {{{', '.join(map(repr, labels.tolist()))}}} "
                         "and pos_label is not specified: either make y_true take value in "
                         "{0, 1} or {-1, 1} or pass pos_label explicitly.")
    precision, recall = _precision_recall(gt == 1, pred)
    return _trapezoid_area(recall, precision)


def accuracy(gt, pred_labels) -> float:
    gt = np.asarray(gt)
    pred_labels = np.asarray(pred_labels)
    if gt.shape[0] != pred_labels.shape[0]:
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{gt.shape[0]}, {pred_labels.shape[0]}]")
    return float(np.average(gt == pred_labels))


def pfbeta(gt, pred, beta: float = 1.0) -> float:
    """Probabilistic F-beta (Kaggle RSNA metric). Predictions clipped to [0,1];
    ctp = sum of clipped predictions over positives, cfp over negatives."""
    gt = np.asarray(gt).astype(bool)
    pred = np.clip(np.asarray(pred, dtype=np.float64), 0.0, 1.0)
    y_true_count = int(gt.sum())
    if y_true_count == 0:
        return 0.0
    ctp = pred[gt].sum()
    cfp = pred[~gt].sum()
    beta2 = beta * beta
    c_precision = ctp / (ctp + cfp) if (ctp + cfp) > 0 else 0.0
    c_recall = ctp / y_true_count
    if c_precision > 0 and c_recall > 0:
        return float((1 + beta2) * c_precision * c_recall / (beta2 * c_precision + c_recall))
    return 0.0


def pfbeta_binarized(gt, pred) -> float:
    """Threshold sweep over positive-prediction values, maximizing binarized pfbeta
    (reference evaluator.py:301-309)."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    thresholds = pred[gt == 1]
    if thresholds.size == 0:
        return 0.0
    return max(pfbeta(gt, (pred >= th).astype(np.int32), 1.0) for th in thresholds)
