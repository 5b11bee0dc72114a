"""Link-prediction metrics (average precision, ROC AUC) in pure NumPy.

Copy of ``gnnflow_tpu/utils/metrics.py``: sklearn's definitions
(tie-grouped thresholds, step-wise AP, trapezoidal AUC).
"""
from __future__ import annotations

import numpy as np


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TP/FP counts at each distinct score threshold (descending)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()

    desc = np.argsort(-y_score, kind="stable")
    y_true = y_true[desc]
    y_score = y_score[desc]

    # indices of the last element of each tie group
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps


def average_precision_score(y_true, y_score) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n, as in sklearn."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    if tps[-1] == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    recall = np.r_[0.0, recall]
    precision = np.r_[1.0, precision]
    return float(np.sum(np.diff(recall) * precision[1:]))


def roc_auc_score(y_true, y_score) -> float:
    """Trapezoidal area under the ROC curve, as in sklearn."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    n_pos = tps[-1]
    n_neg = fps[-1]
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            "roc_auc_score requires both positive and negative samples")
    tpr = np.r_[0.0, tps / n_pos]
    fpr = np.r_[0.0, fps / n_neg]
    # np.trapezoid's own expression, written out: numpy < 2 lacks the name
    return float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))
