"""Eval metrics (own copy of what ``fit`` and ``evaluate`` use from
``mla_tpu/utils/metrics.py``): per-class average precision and ROC-AUC
averaged over classes, d-prime = sqrt(2) * ppf(AUC). Vectorized numpy over
all classes at once, on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import stats as _scipy_stats


def average_precision(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-class AP, sklearn ``average_precision_score`` semantics.

    scores, targets: [N, C]. Returns [C]; NaN where a class has no positives.
    AP = sum_k (R_k - R_{k-1}) * P_k over descending-score ranks, with ties
    grouped (step-function integral, not trapezoidal).
    """
    scores = np.asarray(scores, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    n, c = scores.shape
    order = np.argsort(-scores, axis=0, kind="stable")
    sorted_t = np.take_along_axis(targets, order, axis=0)
    sorted_s = np.take_along_axis(scores, order, axis=0)
    tp = np.cumsum(sorted_t, axis=0)
    fp = np.cumsum(1.0 - sorted_t, axis=0)
    n_pos = tp[-1]
    precision = tp / np.maximum(tp + fp, 1e-12)
    with np.errstate(invalid="ignore", divide="ignore"):
        recall = tp / n_pos
    # ties: only the last row of each tied score group is a valid operating
    # point; its precision/recall stand for the whole group
    is_group_end = np.ones_like(sorted_s, dtype=bool)
    is_group_end[:-1] = sorted_s[:-1] != sorted_s[1:]
    ap = np.full(c, np.nan)
    for j in range(c):  # per-class tail; group structure differs per class
        if n_pos[j] == 0:
            continue
        ends = np.nonzero(is_group_end[:, j])[0]
        r = recall[ends, j]
        p = precision[ends, j]
        dr = np.diff(np.concatenate([[0.0], r]))
        ap[j] = float(np.sum(dr * p))
    return ap


def roc_auc(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-class ROC-AUC via the rank statistic (Mann-Whitney U), with tie
    correction through midranks. [N, C] -> [C]; NaN where a class is
    single-valued (no positives or no negatives)."""
    scores = np.asarray(scores, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    n, c = scores.shape
    ranks = _scipy_stats.rankdata(scores, axis=0)  # midranks for ties
    n_pos = targets.sum(axis=0)
    n_neg = n - n_pos
    sum_pos_ranks = (ranks * targets).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        auc = (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    auc[(n_pos == 0) | (n_neg == 0)] = np.nan
    return auc


def d_prime(auc):
    """d' = sqrt(2) * Phi^-1(AUC)."""
    return np.sqrt(2.0) * _scipy_stats.norm.ppf(auc)


def calculate_stats(scores: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    """Clip scores + multi-hot targets -> {mAP, mAUC, d_prime}, averaging over
    classes that have at least one positive (and one negative for AUC)."""
    ap = average_precision(scores, targets)
    auc = roc_auc(scores, targets)
    m_ap = float(np.nanmean(ap)) if np.any(np.isfinite(ap)) else float("nan")
    m_auc = float(np.nanmean(auc)) if np.any(np.isfinite(auc)) else float("nan")
    return {
        "mAP": m_ap,
        "mAUC": m_auc,
        "d_prime": float(d_prime(m_auc)) if np.isfinite(m_auc) else float("nan"),
    }
