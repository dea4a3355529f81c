"""Eval metrics (own copy of what ``fit``, ``evaluate`` and the SED harness
use from ``mla_tpu/utils/metrics.py``): per-class average precision and
ROC-AUC averaged over classes, d-prime = sqrt(2) * ppf(AUC), and the DCASE
segment-based event metrics (``events_to_segment_grid``,
``segment_event_metrics``). Vectorized numpy on the host.
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


def events_to_segment_grid(events, n_classes: int, duration_s: float,
                           segment_s: float = 1.0) -> np.ndarray:
    """Event list -> boolean activity grid [n_segments, n_classes].

    ``events``: iterable of ``(class_idx, t_start, t_end)`` triples or
    dicts with those keys (``serve.events.detect_events`` output). A
    segment is active for a class when any event of that class overlaps
    it by any amount (the DCASE segment-based convention — Mesaros et
    al. 2016, "Metrics for polyphonic sound event detection" §3.1).
    Events are clipped to [0, duration_s]; zero-length overlap at a
    boundary does not activate a segment.
    """
    if segment_s <= 0:
        raise ValueError(f"segment_s must be > 0, got {segment_s}")
    n_seg = max(1, int(np.ceil(duration_s / segment_s - 1e-9)))
    grid = np.zeros((n_seg, n_classes), bool)
    for ev in events:
        if isinstance(ev, dict):
            k, t0, t1 = ev["class_idx"], ev["t_start"], ev["t_end"]
        else:
            k, t0, t1 = ev
        k = int(k)
        if not 0 <= k < n_classes:
            raise ValueError(f"event class {k} out of range [0, {n_classes})")
        t0 = max(float(t0), 0.0)
        t1 = min(float(t1), float(duration_s))
        if t1 <= t0:
            continue
        s0 = int(np.floor(t0 / segment_s + 1e-9))
        s1 = int(np.ceil(t1 / segment_s - 1e-9))
        grid[s0: max(s1, s0 + 1), k] = True
    return grid


def segment_event_metrics(ref_grids, est_grids) -> Dict[str, float]:
    """DCASE segment-based SED metrics over one or many clips.

    ``ref_grids`` / ``est_grids``: a single [S, C] boolean activity grid
    (see :func:`events_to_segment_grid`) or a list of per-clip grids
    (clips may differ in length; class counts must match). Returns the
    micro-averaged (instance-pooled, the DCASE default) dict:

      precision, recall, f1       — over (segment, class) activations
      error_rate = (S + D + I)/N  — with the per-segment decomposition
      substitutions/deletions/insertions/n_ref — the raw S, D, I, N sums
      macro_f1                    — unweighted mean of per-class F1 over
                                    classes with ref activity

    Per segment k: S(k) = min(FN(k), FP(k)), D(k) = FN(k) - S(k),
    I(k) = FP(k) - S(k); N = total active reference (segment, class)
    pairs (Mesaros et al. 2016 §3.1; an all-correct output scores
    ER 0.0 / F1 1.0, an empty output on active reference scores ER 1.0).
    """
    if isinstance(ref_grids, np.ndarray) and ref_grids.ndim == 2:
        ref_grids = [ref_grids]
        est_grids = [est_grids]
    if len(ref_grids) != len(est_grids):
        raise ValueError(f"{len(ref_grids)} reference clips vs "
                         f"{len(est_grids)} estimated")
    if len(ref_grids) == 0:
        raise ValueError("no clips to score (empty grid lists)")
    tp = fp = fn = 0
    s_sum = d_sum = i_sum = 0
    n_ref = 0
    c = None
    cls_tp = cls_fp = cls_fn = None
    for ref, est in zip(ref_grids, est_grids):
        ref = np.asarray(ref, bool)
        est = np.asarray(est, bool)
        if ref.shape != est.shape:
            raise ValueError(f"grid shapes differ: {ref.shape} vs {est.shape}")
        if c is None:
            c = ref.shape[1]
            cls_tp = np.zeros(c, np.int64)
            cls_fp = np.zeros(c, np.int64)
            cls_fn = np.zeros(c, np.int64)
        elif ref.shape[1] != c:
            raise ValueError(f"class count differs: {ref.shape[1]} vs {c}")
        tpg = ref & est
        fpg = est & ~ref
        fng = ref & ~est
        tp += int(tpg.sum())
        fp += int(fpg.sum())
        fn += int(fng.sum())
        n_ref += int(ref.sum())
        cls_tp += tpg.sum(0)
        cls_fp += fpg.sum(0)
        cls_fn += fng.sum(0)
        seg_fp = fpg.sum(1)
        seg_fn = fng.sum(1)
        s_k = np.minimum(seg_fn, seg_fp)
        s_sum += int(s_k.sum())
        d_sum += int((seg_fn - s_k).sum())
        i_sum += int((seg_fp - s_k).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cls_f1 = 2 * cls_tp / np.maximum(2 * cls_tp + cls_fp + cls_fn, 1)
    active = (cls_tp + cls_fn) > 0  # classes with reference activity
    return {
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "error_rate": float((s_sum + d_sum + i_sum) / max(n_ref, 1)),
        "substitutions": int(s_sum),
        "deletions": int(d_sum),
        "insertions": int(i_sum),
        "n_ref": int(n_ref),
        "macro_f1": float(cls_f1[active].mean()) if active.any()
        else float("nan"),
    }
