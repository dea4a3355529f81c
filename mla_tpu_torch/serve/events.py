"""Discrete event detection on top of the localization timeline (own copy
of ``mla_tpu/serve/events.py``).

The attention family's per-patch readout (``AudioTagger.timeline`` / the
server's timeline window, arXiv:1803.02353 §2) gives, per class, a
segment-probability track f[t, c] and the attention weights w[t, c] the
clip decision placed on each patch. This module turns those tracks into
DCASE-style discrete events, ``(class, t_start, t_end, score)``, with the
standard threshold / gap-merge / min-duration post-processing chain.

Pure host-side numpy over a [T, C] window (T = patches, one per 0.96 s), so
it composes with every timeline source: the HTTP timeline route via
``TagStream.events()``, the ``tag --events`` verb, or a custom reader.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def detect_events(
    probs: np.ndarray,
    weights: Optional[np.ndarray] = None,
    hop_s: float = 0.96,
    start_patch: int = 0,
    threshold=0.5,
    merge_gap_s: float = 0.0,
    min_dur_s: float = 0.0,
    class_names: Optional[Sequence[str]] = None,
    classes: Optional[Sequence[int]] = None,
) -> List[Dict]:
    """Threshold per-patch class probabilities into discrete events.

    probs: [T, C] segment probabilities (timeline ``f``, level-mean or a
        single level). threshold: one global cutoff, or a per-class [C]
        array (e.g. utils.metrics.calibrate_thresholds — maximal recall
        at a precision target on an eval set). weights: optional [T, C]
        attention weights
        (timeline ``w``) — reported per event as ``att_mass`` (the share
        of the clip decision's attention inside the event; for the exp
        gate these sum to <= 1 over the window). hop_s / start_patch:
        the timeline's patch grid (timestamps are absolute:
        ``(start_patch + t) * hop_s``).

    Post-processing chain (applied per class, standard SED order):
      1. active = probs >= threshold
      2. merge active runs separated by gaps <= merge_gap_s
      3. drop events shorter than min_dur_s

    Returns events sorted by (t_start, -score): dicts with ``class_idx``,
    ``label`` (when class_names given), ``t_start``, ``t_end`` (end is
    EXCLUSIVE: last patch's end time), ``score`` (peak prob), ``mean``
    (mean prob), and ``att_mass`` (when weights given). ``classes``
    restricts detection to those class indices (e.g. the clip's top-k).
    """
    probs = np.asarray(probs, np.float32)
    if probs.ndim != 2:
        raise ValueError(f"probs must be [T, C], got shape {probs.shape}")
    t_n, c_n = probs.shape
    if weights is not None:
        weights = np.asarray(weights, np.float32)
        if weights.shape != probs.shape:
            raise ValueError(
                f"weights shape {weights.shape} != probs shape {probs.shape}")
    if class_names is not None and len(class_names) != c_n:
        raise ValueError(
            f"{len(class_names)} class names for {c_n} classes")
    gap_patches = int(np.floor(merge_gap_s / hop_s + 1e-9)) if hop_s else 0
    min_patches = max(1, int(np.ceil(min_dur_s / hop_s - 1e-9))) if hop_s else 1
    thr = np.asarray(threshold, np.float32)
    if thr.ndim == 0:
        thr = np.full(c_n, float(thr), np.float32)
    elif thr.shape != (c_n,):
        raise ValueError(
            f"threshold must be a scalar or [{c_n}] per-class array, got "
            f"shape {thr.shape}")

    events: List[Dict] = []
    for c in (range(c_n) if classes is None else classes):
        active = probs[:, c] >= thr[c]
        runs = _runs(active)
        runs = _merge_runs(runs, gap_patches)
        for s, e in runs:  # [s, e) in patch indices
            if e - s < min_patches:
                continue
            ev = {
                "class_idx": int(c),
                "t_start": float((start_patch + s) * hop_s),
                "t_end": float((start_patch + e) * hop_s),
                "score": float(probs[s:e, c].max()),
                "mean": float(probs[s:e, c].mean()),
            }
            if class_names is not None:
                ev["label"] = str(class_names[c])
            if weights is not None:
                ev["att_mass"] = float(weights[s:e, c].sum())
            events.append(ev)
    events.sort(key=lambda ev: (ev["t_start"], -ev["score"]))
    return events


def _runs(active: np.ndarray) -> List[List[int]]:
    """Contiguous True runs as mutable [start, end) pairs."""
    if not active.any():
        return []
    padded = np.concatenate([[False], active, [False]])
    edges = np.flatnonzero(padded[1:] != padded[:-1])
    return [[int(edges[i]), int(edges[i + 1])]
            for i in range(0, len(edges), 2)]


def _merge_runs(runs: List[List[int]], gap: int) -> List[List[int]]:
    """Merge runs whose separating gap is <= gap patches."""
    if gap <= 0 or len(runs) < 2:
        return runs
    merged = [runs[0]]
    for s, e in runs[1:]:
        if s - merged[-1][1] <= gap:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def events_from_timeline_payload(payload: Dict, threshold=0.5,
                                 merge_gap_s: float = 0.0,
                                 min_dur_s: float = 0.0) -> List[Dict]:
    """Detect events from a /v1/streams/<sid>/timeline JSON payload (the
    columns are the stream's top-k classes; ``class_idx`` below indexes
    into ``payload['classes']``, and ``label`` carries the class name).
    ``threshold``: a scalar, or a {label: threshold} mapping (e.g. the
    ``eval --calibrate`` JSON's "thresholds" table) — mapped onto the
    payload's columns by label; a column missing from the mapping is an
    error (calibrate with the same config/labels)."""
    names = [n for n, _ in payload["classes"]]
    if isinstance(threshold, dict):
        missing = [n for n in names if n not in threshold]
        if missing:
            raise ValueError(
                f"threshold table lacks {missing} — calibrate with the "
                "same config/labels as the service")
        threshold = np.asarray([threshold[n] for n in names], np.float32)
    return detect_events(
        np.asarray(payload["probs"], np.float32),
        np.asarray(payload["weights"], np.float32),
        hop_s=float(payload["hop_s"]),
        start_patch=int(payload["start_patch"]),
        threshold=threshold, merge_gap_s=merge_gap_s, min_dur_s=min_dur_s,
        class_names=names,
    )
