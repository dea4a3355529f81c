"""Scoring of the sound-event-detection surface (counterpart of
``mla_tpu/train/sed_eval.py``).

  1. synthesize a corpus with known event boundaries
     (``data.synthetic.synth_event_waveforms``: weak clip labels for
     training, the boundaries held out for scoring);
  2. run the batched timeline readout: the eval set uploaded once, every
     batch's front-end, trunk and level-mean (weights, probs) computed on the
     device, one copy back at the end;
  3. detect events per clip with the serving post-processing chain
     (threshold / gap-merge / minimum duration, a scalar or per-class
     thresholds; ``serve.events.detect_events``);
  4. score segment-based F1 and error rate in the DCASE convention
     (``utils.metrics.segment_event_metrics``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device


@torch.inference_mode()
def batched_timeline(cfg, state_dict: Mapping, wavs: np.ndarray, batch_size: int = 32,
                     device=None) -> tuple:
    """Level-mean localization readout of equal-length clips on ``device``
    (None = the card): ``wavs [N, samples] -> (weights [N, T, C], probs [N,
    T, C])`` float32 numpy, in one device pass: the clips go up once, the
    batches run back to back (the last padded by repeating its last clip,
    so every batch has one shape), and the results come back in one copy."""
    from mla_tpu_torch.ops import frontend as fe
    from mla_tpu_torch.serve.streaming import _model_with_weights

    dev = resolve_device(device)
    model = _model_with_weights(cfg, state_dict, dev)
    n = len(wavs)
    pad = -n % batch_size
    x = torch.from_numpy(np.ascontiguousarray(wavs, np.float32)).to(dev)
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, -1)])
    ws, fs = [], []
    for s in range(0, n + pad, batch_size):
        levels = model.timeline(fe.apply_frontend(x[s: s + batch_size], cfg.frontend))
        ws.append(torch.stack([wl for wl, _ in levels]).mean(dim=0).float())
        fs.append(torch.stack([fl for _, fl in levels]).mean(dim=0).float())
    out = torch.stack([torch.cat(ws)[:n], torch.cat(fs)[:n]]).cpu().numpy()
    return out[0], out[1]


def _event_corpus(cfg, n_clips: Optional[int], seed: int, max_events: int):
    from mla_tpu_torch.data.synthetic import synth_event_waveforms

    n_clips = n_clips if n_clips is not None else cfg.data.n_eval_clips
    if n_clips <= 0:
        raise ValueError(f"the SED harness needs at least one clip (n_clips={n_clips})")
    x, _, ref_events = synth_event_waveforms(n_clips, cfg.model.n_classes,
                                             cfg.data.clip_seconds, cfg.frontend.sample_rate,
                                             seed=seed, max_events=max_events)
    return x, ref_events


def evaluate_sed(
    cfg,
    state_dict: Mapping,
    n_clips: Optional[int] = None,
    seed: int = 20_000,
    threshold: Union[float, np.ndarray] = 0.5,
    merge_gap_s: float = 0.0,
    min_dur_s: float = 0.0,
    segment_s: Optional[float] = None,
    batch_size: Optional[int] = None,
    max_events: int = 3,
    device=None,
) -> Dict:
    """Event-detection quality end to end on the synthetic event corpus:
    the DCASE segment-based metric dict (micro precision / recall / F1,
    error rate with its S / D / I parts, macro F1) and the operating point.
    ``threshold`` is a scalar or a per-class [C] array; ``segment_s``
    defaults to the patch hop (0.96 s), the timeline's own grid; ``seed`` is
    apart from the train (0) and eval (10_000) synthetic seeds."""
    from mla_tpu_torch.ops.frontend import patch_hop_seconds

    x, ref_events = _event_corpus(cfg, n_clips, seed, max_events)
    hop_s = patch_hop_seconds(cfg.frontend)
    w, f = batched_timeline(cfg, state_dict, x, batch_size or cfg.train.batch_size, device)
    return _score_operating_point(w, f, ref_events, cfg.model.n_classes, cfg.data.clip_seconds,
                                  hop_s, segment_s if segment_s is not None else hop_s,
                                  threshold, merge_gap_s, min_dur_s)


def _score_operating_point(w, f, ref_events, n_classes, clip_seconds, hop_s, seg_s, threshold,
                           merge_gap_s, min_dur_s) -> Dict:
    """Score one post-processing operating point from computed timelines,
    on the host, so a sweep reuses one device pass."""
    from mla_tpu_torch.serve.events import detect_events
    from mla_tpu_torch.utils.metrics import events_to_segment_grid, segment_event_metrics

    ref_grids, est_grids = [], []
    n_est = 0
    for i in range(len(ref_events)):
        est = detect_events(f[i], w[i], hop_s=hop_s, threshold=threshold,
                            merge_gap_s=merge_gap_s, min_dur_s=min_dur_s)
        n_est += len(est)
        ref_grids.append(events_to_segment_grid(ref_events[i], n_classes, clip_seconds, seg_s))
        est_grids.append(events_to_segment_grid(est, n_classes, clip_seconds, seg_s))
    out = segment_event_metrics(ref_grids, est_grids)
    out.update({
        "n_clips": int(len(ref_events)),
        "n_ref_events": int(sum(len(e) for e in ref_events)),
        "n_est_events": int(n_est),
        "segment_s": float(seg_s),
        "threshold": "per-class" if np.ndim(threshold) else float(threshold),
        "merge_gap_s": float(merge_gap_s),
        "min_dur_s": float(min_dur_s),
    })
    return out


def sweep_sed_threshold(
    cfg,
    state_dict: Mapping,
    thresholds: Optional[np.ndarray] = None,
    n_clips: Optional[int] = None,
    seed: int = 20_000,
    merge_gap_s: float = 0.0,
    min_dur_s: float = 0.0,
    segment_s: Optional[float] = None,
    batch_size: Optional[int] = None,
    max_events: int = 3,
    device=None,
) -> Dict:
    """Sweep the scalar event threshold against segment F1: one device
    pass computes the timelines, then each candidate is scored on the host.
    ``best`` maximizes micro segment F1; ties go to the lower threshold."""
    from mla_tpu_torch.ops.frontend import patch_hop_seconds

    if thresholds is None:
        thresholds = np.round(np.arange(0.05, 0.96, 0.05), 2)
    x, ref_events = _event_corpus(cfg, n_clips, seed, max_events)
    hop_s = patch_hop_seconds(cfg.frontend)
    seg_s = segment_s if segment_s is not None else hop_s
    w, f = batched_timeline(cfg, state_dict, x, batch_size or cfg.train.batch_size, device)
    rows = []
    for t in thresholds:
        r = _score_operating_point(w, f, ref_events, cfg.model.n_classes, cfg.data.clip_seconds,
                                   hop_s, seg_s, float(t), merge_gap_s, min_dur_s)
        rows.append({"threshold": float(t), "f1": r["f1"], "error_rate": r["error_rate"],
                     "precision": r["precision"], "recall": r["recall"]})
    best = max(rows, key=lambda r: (r["f1"], -r["threshold"]))
    return {"sweep": rows, "best": dict(best), "n_clips": int(len(ref_events)),
            "segment_s": float(seg_s), "merge_gap_s": float(merge_gap_s),
            "min_dur_s": float(min_dur_s)}
