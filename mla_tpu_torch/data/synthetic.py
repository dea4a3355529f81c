"""Synthetic stand-in datasets (own copy of ``mla_tpu/data/synthetic.py``;
the tests hold the arrays bit-identical to the reference's).

Clips are deterministic mixtures of class-coded tones + noise so that a
model can actually learn: each class k owns a fundamental frequency, a
clip's waveform contains the fundamentals of its active labels. Multi-label
(AudioSet-style) or single-label (ESC-50 / UrbanSound8K-style) modes, and
the event corpus (``synth_event_waveforms``: tone bursts with known
boundaries, the SED harness's reference, ``train/sed_eval.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mla_tpu_torch.config import DataConfig


@dataclass
class ArrayDataset:
    """In-RAM dataset mirroring the reference HDF5 triple."""

    x: np.ndarray  # waveforms [N, samples] | features [N, T, D]
    y: np.ndarray  # [N, n_classes] float32 multi-hot
    ids: np.ndarray
    kind: str  # "waveform" | "features"


def class_frequency(k: int, n_classes: int, fmin: float = 200.0, fmax: float = 6000.0) -> float:
    """Log-spaced fundamental per class (keeps them in distinct mel bins)."""
    t = k / max(n_classes - 1, 1)
    return float(fmin * (fmax / fmin) ** t)


def synth_waveforms(
    n_clips: int,
    n_classes: int,
    clip_seconds: float,
    sample_rate: int = 16000,
    multi_label: bool = False,
    seed: int = 0,
    max_labels: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = int(round(clip_seconds * sample_rate))
    t = np.arange(n) / sample_rate
    x = np.empty((n_clips, n), np.float32)
    y = np.zeros((n_clips, n_classes), np.float32)
    for i in range(n_clips):
        if multi_label:
            k_active = rng.choice(n_classes, size=rng.integers(1, max_labels + 1), replace=False)
        else:
            k_active = [rng.integers(0, n_classes)]
        wav = 0.05 * rng.standard_normal(n)
        for k in k_active:
            f0 = class_frequency(int(k), n_classes)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.2, 0.5)
            wav = wav + amp * np.sin(2 * np.pi * f0 * t + phase)
            y[i, int(k)] = 1.0
        x[i] = wav.astype(np.float32)
    return x, y


def synth_event_waveforms(
    n_clips: int,
    n_classes: int,
    clip_seconds: float,
    sample_rate: int = 16000,
    seed: int = 0,
    max_events: int = 3,
    min_event_s: float = 1.5,
    max_event_s: Optional[float] = None,
    noise: float = 0.05,
    ramp_s: float = 0.01,
):
    """Event corpus with ground-truth boundaries: each clip is noise plus
    1..max_events tone bursts (distinct classes, class-coded fundamentals as
    in :func:`synth_waveforms`), each over a random [t_start, t_end) span
    with short cosine ramps. Clip labels stay weak (multi-hot); the
    boundaries are the reference the SED harness scores against.

    Returns ``(x [N, samples] f32, y [N, C] multi-hot f32, events: per clip
    [(class_idx, t_start_s, t_end_s), ...] sorted by start)``.
    ``min_event_s`` defaults to 1.5 s so every event overlaps at least one
    full 0.96 s patch of the front-end grid.
    """
    rng = np.random.default_rng(seed)
    n = int(round(clip_seconds * sample_rate))
    hi = max_event_s if max_event_s is not None else max(min_event_s, 0.5 * clip_seconds)
    if min_event_s > clip_seconds:
        raise ValueError(f"min_event_s {min_event_s} exceeds clip length {clip_seconds}")
    t = np.arange(n) / sample_rate
    ramp_n = max(1, int(ramp_s * sample_rate))
    x = np.empty((n_clips, n), np.float32)
    y = np.zeros((n_clips, n_classes), np.float32)
    events = []
    for i in range(n_clips):
        k_active = rng.choice(n_classes, size=rng.integers(1, max_events + 1), replace=False)
        wav = noise * rng.standard_normal(n)
        clip_events = []
        for k in k_active:
            dur = float(rng.uniform(min_event_s, min(hi, clip_seconds)))
            t0 = float(rng.uniform(0.0, clip_seconds - dur))
            t1 = t0 + dur
            s0, s1 = int(round(t0 * sample_rate)), int(round(t1 * sample_rate))
            f0 = class_frequency(int(k), n_classes)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.25, 0.5)
            burst = amp * np.sin(2 * np.pi * f0 * t[s0:s1] + phase)
            env = np.ones(s1 - s0)
            m = min(ramp_n, len(env) // 2)
            if m:
                ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(m) / m)
                env[:m] = ramp
                env[-m:] = ramp[::-1]
            wav[s0:s1] += burst * env
            y[i, int(k)] = 1.0
            clip_events.append((int(k), t0, t1))
        x[i] = wav.astype(np.float32)
        events.append(sorted(clip_events, key=lambda e: e[1]))
    return x, y, events


def synth_features(
    n_clips: int,
    n_classes: int,
    t_steps: int = 10,
    dim: int = 128,
    multi_label: bool = True,
    seed: int = 0,
    max_labels: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bottleneck-feature protocol stand-in: class-template + noise sequences,
    each active class occupying a random contiguous span of time steps."""
    rng = np.random.default_rng(seed)
    # class templates are the dataset's "physics": fixed across splits
    templates = np.random.default_rng(777).standard_normal((n_classes, dim)).astype(np.float32)
    x = rng.standard_normal((n_clips, t_steps, dim)).astype(np.float32) * 0.3
    y = np.zeros((n_clips, n_classes), np.float32)
    for i in range(n_clips):
        if multi_label:
            k_active = rng.choice(n_classes, size=rng.integers(1, max_labels + 1), replace=False)
        else:
            k_active = [rng.integers(0, n_classes)]
        for k in k_active:
            s = rng.integers(0, t_steps)
            e = rng.integers(s + 1, t_steps + 1)
            x[i, s:e] += templates[int(k)]
            y[i, int(k)] = 1.0
    return x, y


_DATASET_CLASSES = {"synthetic_esc50": 50, "synthetic_us8k": 10,
                    "synthetic_audioset": 527, "synthetic_events": None}


def _hdf5_paths(path: str):
    """``data.hdf5_path`` names one pack, a comma-separated list, or a glob
    pattern (sharded packs, e.g. bal_train + unbal_train); rows concatenate
    in list / sorted-glob order for both the in-RAM and out-of-core readers."""
    if "," in path:
        paths = [p.strip() for p in path.split(",") if p.strip()]
    elif any(ch in path for ch in "*?["):
        import glob

        paths = sorted(glob.glob(path))
        if not paths:
            raise FileNotFoundError(f"hdf5_path glob matched nothing: {path}")
    else:
        paths = [path]
    return paths


def make_dataset(
    data_cfg: DataConfig, n_classes: int, split: str = "train", kind: str = "waveform",
    frontend_cfg=None,
) -> ArrayDataset:
    """Build the configured dataset split: a synthetic corpus, or with
    ``dataset="hdf5"`` the packs ``hdf5_path`` / ``eval_hdf5_path`` name,
    loaded whole or, with ``data.out_of_core``, behind an
    ``OutOfCoreDataset`` reader (the pack's rank decides its kind).

    kind="waveform" -> raw audio (the front-end runs on the device);
    kind="features" -> [N, T, 128] bottleneck protocol (trunk=none). The
    ``synthetic_events`` corpus reads its sample rate from ``frontend_cfg``
    (16 kHz without one), as the reference's does.
    """
    name = data_cfg.dataset
    if name == "hdf5":
        from mla_tpu_torch.data import hdf5 as _h5

        path = data_cfg.hdf5_path if split == "train" else data_cfg.eval_hdf5_path
        if path is None:
            raise ValueError(f"data.{'hdf5_path' if split == 'train' else 'eval_hdf5_path'} unset")
        paths = _hdf5_paths(path)
        if data_cfg.out_of_core:
            from mla_tpu_torch.data.ooc import OutOfCoreDataset

            return OutOfCoreDataset(paths[0] if len(paths) == 1 else paths)
        x, y, ids = (_h5.load_data(paths[0]) if len(paths) == 1 else _h5.load_many(paths))
        k = {2: "waveform", 3: "features", 4: "patches"}.get(x.ndim)
        if k is None:
            raise ValueError(f"unrecognized packed feature rank {x.ndim}")
        return ArrayDataset(x, y, ids, k)
    if name not in _DATASET_CLASSES:
        raise ValueError(f"unknown dataset {name!r}")
    n = data_cfg.n_train_clips if split == "train" else data_cfg.n_eval_clips
    seed = 0 if split == "train" else 10_000
    multi = name == "synthetic_audioset"
    if name == "synthetic_events":
        # weakly supervised SED: the splits expose only the multi-hot clip
        # labels; the boundaries stay held out (train/sed_eval.py scores on
        # its own seed, 20_000)
        if kind == "features":
            raise ValueError("synthetic_events is a waveform corpus "
                             "(trunk='none' has no patch grid to localize)")
        x, y, _ = synth_event_waveforms(
            n, n_classes, data_cfg.clip_seconds,
            sample_rate=frontend_cfg.sample_rate if frontend_cfg else 16000, seed=seed)
    elif kind == "features":
        x, y = synth_features(n, n_classes, multi_label=multi, seed=seed)
    else:
        x, y = synth_waveforms(
            n, n_classes, data_cfg.clip_seconds, multi_label=multi, seed=seed
        )
    ids = np.array([f"{name}_{split}_{i:06d}".encode() for i in range(n)])
    return ArrayDataset(x, y, ids, kind)
