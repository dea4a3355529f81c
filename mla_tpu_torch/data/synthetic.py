"""Synthetic stand-in datasets (own copy of ``mla_tpu/data/synthetic.py``;
the tests hold the arrays bit-identical to the reference's).

Clips are deterministic mixtures of class-coded tones + noise so that a
model can actually learn: each class k owns a fundamental frequency, a
clip's waveform contains the fundamentals of its active labels. Multi-label
(AudioSet-style) or single-label (ESC-50 / UrbanSound8K-style) modes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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


def make_dataset(
    data_cfg: DataConfig, n_classes: int, split: str = "train", kind: str = "waveform",
) -> ArrayDataset:
    """Build the configured synthetic dataset split.

    kind="waveform" -> raw audio (the front-end runs on the device);
    kind="features" -> [N, T, 128] bottleneck protocol (trunk=none). The
    reference's ``frontend_cfg`` argument is dropped: only its
    ``synthetic_events`` corpus, not ported, reads it.
    """
    name = data_cfg.dataset
    if name == "hdf5" or data_cfg.out_of_core:
        raise NotImplementedError(
            "dataset='hdf5' and out_of_core are not ported yet "
            "(ROADMAP.md queue A, item 8: out-of-core / hdf5)")
    if name not in _DATASET_CLASSES:
        raise ValueError(f"unknown dataset {name!r}")
    if name == "synthetic_events":
        raise NotImplementedError(
            "dataset='synthetic_events' is not ported yet "
            "(ROADMAP.md queue A, item 8: train/sed_eval.py)")
    n = data_cfg.n_train_clips if split == "train" else data_cfg.n_eval_clips
    seed = 0 if split == "train" else 10_000
    multi = name == "synthetic_audioset"
    if kind == "features":
        x, y = synth_features(n, n_classes, multi_label=multi, seed=seed)
    else:
        x, y = synth_waveforms(
            n, n_classes, data_cfg.clip_seconds, multi_label=multi, seed=seed
        )
    ids = np.array([f"{name}_{split}_{i:06d}".encode() for i in range(n)])
    return ArrayDataset(x, y, ids, kind)
