"""Wire quantizers the streaming server needs (own copies of the functions
in ``mla_tpu/data/audio_io.py``): PCM16 and 8-bit mu-law.

``mulaw_decode`` takes a numpy array on the host or a torch tensor on any
device, with one formula for both sides of the wire.
"""

from __future__ import annotations

import numpy as np
import torch

MULAW_MU = 255.0


def pcm16_quantize(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 PCM (int16 passes through), f32 arithmetic."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        return x
    return np.asarray(np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0, np.int16)


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 mu-law code (mu=255), computed in float64 so
    the codes match the reference encoder bit for bit."""
    x = np.clip(np.asarray(x, np.float64), -1.0, 1.0)
    y = np.sign(x) * np.log1p(MULAW_MU * np.abs(x)) / np.log1p(MULAW_MU)
    return np.asarray(np.round((y + 1.0) * 127.5), np.uint8)


def mulaw_decode(q):
    """uint8 mu-law code -> float32 [-1, 1] (numpy array or torch tensor)."""
    k = float(np.log1p(MULAW_MU))
    if isinstance(q, torch.Tensor):
        y = q.to(torch.float32) / 127.5 - 1.0
        return torch.sign(y) * torch.expm1(torch.abs(y) * k) / MULAW_MU
    y = np.asarray(q).astype(np.float32) / 127.5 - 1.0
    return np.sign(y) * np.expm1(np.abs(y) * k) / MULAW_MU
