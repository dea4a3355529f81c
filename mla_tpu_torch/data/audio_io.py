"""Host audio IO and the wire quantizers (own copy of
``mla_tpu/data/audio_io.py``): wav read / write and polyphase resampling
on numpy and scipy, PCM16 and 8-bit mu-law.

Reading and resampling take the C++ library (``data/native.py``) when it
is built, as the reference's do, and scipy otherwise.

``mulaw_decode`` takes a numpy array on the host or a torch tensor on any
device, with one formula for both sides of the wire.
"""

from __future__ import annotations

import io
from fractions import Fraction

import numpy as np
import torch
from scipy.io import wavfile as _wavfile

MULAW_MU = 255.0


def _pcm_to_float_mono(data: np.ndarray) -> np.ndarray:
    """Integer PCM scaled by its dtype range; multi-channel mean-downmixed."""
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    return x


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 waveform in [-1, 1], sample_rate), through
    the native decoder when it is built."""
    from mla_tpu_torch.data import native

    if native.available():
        with open(path, "rb") as f:
            return native.wav_decode(f.read())
    sr, data = _wavfile.read(path)
    return _pcm_to_float_mono(data), int(sr)


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """In-memory wav decode (the HTTP fronts receive file bytes)."""
    from mla_tpu_torch.data import native

    if native.available():
        return native.wav_decode(data)
    sr, raw = _wavfile.read(io.BytesIO(data))
    return _pcm_to_float_mono(raw), int(sr)


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return np.asarray(x, np.float32)
    from mla_tpu_torch.data import native

    if native.available():
        return native.resample(np.asarray(x, np.float32), sr, target_sr)
    from scipy.signal import resample_poly  # seconds to import; only a resample needs it

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(x, frac.numerator, frac.denominator).astype(np.float32)


def load_wav_16k(path: str, target_sr: int = 16000) -> np.ndarray:
    x, sr = read_wav(path)
    return resample(x, sr, target_sr)


def write_wav(path: str, x: np.ndarray, sr: int = 16000):
    _wavfile.write(path, sr, pcm16_quantize(x))


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
