"""Log-mel front-end in torch ops (counterpart of ``mla_tpu/ops/frontend.py``).

Waveform -> framed log-mel patches with the VGGish semantics the JAX
package defines (periodic Hann window, |rfft| at the next power of two,
HTK mel filters with the DC row zeroed, log(mel + 0.01), non-overlapping
96-frame patches). The numpy builders are own copies of the reference's;
the tests hold them equal to it.

This is the ``impl="xla"`` path and the yardstick for the fused kernel in
``fused_frontend``. The real DFT is two products against Hann-folded
cos/sin bases over the mel-active bins only. Precision modes mean what they
mean for the reference on its chip:

  "highest" / "high"  f32 products (TF32 is never used);
  "default"           one bf16 pass: operands rounded to bf16 (nearest
                      even), products summed in f32;
  "bf16x3"            hi*hi + hi*lo + lo*hi bf16 passes (``dot_bf16x3``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from mla_tpu_torch.config import FrontendConfig

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0
PRECISIONS = ("highest", "high", "default", "bf16x3")


def hertz_to_mel(frequencies_hertz):
    """HTK-style mel scale used by the VGGish front-end."""
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (np.asarray(frequencies_hertz, dtype=np.float64) / _MEL_BREAK_FREQUENCY_HERTZ)
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    num_mel_bins: int = 64,
    num_spectrogram_bins: int = 257,
    sample_rate: int = 16000,
    lower_edge_hertz: float = 125.0,
    upper_edge_hertz: float = 7500.0,
) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] triangular filter matrix
    (VGGish ``spectrogram_to_mel_matrix``; the DC bin row is zero)."""
    nyquist_hertz = sample_rate / 2.0
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError("lower_edge_hertz must be < upper_edge_hertz")
    spectrogram_bins_mel = hertz_to_mel(np.linspace(0.0, nyquist_hertz, num_spectrogram_bins))
    band_edges_mel = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz), num_mel_bins + 2
    )
    mel_weights = np.empty((num_spectrogram_bins, num_mel_bins), dtype=np.float64)
    for i in range(num_mel_bins):
        lower_edge_mel, center_mel, upper_edge_mel = band_edges_mel[i : i + 3]
        lower_slope = (spectrogram_bins_mel - lower_edge_mel) / (center_mel - lower_edge_mel)
        upper_slope = (upper_edge_mel - spectrogram_bins_mel) / (upper_edge_mel - center_mel)
        mel_weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    mel_weights[0, :] = 0.0  # DC bin carries no mel energy
    return mel_weights.astype(np.float32)


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window: 0.5 - 0.5 cos(2 pi n / N)."""
    return (
        0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))
    ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_bases(window_length: int, fft_size: int):
    """(C, S), each [window_length, fft_size//2 + 1] f32, with the periodic
    Hann window folded in: x @ C, x @ S = rfft(hann * x, fft_size).real/.imag."""
    n = np.arange(window_length, dtype=np.float64)[:, None]
    k = np.arange(fft_size // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    win = periodic_hann(window_length).astype(np.float64)[:, None]
    cos_b = (np.cos(ang) * win).astype(np.float32)
    sin_b = (-np.sin(ang) * win).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def trimmed_spectral_bases(cfg: FrontendConfig):
    """(cos, sin, mel, n_bins_used): DFT bases and mel filterbank trimmed to
    the last spectrogram bin with nonzero mel weight. Exact: the dropped
    bins have all-zero mel weight."""
    cos_b, sin_b = dft_bases(cfg.window_length, cfg.fft_size)
    mel_w = mel_filterbank(
        cfg.num_mel_bins, cfg.num_spectrogram_bins, cfg.sample_rate,
        cfg.mel_min_hz, cfg.mel_max_hz,
    )
    n = int(np.nonzero(mel_w.any(axis=1))[0][-1]) + 1
    return cos_b[:, :n].copy(), sin_b[:, :n].copy(), mel_w[:n].copy(), n


def frame_signal(x: torch.Tensor, window_length: int, hop_length: int) -> torch.Tensor:
    """Frame the last axis into [..., num_frames, window_length] (a strided
    view); num_frames = 1 + (n - window_length) // hop_length."""
    n = x.shape[-1]
    if 1 + (n - window_length) // hop_length <= 0:
        raise ValueError(f"signal too short to frame: {n} < {window_length}")
    return x.unfold(-1, window_length, hop_length)


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return a.to(torch.bfloat16).to(torch.float32)


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) with hi = bf16(a), lo = bf16(a - hi), both as f32."""
    hi = round_bf16(a)
    return hi, round_bf16(a - hi)


def dot_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Near-f32 product from three bf16 passes: hi@hi + hi@lo + lo@hi
    (lo@lo dropped). bf16 x bf16 products are exact in f32, so f32 matmuls
    of the rounded operands are the bf16 passes with f32 accumulation."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at one of the front-end's precision modes (module docstring)."""
    if precision in ("highest", "high"):
        return a @ b
    if precision == "default":
        return round_bf16(a) @ round_bf16(b)
    if precision == "bf16x3":
        return dot_bf16x3(a, b)
    raise ValueError(f"unknown precision {precision!r}; pick from {PRECISIONS}")


def _bases_tensors(cfg: FrontendConfig, device: torch.device):
    cos_b, sin_b, mel_t, _ = trimmed_spectral_bases(cfg)
    return tuple(torch.tensor(a, device=device) for a in (cos_b, sin_b, mel_t))


@functools.lru_cache(maxsize=16)
def _cached_bases(cfg: FrontendConfig, device: torch.device):
    return _bases_tensors(cfg, device)


def device_bases(cfg: FrontendConfig, device: torch.device):
    """``trimmed_spectral_bases``' (cos, sin, mel) as f32 tensors on
    ``device``, copies that share no memory with the cached numpy arrays.
    On a card they are made once per (config, device) and shared by every
    call, so callers must not write into them. On the CPU each call gets its
    own clones (a write cannot reach a later call), and inside a trace
    (``torch.export``) fresh constants, so nothing traced is cached."""
    device = torch.device(device)
    if torch.compiler.is_compiling():
        return _bases_tensors(cfg, device)
    bases = _cached_bases(cfg, device)
    if device.type == "cpu":
        return tuple(t.clone() for t in bases)
    return bases


def log_mel_spectrogram(
    x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(), method: str = "matmul"
) -> torch.Tensor:
    """Waveform [..., n] f32 -> log-mel [..., num_frames, num_mel_bins].
    ``method="matmul"`` takes the DFT as two products over the mel-active
    bins; ``"fft"`` takes ``torch.fft.rfft`` of the Hann-windowed frames at
    fft_size and the full filterbank."""
    mel_prec = "highest" if cfg.precision == "bf16x3" else cfg.precision
    frames = frame_signal(x.to(torch.float32), cfg.window_length, cfg.hop_length)
    if method == "fft":
        win = torch.from_numpy(periodic_hann(cfg.window_length)).to(x.device)
        mag = torch.fft.rfft(frames * win, n=cfg.fft_size, dim=-1).abs()
        mel_w = torch.tensor(mel_filterbank(
            cfg.num_mel_bins, cfg.num_spectrogram_bins, cfg.sample_rate,
            cfg.mel_min_hz, cfg.mel_max_hz)).to(x.device)
        return torch.log(dot(mag, mel_w, mel_prec) + cfg.log_offset)
    if method != "matmul":
        raise ValueError(f"unknown stft method {method!r}")
    cos_b, sin_b, mel_t = device_bases(cfg, x.device)
    re = dot(frames, cos_b, cfg.precision)
    im = dot(frames, sin_b, cfg.precision)
    mag = torch.sqrt(re * re + im * im)
    return torch.log(dot(mag, mel_t, mel_prec) + cfg.log_offset)


def waveform_to_patches(
    x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(), method: str = "matmul"
) -> torch.Tensor:
    """Waveform [..., n] -> patches [..., N, 96, 64] (VGGish examples)."""
    log_mel = log_mel_spectrogram(x, cfg, method)
    wf, hf = cfg.example_window_frames, cfg.example_hop_frames
    t = log_mel.shape[-2]
    n_patches = 1 + (t - wf) // hf
    if n_patches <= 0:
        raise ValueError(f"too few frames ({t}) for one {wf}-frame patch")
    lm = log_mel[..., : (n_patches - 1) * hf + wf, :]
    if hf == wf:  # non-overlapping: pure reshape
        return lm.reshape(*lm.shape[:-2], n_patches, wf, lm.shape[-1])
    return torch.stack([lm[..., s : s + wf, :] for s in range(0, n_patches * hf, hf)], dim=-3)


def apply_frontend(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Dispatch on cfg.impl: "pallas" is the fused CUDA kernel (its plain
    torch version for a CPU tensor), "xla" the torch-ops path above."""
    if cfg.impl == "pallas":
        from mla_tpu_torch.ops.fused_frontend import fused_log_mel_patches

        return fused_log_mel_patches(x, cfg, precision=cfg.precision)
    if cfg.impl == "xla":
        return waveform_to_patches(x, cfg)
    raise ValueError(f"unknown frontend impl {cfg.impl!r}")


def patches_per_clip(n_samples: int, cfg: FrontendConfig = FrontendConfig()) -> int:
    """Static patch count for an n_samples-long clip (shape planning)."""
    num_frames = 1 + (n_samples - cfg.window_length) // cfg.hop_length
    return 1 + (num_frames - cfg.example_window_frames) // cfg.example_hop_frames


def patch_hop_seconds(cfg: FrontendConfig = FrontendConfig()) -> float:
    """Seconds between consecutive patch starts (0.96 s at the VGGish grid)."""
    return cfg.example_hop_frames * cfg.hop_length / cfg.sample_rate
