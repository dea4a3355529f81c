"""Fused log-mel front-end: waveform [B, n] -> log-mel patches [B, N, 96, 64]
in one hand-written CUDA kernel (``csrc/fused_frontend.cu``), the port of
``mla_tpu/ops/pallas_frontend.py::fused_log_mel_patches``.

The kernel frames straight from the waveform, so unlike the TPU kernel it
needs no residue-class copies of it: device traffic is the waveform in
once and the log-mel rows out once. The .cu file's header says what bounds
it and how it is laid out.

``fused_log_mel_patches`` launches the kernel for a CUDA tensor (or raises)
and takes its plain torch version, ``fused_log_mel_patches_reference``, only
for a CPU tensor. ``LAUNCHES`` counts kernel launches. It has no backward,
as the reference has none: the train step applies it to data, outside
autograd, and a waveform that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mla_tpu_torch.config import FrontendConfig
from mla_tpu_torch.ops import _build
from mla_tpu_torch.ops.frontend import device_bases, dot, frame_signal

LAUNCHES = 0  # kernel launches, for showing a run went through the kernel

_MODES = {"highest": 0, "high": 0, "default": 1, "bf16x3": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"mla_fused_log_mel": [_P] * 5 + [_I] * 8 + [ctypes.c_float, _I, _P]}


def _framing_plan(cfg: FrontendConfig, n_samples: int):
    """Static framing geometry for one clip (same checks and messages as the
    TPU kernel's plan)."""
    window, hop = cfg.window_length, cfg.hop_length
    wf, hf = cfg.example_window_frames, cfg.example_hop_frames
    if hf != wf:
        raise NotImplementedError(
            "fused Pallas front-end supports non-overlapping patches only "
            f"(example_hop_frames={hf} != example_window_frames={wf}); "
            "use FrontendConfig.impl='xla' for overlapping patch configs"
        )
    n_frames = 1 + (n_samples - window) // hop
    n_patches = 1 + (n_frames - wf) // hf
    if n_patches < 1:
        raise ValueError(f"clip too short: {n_samples} samples -> {n_frames} frames < {wf}")
    used_frames = (n_patches - 1) * hf + wf
    blocks_needed = -(-window // hop)
    usable = (used_frames - 1 + blocks_needed) * hop
    if usable > n_samples:
        raise ValueError(
            f"need {usable} samples for {used_frames} whole frames, clip has {n_samples}"
        )
    return window, hop, used_frames, n_patches, blocks_needed, usable


@functools.lru_cache(maxsize=16)
def _trimmed_bases(cfg: FrontendConfig, device: torch.device):
    """The kernel's constant operands on ``device``: the trimmed DFT bases
    (``frontend.trimmed_spectral_bases``) with their rows zero-padded to a
    multiple of 4, since the kernel reads taps four at a time, and the mel
    filterbank. Unlike the TPU kernel's, no padding to g * hop rows."""
    cos_b, sin_b, mel_t = device_bases(cfg, device)
    pad = -cos_b.shape[0] % 4
    return F.pad(cos_b, (0, 0, 0, pad)), F.pad(sin_b, (0, 0, 0, pad)), mel_t


def fused_log_mel_patches(
    wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig(), precision: str = "highest"
) -> torch.Tensor:
    """Waveform [B, n] or [n] f32 -> log-mel patches [B, N, 96, 64] (or
    [N, 96, 64]). A CUDA tensor launches the kernel on the current stream;
    a CPU tensor takes the plain torch version."""
    global LAUNCHES
    if precision not in _MODES:
        raise ValueError(f"unknown precision {precision!r}; pick from {sorted(_MODES)}")
    if wav.dim() == 1:
        return fused_log_mel_patches(wav[None], cfg, precision)[0]
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, n] or [n], got shape {tuple(wav.shape)}")
    if wav.dtype != torch.float32:
        raise TypeError(f"wav must be float32, got {wav.dtype}")
    if not wav.is_contiguous():
        raise ValueError("wav must be contiguous")
    if wav.requires_grad:  # the kernel has no backward; never cut a gradient silently
        raise RuntimeError("fused_log_mel_patches has no backward: pass a waveform that "
                           "does not require grad (the train step runs it under no_grad)")
    b, n_samples = wav.shape
    window, hop, used_frames, n_patches, _, _ = _framing_plan(cfg, n_samples)
    if wav.device.type == "cpu":
        return fused_log_mel_patches_reference(wav, cfg, precision)
    if wav.device.type != "cuda":
        raise ValueError(f"fused_log_mel_patches runs on cuda or cpu, got {wav.device}")

    cos_b, sin_b, mel_t = _trimmed_bases(cfg, wav.device)
    kp, n_bins = cos_b.shape
    n_mel = cfg.num_mel_bins
    out = torch.empty((b, used_frames, n_mel), dtype=torch.float32, device=wav.device)
    lib = _build.load("fused_frontend", _SIGNATURES)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        err = lib.mla_fused_log_mel(
            wav.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), mel_t.data_ptr(),
            out.data_ptr(), b, n_samples, used_frames, window, kp, hop, n_bins,
            n_mel, cfg.log_offset, _MODES[precision], stream)
    if err != 0:  # e.g. a batch past the grid limit or a window too wide for shared memory
        raise RuntimeError(f"fused_log_mel_patches kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out.view(b, n_patches, cfg.example_window_frames, n_mel)


def fused_log_mel_patches_reference(
    wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig(), precision: str = "highest"
) -> torch.Tensor:
    """The kernel's plain torch version: the same operand rounding per mode
    (``ops.frontend.dot``), f32 mel product, summed in another order."""
    if wav.dim() == 1:
        return fused_log_mel_patches_reference(wav[None], cfg, precision)[0]
    if precision not in _MODES:
        raise ValueError(f"unknown precision {precision!r}; pick from {sorted(_MODES)}")
    b, n_samples = wav.shape
    window, hop, used_frames, n_patches, _, _ = _framing_plan(cfg, n_samples)
    cos_b, sin_b, mel_t = device_bases(cfg, wav.device)
    frames = frame_signal(wav.to(torch.float32), window, hop)[:, :used_frames]
    re = dot(frames, cos_b, precision)
    im = dot(frames, sin_b, precision)
    mag = torch.sqrt(re * re + im * im)
    log_mel = torch.log(mag @ mel_t + cfg.log_offset)
    return log_mel.reshape(b, n_patches, cfg.example_window_frames, cfg.num_mel_bins)


def frontend_bytes_moved(batch: int, n_samples: int, cfg: FrontendConfig = FrontendConfig()) -> int:
    """Device-memory traffic the fused kernel must make (roofline
    denominator): the waveform span its frames cover, read once, and the
    log-mel rows written once. The constant bases are not counted."""
    _, _, used_frames, _, _, usable = _framing_plan(cfg, n_samples)
    return batch * (usable * 4 + used_frames * cfg.num_mel_bins * 4)
