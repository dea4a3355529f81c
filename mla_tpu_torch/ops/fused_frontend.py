"""Fused log-mel front-end: waveform [B, n] -> log-mel patches [B, N, 96, 64]
in one hand-written CUDA kernel (``csrc/fused_frontend.cu``), the port of
``mla_tpu/ops/pallas_frontend.py::fused_log_mel_patches``.

The kernel frames straight from the waveform and takes the DFT on the
tensor cores with mma.sync. Unlike the TPU kernel it needs no residue-class
copies of the waveform: device traffic is the waveform in once and the
log-mel rows out once. The .cu file's header says what bounds it and how it
is laid out.

``fused_log_mel_patches`` launches the kernel for a CUDA tensor (or raises)
and takes its plain torch version, ``fused_log_mel_patches_reference``, only
for a CPU tensor. ``LAUNCHES`` counts kernel launches. It has no backward,
as the reference has none: the train step applies it to data, outside
autograd, and a waveform that requires grad is refused.

The kernel's operands are built here, on the CPU, where the tests reach
them: ``pack_dft_bases`` rounds or splits the bases per mode and lays them
out in the order of mma.sync's B fragments, and ``tile_frames`` picks the
frame tile of a launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mla_tpu_torch.config import FrontendConfig
from mla_tpu_torch.ops import _build
from mla_tpu_torch.ops.frontend import device_bases, dot, frame_signal, trimmed_spectral_bases

LAUNCHES = 0  # kernel launches, for showing a run went through the kernel

_MODES = {"highest": 0, "high": 0, "default": 1, "bf16x3": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"mla_fused_log_mel_mma": [_P] * 4 + [_I] * 8 + [_F, _I, _I, _P]}

# the kernel (csrc/fused_frontend.cu)
TILE_FRAMES = (64, 32, 16)  # its frame tiles, largest first
SMEM_BYTES = 232448  # shared memory a block may take on sm_90
RING_BYTES = 49152  # its warps' B-fragment rings, every mode
MAX_MMA_MEL_BINS = 64  # one mel bin per thread for a quarter of its 256 threads


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


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, as f32: what
    ``cvt.rna.tf32.f32`` computes (the low 13 bits of the bit pattern
    rounded off)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """f32 -> (big, small) with big = tf32(a), small = tf32(a - big): the
    3xTF32 split (big*big + big*small + small*big keeps ~21 bits)."""
    big = round_tf32(a)
    return big, round_tf32(a - big)


def _is_tf32(precision: str) -> bool:
    return precision in ("highest", "high")


def padded_sizes(cfg: FrontendConfig):
    """(kp, np): taps and mel-active bins, each zero-padded to a multiple
    of 16, the kernel's K and N."""
    n_bins = trimmed_spectral_bases(cfg)[3]
    return -(-cfg.window_length // 16) * 16, -(-n_bins // 16) * 16


def fragment_coords(kp: int, np_: int, precision: str):
    """(k, n), each [kp / KS, np / 8, 32, E]: the basis element that lane
    ``l`` holds as the e-th value of its B fragment for k-step s and n-tile
    j, in the order the kernel reads them. bf16 m16n8k16 (KS 16): k = 2t,
    2t + 1, 2t + 8, 2t + 9; TF32 m16n8k8 (KS 8): k = t, t + 4; both with
    t = l % 4 and n = 8 j + l // 4 (PTX ISA, mma.sync fragment layouts)."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    if _is_tf32(precision):
        ks, kk = 8, torch.stack([t, t + 4], 1)
    else:
        ks, kk = 16, torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], 1)
    k = torch.arange(kp // ks)[:, None, None, None] * ks + kk
    n = torch.arange(np_ // 8)[None, :, None, None] * 8 + g[:, None]
    return torch.broadcast_tensors(k, n)


def pack_dft_bases(cfg: FrontendConfig, precision: str):
    """The kernel's constant operands, on the CPU: (basis, mel).

    ``basis`` is int32 [kp / KS, np / 8, 32, W]: for each k-step, n-tile and
    lane, the lane's B fragment words, cos first, then sin. "default": the
    bf16 basis (W 4: cos b0 b1, sin b0 b1, two bf16 per word, the lower k in
    the low half); "bf16x3": hi then lo = bf16(basis - hi) for each (W 8);
    "highest" / "high": big then small (``split_tf32``) as f32 bit patterns
    (W 8). Taps past the window and bins past the mel-active ones are zero.
    ``mel`` is the filterbank [np, n_mel], rows past the mel-active bins
    zero."""
    cos_b, sin_b, mel_t, n_bins = trimmed_spectral_bases(cfg)
    kp, np_ = padded_sizes(cfg)
    k, n = fragment_coords(kp, np_, precision)
    words = []
    for basis in (cos_b, sin_b):
        padded = torch.zeros(kp, np_)
        padded[: basis.shape[0], :n_bins] = torch.from_numpy(basis)
        frag = padded[k, n]
        if _is_tf32(precision):
            words += [p.view(torch.int32) for p in split_tf32(frag)]
        else:
            hi = frag.to(torch.bfloat16)
            words.append(hi.view(torch.int32))
            if precision == "bf16x3":
                words.append((frag - hi.float()).to(torch.bfloat16).view(torch.int32))
    mel = torch.zeros(np_, mel_t.shape[1])
    mel[:n_bins] = torch.from_numpy(mel_t)
    return torch.cat(words, dim=-1).contiguous(), mel


@functools.lru_cache(maxsize=16)
def _mma_operands(cfg: FrontendConfig, device: torch.device, kind: str):
    """``pack_dft_bases`` on ``device``, made once per (config, device,
    operand kind)."""
    return tuple(a.to(device) for a in pack_dft_bases(cfg, kind))


def mma_smem_bytes(bm: int, kp: int, np_: int, precision: str) -> int:
    """Shared memory of one block: the f32 frame tile (row stride kp + 4
    for TF32, kp + 8 for bf16), the magnitude tile (row stride np + 8) and
    the warps' B rings."""
    return 4 * bm * (kp + (4 if _is_tf32(precision) else 8) + np_ + 8) + RING_BYTES


def tile_grid(batch: int, used_frames: int, bm: int):
    """The kernel's grid: (tiles per clip, clips). Block (x, b) takes
    frames [x * bm, min((x + 1) * bm, used_frames)) of clip b."""
    return -(-used_frames // bm), batch


def tile_frames(batch: int, used_frames: int, kp: int, np_: int, precision: str,
                n_sm: int) -> int:
    """The frame tile BM of one launch: the largest of ``TILE_FRAMES`` whose
    block fits in shared memory and whose grid gives at least 7/8 of the SMs
    a block; else the smallest that fits. A larger tile reads the bases from
    L2 fewer times per frame; a grid well under the SM count leaves SMs
    idle. (Measured on an H100, PERF.md: at 8 clips of 480 frames BM 32,
    120 blocks, beats both BM 16, 240 blocks, and BM 64, 64 blocks.)"""
    fits = [bm for bm in TILE_FRAMES if mma_smem_bytes(bm, kp, np_, precision) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"window {kp} taps x {np_} bins does not fit one block's shared memory")
    for bm in fits:
        x, b = tile_grid(batch, used_frames, bm)
        if 8 * x * b >= 7 * n_sm:
            return bm
    return fits[-1]


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_log_mel_patches(
    wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig(), precision: str = "highest",
    *, _bm: Optional[int] = None,
) -> torch.Tensor:
    """Waveform [B, n] or [n] f32 -> log-mel patches [B, N, 96, 64] (or
    [N, 96, 64]). A CUDA tensor launches the kernel on the current stream;
    a CPU tensor takes the plain torch version. ``_bm`` forces the frame
    tile (else ``tile_frames``), so that a test reaches every tile."""
    global LAUNCHES
    if precision not in _MODES:
        raise ValueError(f"unknown precision {precision!r}; pick from {sorted(_MODES)}")
    if wav.dim() == 1:
        return fused_log_mel_patches(wav[None], cfg, precision, _bm=_bm)[0]
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

    n_mel = cfg.num_mel_bins
    if n_mel > MAX_MMA_MEL_BINS:
        raise ValueError(f"the kernel takes at most {MAX_MMA_MEL_BINS} mel bins (one per "
                         f"thread for a quarter of the tile), got {n_mel}")
    kind = "highest" if _is_tf32(precision) else precision
    basis, mel = _mma_operands(cfg, wav.device, kind)
    kp, np_ = padded_sizes(cfg)
    bm = _bm or tile_frames(b, used_frames, kp, np_, precision, _sm_count(wav.device))
    out = torch.empty((b, used_frames, n_mel), dtype=torch.float32, device=wav.device)
    lib = _build.load("fused_frontend", _SIGNATURES)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        err = lib.mla_fused_log_mel_mma(
            wav.data_ptr(), basis.data_ptr(), mel.data_ptr(), out.data_ptr(), b, n_samples,
            used_frames, window, kp, hop, np_, n_mel, cfg.log_offset, _MODES[precision], bm,
            stream)
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
