"""The benchmark's frozen yardstick: the card's published peaks and the
operations and bytes that the model's work needs, counted from the
configuration's shapes alone. Nothing here reads the program: a roofline or
an ``mfu`` share divides by these numbers, so a change to the program can
never move its own denominator.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), stated
at the full 700 W power limit; the harness prints the card's own limit beside
every run.
"""

from __future__ import annotations

import math
from typing import Mapping

PEAK_BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores
PEAK_BYTES = 3.35e12  # HBM3 bytes per second


def _hertz_to_mel(hz: float) -> float:
    return 1127.0 * math.log(1.0 + hz / 700.0)


def frontend_geometry(fe: Mapping) -> dict:
    """Window, hop and FFT sizes in samples, and the number of DFT bins with a
    non-zero mel weight (the bins the DFT product has to compute), from the
    configuration's front-end block (VGGish: HTK mel bands, DC bin zero)."""
    sr = fe["sample_rate"]
    window = int(round(sr * fe["stft_window_seconds"]))
    hop = int(round(sr * fe["stft_hop_seconds"]))
    fft = 1
    while fft < window:
        fft *= 2
    n_spec = fft // 2 + 1
    lo, hi = _hertz_to_mel(fe["mel_min_hz"]), _hertz_to_mel(fe["mel_max_hz"])
    n_mel = fe["num_mel_bins"]
    last = 0
    for k in range(1, n_spec):  # bin 0 (DC) carries no mel weight
        m = _hertz_to_mel(k * sr / 2.0 / (n_spec - 1))
        if lo < m < hi:  # inside some band's triangle
            last = k
    frames = int(round(fe["example_window_seconds"] / fe["stft_hop_seconds"]))
    return {"window": window, "hop": hop, "fft": fft, "bins": last + 1, "n_mel": n_mel,
            "patch_frames": frames}


def frontend_flops_per_frame(fe: Mapping) -> dict:
    """Operations of one log-mel frame: the DFT as two products (cos and sin)
    over the window's taps and the mel-active bins, and the mel product."""
    g = frontend_geometry(fe)
    return {"dft": 2 * 2 * g["window"] * g["bins"], "mel": 2 * g["bins"] * g["n_mel"]}


def frontend_bytes_moved(batch: int, n_samples: int, fe: Mapping) -> int:
    """Device traffic the fused front-end must make for [batch, n_samples]:
    the waveform span its whole patches cover, read once, and the log-mel
    rows written once (a frozen copy of the program's roofline denominator,
    ``ops/fused_frontend.py::frontend_bytes_moved``)."""
    g = frontend_geometry(fe)
    window, hop, wf = g["window"], g["hop"], g["patch_frames"]
    n_frames = 1 + (n_samples - window) // hop
    n_patches = 1 + (n_frames - wf) // wf
    used_frames = n_patches * wf
    usable = (used_frames - 1 + -(-window // hop)) * hop
    return batch * (usable * 4 + used_frames * g["n_mel"] * 4)


def frontend_bound_s(rows: int, n_samples: int, fe: Mapping, precision: str) -> float:
    """The least time of the fused front-end over ``rows`` waveforms of
    ``n_samples``: the larger of its bytes at the memory rate and its
    operations at the peak of their route ("default": one bf16 pass of the
    DFT on the tensor cores; "highest": three TF32 passes; the mel product
    in f32 on the CUDA cores in every mode)."""
    g = frontend_geometry(fe)
    frames = (1 + ((1 + (n_samples - g["window"]) // g["hop"]) - g["patch_frames"])
              // g["patch_frames"]) * g["patch_frames"]
    f = frontend_flops_per_frame(fe)
    peak, passes = {"default": (PEAK_BF16_FLOPS, 1), "bf16x3": (PEAK_BF16_FLOPS, 3),
                    "highest": (PEAK_TF32_FLOPS, 3), "high": (PEAK_TF32_FLOPS, 3)}[precision]
    ops_s = rows * frames * (passes * f["dft"] / peak + f["mel"] / PEAK_F32_FLOPS)
    return max(ops_s, frontend_bytes_moved(rows, n_samples, fe) / PEAK_BYTES)


def trunk_flops_per_patch(model: Mapping, fe: Mapping) -> int:
    """Operations of the CompactCNN trunk on one 96 x 64 patch: each "SAME"
    3x3 convolution, a 2x2 pool after each stage while the map is 2x2 or
    more, and the embedding product. Batch norm, ReLU and pooling are not
    counted."""
    g = frontend_geometry(fe)
    h, w, cin, flops = g["patch_frames"], g["n_mel"], 1, 0
    for ch in model["conv_channels"]:
        for _ in range(model["convs_per_stage"]):
            flops += 2 * 9 * cin * ch * h * w
            cin = ch
        if min(h, w) >= 2:
            h, w = h // 2, w // 2
    return flops + 2 * cin * model["embed_dim"]


def head_flops_per_patch(model: Mapping) -> int:
    """Operations of the embedded mapping blocks and each level's gate and
    classifier products for one segment."""
    d, hu, c = model["embed_dim"], model["hidden_units"], model["n_classes"]
    flops = 0
    for b in range(model["n_blocks"]):
        for j in range(model["layers_per_block"]):
            flops += 2 * (d if b == 0 and j == 0 else hu) * hu
        flops += 2 * 2 * hu * c
    return flops


def head_flops_per_clip(model: Mapping) -> int:
    """The multi-level tail: one product of the levels' pooled vectors."""
    c = model["n_classes"]
    return 2 * model["n_blocks"] * c * c


def forward_flops_per_patch(model: Mapping, fe: Mapping) -> int:
    """Front-end, trunk and per-segment heads of one patch."""
    f = frontend_flops_per_frame(fe)
    g = frontend_geometry(fe)
    return (g["patch_frames"] * (f["dft"] + f["mel"]) + trunk_flops_per_patch(model, fe)
            + head_flops_per_patch(model))


def clip_patches(seconds: float, fe: Mapping) -> int:
    g = frontend_geometry(fe)
    n = int(round(seconds * fe["sample_rate"]))
    frames = 1 + (n - g["window"]) // g["hop"]
    return 1 + (frames - g["patch_frames"]) // g["patch_frames"]


def tag_flops_per_clip(model: Mapping, fe: Mapping, seconds: float) -> int:
    """One clip's forward: every patch through the front-end, trunk and heads,
    then the tail."""
    return (clip_patches(seconds, fe) * forward_flops_per_patch(model, fe)
            + head_flops_per_clip(model))


def train_flops_per_clip(model: Mapping, fe: Mapping, seconds: float) -> int:
    """One clip of a train step: the front-end once (it is data, outside
    autograd), the trunk and heads three times their forward (forward,
    and the backward's two products per layer)."""
    p = clip_patches(seconds, fe)
    f = frontend_flops_per_frame(fe)
    g = frontend_geometry(fe)
    front = p * g["patch_frames"] * (f["dft"] + f["mel"])
    model_fwd = p * (trunk_flops_per_patch(model, fe) + head_flops_per_patch(model)) \
        + head_flops_per_clip(model)
    return front + 3 * model_fwd
