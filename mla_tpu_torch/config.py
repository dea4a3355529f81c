"""Config / flag system (reference C17: argparse tree + constants module).

The PyTorch port's own copy of ``mla_tpu/config.py``: the same dataclasses,
presets and override rules, so a config built for one package means the
same thing in the other. Only the meaning of ``FrontendConfig.impl`` is the
port's: "xla" is the torch-ops front-end, "pallas" the fused CUDA kernel.

The reference family keeps audio constants in a ``vggish_params.py``-style
module and wires everything else through argparse (SURVEY.md §2.1 C17,
unverified paths — mount empty). Here the whole tree is plain dataclasses:
one named config per BASELINE.json milestone (lines 7-11), overridable from
the CLI with ``--set key=value`` dotted paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """VGGish log-mel semantics (reference C3; arXiv:1803.02353 input spec).

    Constants follow the canonical VGGish front-end: 16 kHz mono, 25 ms
    periodic-Hann window / 10 ms hop, |STFT| with fft_length = next pow2 of
    the window, 64 mel bins spanning 125-7500 Hz (HTK mel scale), log(mel +
    0.01), framed into non-overlapping 0.96 s patches of 96 frames x 64 bins.
    """

    sample_rate: int = 16000
    stft_window_seconds: float = 0.025
    stft_hop_seconds: float = 0.010
    fft_length: Optional[int] = None  # None -> next power of two of window
    num_mel_bins: int = 64
    mel_min_hz: float = 125.0
    mel_max_hz: float = 7500.0
    log_offset: float = 0.01
    example_window_seconds: float = 0.96
    example_hop_seconds: float = 0.96
    # implementation: "xla" (torch ops, runs anywhere) | "pallas" (the fused
    # hand-written CUDA kernel; a CPU tensor takes its plain torch version)
    impl: str = "xla"
    # matmul precision for the DFT/mel GEMMs: "highest" == f32 parity
    # (~1e-4 vs oracle), "default" == bf16 passes (~4e-2, ~25% faster)
    precision: str = "highest"

    @property
    def window_length(self) -> int:
        return int(round(self.sample_rate * self.stft_window_seconds))

    @property
    def hop_length(self) -> int:
        return int(round(self.sample_rate * self.stft_hop_seconds))

    @property
    def fft_size(self) -> int:
        if self.fft_length is not None:
            return self.fft_length
        n = 1
        while n < self.window_length:
            n *= 2
        return n

    @property
    def num_spectrogram_bins(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def example_window_frames(self) -> int:
        return int(round(self.example_window_seconds / self.stft_hop_seconds))

    @property
    def example_hop_frames(self) -> int:
        return int(round(self.example_hop_seconds / self.stft_hop_seconds))


@dataclass(frozen=True)
class ModelConfig:
    """Model zoo (reference C4-C8, arXiv:1803.02353 §2).

    ``variant`` selects the clip-level head family:
      - ``multi_level_attention``: attention module after EACH embedded
        mapping block, pooled vectors concatenated -> FC -> sigmoid (C7).
      - ``single_attention``: one attention module on the last block (C8).
      - ``multi_attention``: several attention heads on the LAST block (C8).
      - ``avg_pool`` / ``max_pool``: decision-level average / max (C8).
    ``trunk`` selects the segment-embedding producer:
      - ``cnn``: deep CNN over each 96x64 log-mel patch (caesar-one trains
        the trunk itself; compact NHWC conv stack, TPU-friendly widths).
      - ``vggish``: the exact VGGish topology (conv 64/128/256x2/512x2 +
        FC 4096x2 + FC 128) for embedding parity work.
      - ``none``: input already is a [T, embed_dim] bottleneck-feature
        sequence (the upstream audioset_classification protocol).
    """

    variant: str = "multi_level_attention"
    trunk: str = "cnn"
    n_classes: int = 527
    embed_dim: int = 128
    # Embedded mapping blocks (C5): paper uses 1-3 blocks of 1-3 FC layers.
    n_blocks: int = 3
    layers_per_block: int = 1
    hidden_units: int = 512
    dropout_rate: float = 0.4
    # Attention module activations (C6). ``exp`` for the gate == softmax over
    # time after normalization ("learned softmax weights", BASELINE.json:5).
    att_activation: str = "exp"
    cla_activation: str = "sigmoid"
    n_attention_heads: int = 4  # only for variant == "multi_attention"
    # Trunk widths (``cnn`` trunk): channels per conv stage, 2x2 maxpool after
    # each; batch-norm + ReLU per conv.
    conv_channels: Tuple[int, ...] = (64, 128, 256, 512)
    convs_per_stage: int = 2
    compute_dtype: str = "bfloat16"  # activations/matmuls; params stay f32
    # jax.checkpoint the trunk: recompute activations in backward instead of
    # storing them — trades MXU FLOPs for HBM (long clips / big batches)
    remat_trunk: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset acquisition / packing / sampling (reference C1, C2, C9)."""

    dataset: str = "synthetic_esc50"  # synthetic_esc50|synthetic_us8k|synthetic_audioset|hdf5
    # one pack, a comma-separated list, or a glob ("packs/train_*.h5") —
    # sharded packs concatenate (AudioSet bal_train + unbal_train, C2)
    hdf5_path: Optional[str] = None
    eval_hdf5_path: Optional[str] = None
    # Stream x from the HDF5 pack instead of loading it to RAM (T9 at
    # full-AudioSet scale: ~640 GB of waveforms cannot load; labels stay
    # in RAM for the balanced sampler's per-class tables). Train feeds
    # read per batch (sorted-unique chunked reads) and still go through
    # staging_dtype wire encoding; device residency is skipped.
    out_of_core: bool = False
    # synthetic dataset sizing
    n_train_clips: int = 256
    n_eval_clips: int = 64
    clip_seconds: float = 10.0
    balanced_sampling: bool = True
    quantized_uint8: bool = False  # upstream packs 8-bit quantized embeddings
    # input pipeline: "numpy" = reference-faithful stateful BalancedSampler;
    # "grain" = stateless Grain stream (T9 scale path: prefetch, shardable)
    pipeline: str = "numpy"
    grain_workers: int = 0  # >0 enables grain multiprocess prefetch
    # Keep the whole training set HBM-resident and gather batches ON DEVICE
    # by index (numpy pipeline only; auto-skipped above the byte budget).
    # The reference loads all data to host RAM (C2); the TPU-native move is
    # loading it to HBM once — per-step host->device traffic drops from the
    # full waveform batch to one index vector.
    device_resident: bool = True
    device_resident_max_bytes: int = 2 * 1024**3
    # Wire precision WAVEFORM batches travel to the device in:
    # float32 | int16 (2x, lossless for PCM16-sourced audio) | uint8
    # (8-bit mu-law, 4x, ~38 dB SNR) | adpcm4 (4-bit block ADPCM, ~8x,
    # ~24 dB SNR). The 2-bit adpcm2 wire is deliberately serving-only
    # (~14 dB SNR holds tagging top-1 but is untested for gradient
    # fidelity; adpcm4's loss trajectory was measured to match f32).
    # Applies to BOTH input paths: the device-resident
    # dataset is staged in HBM compressed (2-8x more audio per chip) and
    # streamed batches (grain / non-resident) are encoded per batch on
    # host — either way the train step decodes on device. Streaming is
    # where it matters at scale: real AudioSet waveforms (~640 GB) can
    # only stream, and a transfer-bound host pays ~50 ms/MB.
    staging_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Train/eval loop knobs (reference C10-C12, C14)."""

    batch_size: int = 128
    learning_rate: float = 1e-3
    # C11 "optional decay": constant | cosine | exponential
    lr_schedule: str = "constant"
    lr_decay_rate: float = 0.96  # per 1000 steps, exponential schedule
    warmup_steps: int = 0
    gradient_clip_norm: float = 0.0  # 0 = off
    num_steps: int = 1000
    eval_every: int = 200
    checkpoint_every: int = 500  # 0 disables PERIODIC checkpointing (a
    # graceful preemption still saves one so the run stays resumable)
    keep_checkpoints: int = 3
    seed: int = 0
    log_every: int = 20
    # parallelism (T2-T6): mesh axis sizes; -1 on data = all remaining devices
    data_parallel: int = -1
    model_parallel: int = 1
    donate_state: bool = True
    # sanitizer toggle (SURVEY.md §5: jax_debug_nans covers the realistic
    # failure class; there is no shared-memory race surface under XLA)
    debug_nans: bool = False
    # optional TensorBoard event-file sink next to the CSV scalars
    # (workspace/tensorboard/<config name>; torch.utils.tensorboard, which
    # needs the tensorboard package: without it, CSV only and a warning)
    tensorboard: bool = False
    # front-end DFT precision inside the TRAIN step only (None = inherit
    # frontend.precision). "default" (bf16) is ~6x cheaper and training is
    # robust to the ~1e-2 log-mel error; eval/inference keep full parity.
    frontend_precision: Optional[str] = None
    # SpecAugment-style masking on log-mel patches during training (train
    # step only; waveform/patch inputs — no-op for the features protocol)
    spec_augment: bool = False
    time_mask_width: int = 24
    freq_mask_width: int = 12
    # mixup over the batch (any input kind); 0 = off
    mixup_alpha: float = 0.0
    # Polyak/EMA of params: shadow tree decayed toward the online params
    # each step (0 = off; typical 0.999); ema_eval reads it for eval and
    # checkpoint-served inference — the smoother late-training operating
    # point standard in audio tagging
    ema_decay: float = 0.0
    ema_eval: bool = True


@dataclass(frozen=True)
class Config:
    name: str = "default"
    workspace: str = "workspace"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _esc50() -> Config:
    """BASELINE.json:7 — single-attention CNN on ESC-50, CPU-runnable, batch 8."""
    return Config(
        name="esc50_single_attention",
        model=ModelConfig(
            variant="single_attention",
            trunk="cnn",
            n_classes=50,
            n_blocks=1,
            conv_channels=(32, 64, 128),
            convs_per_stage=1,
            hidden_units=256,
            compute_dtype="float32",
        ),
        data=DataConfig(dataset="synthetic_esc50", clip_seconds=5.0),
        train=TrainConfig(batch_size=8, num_steps=200, eval_every=100),
    )


def _us8k() -> Config:
    """BASELINE.json:8 — UrbanSound8K 10-class, fused front-end kernel + CNN."""
    return Config(
        name="us8k_fused_frontend",
        frontend=FrontendConfig(impl="pallas"),
        model=ModelConfig(
            variant="single_attention",
            trunk="cnn",
            n_classes=10,
            n_blocks=1,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(dataset="synthetic_us8k", clip_seconds=4.0),
        train=TrainConfig(batch_size=64, num_steps=500),
    )


def _audioset_balanced() -> Config:
    """BASELINE.json:9 — multi-level attention on AudioSet balanced subset."""
    return Config(
        name="audioset_multi_level",
        model=ModelConfig(
            variant="multi_level_attention",
            trunk="none",
            n_classes=527,
            n_blocks=3,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(dataset="synthetic_audioset"),
        train=TrainConfig(batch_size=500, num_steps=2000, eval_every=500),
    )


def _audioset_full_dp() -> Config:
    """BASELINE.json:10 — full 527-class training, DP over ICI, mixed precision."""
    return Config(
        name="audioset_full_dp",
        # frontend default precision matches what the TRAIN step already does
        # in-step (frontend_precision="default" below): inferring at HIGHEST
        # was a train/serve numerics mismatch, and the DFT GEMMs at HIGHEST
        # are a 2-pass penalty on this chip. Fidelity + throughput measured
        # on-chip round 5 before flipping (docs/RESULTS.md round-5 record).
        frontend=FrontendConfig(precision="default"),
        model=ModelConfig(
            variant="multi_level_attention",
            trunk="cnn",
            n_classes=527,
            n_blocks=3,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(dataset="synthetic_audioset", n_train_clips=1024),
        train=TrainConfig(batch_size=256, num_steps=5000, data_parallel=-1,
                          frontend_precision="default"),
    )


def _streaming() -> Config:
    """BASELINE.json:11 — streaming inference: raw waveform in -> clip scores."""
    return Config(
        name="streaming_inference",
        # same rationale as audioset_full_dp: serving ticks run the front-end
        # at the training step's default precision (HIGHEST stays pinned on
        # the parity harness, which builds its own FrontendConfig()).
        frontend=FrontendConfig(precision="default"),
        model=ModelConfig(
            variant="multi_level_attention",
            trunk="cnn",
            n_classes=527,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(dataset="synthetic_audioset"),
    )


_CONFIGS = {
    "default": Config,
    "esc50_single_attention": _esc50,
    "us8k_fused_frontend": _us8k,
    "audioset_multi_level": _audioset_balanced,
    "audioset_full_dp": _audioset_full_dp,
    "streaming_inference": _streaming,
}


def list_configs():
    return sorted(_CONFIGS)


def get_config(name: str = "default", overrides: Optional[Dict[str, Any]] = None) -> Config:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {list_configs()}")
    cfg = _CONFIGS[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {"train.batch_size": 32}."""
    for path, value in overrides.items():
        parts = path.split(".")
        cfg = _set_path(cfg, parts, value)
    return cfg


def _set_path(node, parts, value):
    name = parts[0]
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot descend into non-dataclass at {name!r}")
    if len(parts) == 1:
        current = getattr(node, name)
        if current is not None and not isinstance(value, type(current)):
            if isinstance(current, bool):
                value = str(value).lower() in ("1", "true", "yes")
            elif isinstance(current, tuple):
                value = tuple(type(current[0])(v) for v in str(value).split(","))
            else:
                value = type(current)(value)
        return dataclasses.replace(node, **{name: value})
    child = _set_path(getattr(node, name), parts[1:], value)
    return dataclasses.replace(node, **{name: child})
