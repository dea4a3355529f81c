"""Streaming inference (counterpart of ``mla_tpu/serve/streaming.py``):
raw waveform in, clip scores out, any length of audio in O(1) state.

Each chunk of whole patches runs front-end -> trunk -> per-level (gate,
cla) logits and folds them into the attention accumulators
(``ops.attention_pool``); scores can be read at any time by finalizing
the state, and equal the whole-clip forward. With ``timeline_cap`` > 0 the
tagger also keeps the on-device localization ring
(``ops.attention_pool.TimelineState``) and ``timeline()`` reads it.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import frontend as fe


def _samples_per_patches(cfg, n_patches: int) -> int:
    """Samples consumed by exactly n_patches non-overlapping patches,
    rounded up to whole hop blocks, so one chunk size serves both front-end
    impls (the fused kernel's plan asks for ceil(window / hop) hop blocks
    behind the last frame)."""
    frames = n_patches * cfg.example_hop_frames + (
        cfg.example_window_frames - cfg.example_hop_frames
    )
    g = -(-cfg.window_length // cfg.hop_length)
    return (frames - 1 + g) * cfg.hop_length


def _whole_patches(cfg, n_samples: int) -> int:
    """Number of complete patches in n_samples."""
    if n_samples < cfg.window_length:
        return 0
    frames = 1 + (n_samples - cfg.window_length) // cfg.hop_length
    if frames < cfg.example_window_frames:
        return 0
    return 1 + (frames - cfg.example_window_frames) // cfg.example_hop_frames


STREAMING_VARIANTS = (
    "multi_level_attention",
    "single_attention",
    "multi_attention",
    "avg_pool",
    "max_pool",
)


def stream_activations(mcfg) -> tuple:
    """(att_activation, cla_activation) the streaming accumulators use: the
    pool baselines map onto the same state (avg = exp gate over zero gate
    logits, max = the running-max mode)."""
    if mcfg.variant == "avg_pool":
        return "exp", "sigmoid"
    if mcfg.variant == "max_pool":
        return "max", "sigmoid"
    return mcfg.att_activation, mcfg.cla_activation


def n_stream_levels(mcfg) -> int:
    """Independent (gate, cla) accumulator pairs a variant streams."""
    if mcfg.variant == "multi_level_attention":
        return mcfg.n_blocks
    if mcfg.variant == "multi_attention":
        return mcfg.n_attention_heads
    return 1


def stream_finalize_scores(model, variant: str, states) -> torch.Tensor:
    """Pooled accumulator states -> clip scores (the variant's tail)."""
    pooled = [ap.stream_finalize(st) for st in states]
    if variant == "multi_level_attention":
        return model.finalize_multi_level(pooled)
    if variant == "multi_attention":
        return model.finalize_multi_head(pooled)
    return pooled[0]


def _model_with_weights(cfg: Config, state_dict: Mapping, device: torch.device):
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(state_dict)
    return model.to(device).eval()


class StreamingTagger:
    """Long-form audio tagger with O(1) device state.

    >>> tagger = StreamingTagger(cfg, state_dict, device="cuda")
    >>> for block in waveform_blocks:     # arbitrary sizes
    ...     tagger.feed(block)
    >>> scores = tagger.scores()          # may be called mid-stream too
    """

    def __init__(self, cfg: Config, state_dict: Mapping, chunk_patches: int = 10,
                 timeline_cap: int = 0, device=None):
        """``timeline_cap`` > 0 also records the last timeline_cap patches'
        (gate logits, segment probs) in a ring on the device, read with
        :meth:`timeline`; 0 disables it."""
        if cfg.model.variant not in STREAMING_VARIANTS:
            raise ValueError(f"unknown streaming variant {cfg.model.variant!r}; "
                             f"pick from {STREAMING_VARIANTS}")
        self.timeline_cap = int(timeline_cap)
        if self.timeline_cap and self.timeline_cap < chunk_patches:
            raise ValueError(f"timeline_cap {timeline_cap} must be >= chunk_patches "
                             f"{chunk_patches}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = _model_with_weights(cfg, state_dict, self.device)
        self.chunk_patches = chunk_patches
        self.chunk_samples = _samples_per_patches(cfg.frontend, chunk_patches)
        self._n_levels = n_stream_levels(cfg.model)
        self._acts = stream_activations(cfg.model)
        self.reset()

    def reset(self):
        self._buf = np.zeros(0, np.float32)
        self.states: List[ap.StreamState] = [
            ap.init_stream_state((1, self.cfg.model.n_classes), device=self.device)
            for _ in range(self._n_levels)
        ]
        self.tl = (ap.init_timeline_state(1, self.timeline_cap, self._n_levels,
                                          self.cfg.model.n_classes, device=self.device)
                   if self.timeline_cap else None)
        self._fed_any = False

    @torch.inference_mode()
    def _fold(self, wav: np.ndarray):
        """Fold one chunk of whole patches (every one of them valid)."""
        x = torch.from_numpy(np.ascontiguousarray(wav[None])).to(self.device)
        levels = self.model.segment_logits(fe.apply_frontend(x, self.cfg.frontend))
        self.states = [ap.update_stream_state(st, g, c, *self._acts)
                       for st, (g, c) in zip(self.states, levels)]
        if self.tl is not None:
            g_stack = torch.stack([g for g, _ in levels], dim=2)
            f_stack = torch.stack([ap.cla_activation(c, self._acts[1]) for _, c in levels], dim=2)
            self.tl = ap.update_timeline_state(
                self.tl, g_stack, f_stack, torch.ones(1, dtype=torch.bool, device=self.device),
                torch.full((1,), g_stack.shape[1], dtype=torch.int32, device=self.device))
        self._fed_any = True

    def feed(self, waveform: np.ndarray):
        """Append raw 16 kHz mono samples; device work happens per full chunk."""
        self._buf = np.concatenate([self._buf, np.asarray(waveform, np.float32)])
        hop_samples = self.cfg.frontend.example_hop_frames * self.cfg.frontend.hop_length
        while len(self._buf) >= self.chunk_samples:
            self._fold(self._buf[: self.chunk_samples])
            self._buf = self._buf[self.chunk_patches * hop_samples:]

    def flush(self):
        """Process the remaining whole patches; the sub-patch remainder is
        dropped, except that a stream too short for one patch is zero-padded
        to one so it still yields scores."""
        fcfg = self.cfg.frontend
        n_patches = _whole_patches(fcfg, len(self._buf))
        if n_patches < 1:
            if self._fed_any or len(self._buf) == 0:
                self._buf = np.zeros(0, np.float32)
                return
            n_patches = 1
        size = _samples_per_patches(fcfg, n_patches)
        padded = np.zeros(size, np.float32)
        padded[: min(len(self._buf), size)] = self._buf[:size]
        self._fold(padded)
        self._buf = np.zeros(0, np.float32)

    @torch.inference_mode()
    def scores(self) -> np.ndarray:
        """Current clip-level scores [n_classes]."""
        if not self._fed_any:
            raise RuntimeError("no audio fed yet")
        out = stream_finalize_scores(self.model, self.cfg.model.variant, self.states)
        return out[0].float().cpu().numpy()

    def top_k(self, k: int = 5, labels: Optional[List[str]] = None):
        s = self.scores()
        order = np.argsort(-s)[:k]
        return [(labels[i] if labels else int(i), float(s[i])) for i in order]

    def timeline(self):
        """Localization window over the last ``timeline_cap`` patches:
        ``(start_patch, [(weights [T, C], probs [T, C]) per level])``, the
        streaming counterpart of ``AudioTagger.timeline``."""
        if not self._fed_any:
            raise RuntimeError("no audio fed yet")
        return ap.read_timeline(self.states, self.tl, 0, self._acts[0])


@torch.inference_mode()
def tag_clip(cfg: Config, state_dict: Mapping, waveform: np.ndarray, device=None) -> np.ndarray:
    """One-shot inference: whole waveform -> clip scores [n_classes]."""
    dev = resolve_device(device)
    model = _model_with_weights(cfg, state_dict, dev)
    x = torch.from_numpy(np.ascontiguousarray(waveform, np.float32)[None]).to(dev)
    return model(fe.apply_frontend(x, cfg.frontend))[0].float().cpu().numpy()
