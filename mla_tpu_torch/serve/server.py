"""Multi-stream batched inference server (counterpart of
``mla_tpu/serve/server.py``): many concurrent audio streams share one
batched device step per tick.

Each stream has O(1) attention state (one ``StreamState`` per level,
batched along the stream axis). The server owns S slots; feeds are buffered
per slot in numpy in the wire dtype, and every ``tick()`` gathers the slots
that have a full chunk, uploads one [S, chunk] batch and runs wire decode ->
front-end -> trunk -> per-level logits -> masked fold on the device. Rows
that are not ready are folded under a mask, so every tick has the same
shapes.

Not ported yet (ROADMAP.md queue A): the packed one-upload tick, the
adpcm4/adpcm2 wires, the timeline ring, a device mesh and weight reload.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.data.audio_io import mulaw_decode, mulaw_encode, pcm16_quantize
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.serve.streaming import (
    STREAMING_VARIANTS,
    _model_with_weights,
    _samples_per_patches,
    _whole_patches,
    n_stream_levels,
    stream_activations,
    stream_finalize_scores,
)

_WIRES = {"float32": np.float32, "int16": np.int16, "uint8": np.uint8}


class BatchedStreamingServer:
    """S concurrent long-form streams, one batched device step per tick.

    >>> srv = BatchedStreamingServer(cfg, state_dict, max_streams=8, device="cuda")
    >>> sid = srv.open()
    >>> srv.feed(sid, samples)        # any block size, any interleaving
    >>> srv.tick()                    # one batched device step
    >>> srv.scores(sid); srv.close(sid)
    """

    def __init__(self, cfg: Config, state_dict: Mapping, max_streams: int = 8,
                 chunk_patches: int = 5, transfer_dtype: str = "float32",
                 mesh=None, timeline_cap: int = 0, device=None):
        """``transfer_dtype`` is the wire the buffers hold and the upload
        carries: "float32", "int16" (PCM16, dequantized on the device) or
        "uint8" (8-bit mu-law, expanded on the device)."""
        if cfg.model.variant not in STREAMING_VARIANTS:
            raise ValueError(f"unknown streaming variant {cfg.model.variant!r}; "
                             f"pick from {STREAMING_VARIANTS}")
        if transfer_dtype in ("adpcm4", "adpcm2"):
            raise NotImplementedError(
                f"transfer_dtype={transfer_dtype!r} is not ported yet (ROADMAP.md queue A)")
        if transfer_dtype not in _WIRES:
            raise ValueError(
                f"transfer_dtype must be float32|int16|uint8|adpcm4|adpcm2, got {transfer_dtype!r}")
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported yet (ROADMAP.md queue A)")
        if timeline_cap:
            raise NotImplementedError("the timeline ring is not ported yet (ROADMAP.md queue A)")
        self.device = resolve_device(device)
        self.transfer_dtype = transfer_dtype
        self._buf_dtype = _WIRES[transfer_dtype]
        # silence in wire units: mu-law code 0 is full-scale -1.0, 128 is 0.0
        self._pad_value = 128 if self._buf_dtype == np.uint8 else 0
        self.cfg = cfg
        self.model = _model_with_weights(cfg, state_dict, self.device)
        self.S = max_streams
        self.chunk_patches = chunk_patches
        self.chunk_samples = _samples_per_patches(cfg.frontend, chunk_patches)
        self.hop_samples = (
            cfg.frontend.example_hop_frames * cfg.frontend.hop_length * chunk_patches
        )
        self._acts = stream_activations(cfg.model)
        self._bufs: List[Optional[np.ndarray]] = [None] * self.S
        self._fed = np.zeros(self.S, bool)
        self.dispatches = 0  # device steps run (ticks and flushes)
        self.states = [ap.init_stream_state((self.S, cfg.model.n_classes), device=self.device)
                       for _ in range(n_stream_levels(cfg.model))]

    @torch.inference_mode()
    def _step(self, wav: torch.Tensor, active: torch.Tensor, n_valid: torch.Tensor):
        """wav [S, chunk_samples] in the wire dtype; active [S] bool - fold
        only these rows; n_valid [S] int - real patches per row (a flush pads
        the tail; padded patches get gate logits of -inf, which every gate
        activation maps to 0)."""
        if wav.dtype == torch.int16:
            wav = wav.to(torch.float32) / 32768.0
        elif wav.dtype == torch.uint8:
            wav = mulaw_decode(wav)
        patches = fe.apply_frontend(wav, self.cfg.frontend)  # [S, P, 96, 64]
        levels = self.model.segment_logits(patches)
        p = patches.shape[1]
        tmask = torch.arange(p, device=self.device)[None, :] < n_valid[:, None]  # [S, P]
        mask = active[:, None]
        new_states = []
        for st, (g, c) in zip(self.states, levels):
            g = torch.where(tmask[..., None], g, -torch.inf)
            upd = ap.update_stream_state(st, g, c, *self._acts)
            new_states.append(ap.StreamState(*(torch.where(mask, u, o)
                                               for u, o in zip(upd, st))))
        self.states = new_states

    def _dispatch(self, wav: np.ndarray, active: np.ndarray, n_valid: np.ndarray):
        put = [torch.from_numpy(a).to(self.device, non_blocking=True)
               for a in (wav, active, n_valid)]
        self._step(*put)
        self.dispatches += 1

    def warmup(self):
        """Run one all-inactive tick and a finalize before serving: builds
        the front-end kernel and warms the library kernels, and leaves every
        stream state unchanged."""
        self._dispatch(self._blank_tile(), np.zeros(self.S, bool),
                       np.full(self.S, self.chunk_patches, np.int32))
        self._finalize()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- stream lifecycle ---
    def open(self) -> int:
        for sid in range(self.S):
            if self._bufs[sid] is None:
                self._bufs[sid] = np.zeros(0, self._buf_dtype)
                self._reset_slot(sid)
                return sid
        raise RuntimeError(f"all {self.S} stream slots busy")

    def close(self, sid: int):
        self._check(sid)
        self._bufs[sid] = None
        self._fed[sid] = False

    @torch.inference_mode()
    def _reset_slot(self, sid: int):
        # in place: one row of each accumulator back to the empty state
        for st in self.states:
            st.num[sid] = 0.0
            st.den[sid] = 0.0
            st.m[sid] = -torch.inf
        self._fed[sid] = False

    def _check(self, sid: int):
        if not 0 <= sid < self.S or self._bufs[sid] is None:
            raise KeyError(f"stream {sid} is not open")

    # --- data path ---
    def _coerce(self, samples: np.ndarray) -> np.ndarray:
        """float32 [-1, 1], PCM16 or uint8 mu-law in -> the wire dtype."""
        samples = np.asarray(samples)
        if samples.dtype == self._buf_dtype:
            return samples
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / 32768.0
        elif samples.dtype == np.uint8:
            samples = mulaw_decode(samples)
        if self._buf_dtype == np.int16:
            return pcm16_quantize(samples)
        if self._buf_dtype == np.uint8:
            return mulaw_encode(samples)
        return np.asarray(samples, np.float32)

    def feed(self, sid: int, samples: np.ndarray):
        """Append audio to a stream (float32, int16 or uint8 mu-law)."""
        self._check(sid)
        self._bufs[sid] = np.concatenate([self._bufs[sid], self._coerce(samples)])

    def pending(self, sid: int) -> int:
        """Buffered audio in samples."""
        self._check(sid)
        return len(self._bufs[sid])

    def _blank_tile(self) -> np.ndarray:
        """[S, chunk_samples] of silence in the wire dtype."""
        return np.full((self.S, self.chunk_samples), self._pad_value, self._buf_dtype)

    def chunks_ready(self, sid: int) -> int:
        """How many tick()s the stream's buffer can supply now (0 if closed)."""
        b = self._bufs[sid] if 0 <= sid < self.S else None
        if b is None or len(b) < self.chunk_samples:
            return 0
        return (len(b) - self.chunk_samples) // self.hop_samples + 1

    def gather_ready(self):
        """Slice one chunk from every ready stream and advance those
        buffers. Returns (wav, active) or None."""
        cw, hw = self.chunk_samples, self.hop_samples
        active = np.array([b is not None and len(b) >= cw for b in self._bufs])
        if not active.any():
            return None
        wav = self._blank_tile()
        for sid in np.flatnonzero(active):
            wav[sid] = self._bufs[sid][:cw]
            self._bufs[sid] = self._bufs[sid][hw:]
        return wav, active

    def tick(self) -> int:
        """Process one chunk for every stream that has one ready; returns the
        number of streams advanced (0 = nothing ready, no device step)."""
        g = self.gather_ready()
        if g is None:
            return 0
        wav, active = g
        self._dispatch(wav, active, np.full(self.S, self.chunk_patches, np.int32))
        self._fed |= active
        return int(active.sum())

    def drain(self) -> int:
        """tick() until no stream has a full chunk; returns total advanced."""
        total = 0
        while True:
            n = self.tick()
            if n == 0:
                return total
            total += n

    def flush(self, sid: int) -> bool:
        """Fold a stream's sub-chunk tail into its state: remaining whole
        patches are processed (the sub-patch remainder is dropped), and only
        a stream too short for one patch is zero-padded to one. Returns True
        if a device step was run."""
        self._check(sid)
        cw = self.chunk_samples
        while len(self._bufs[sid]) >= cw:  # never discard what a tick would fold
            self.tick()
        buf = self._bufs[sid]
        if len(buf) == 0:
            return False
        n_valid_sid = _whole_patches(self.cfg.frontend, len(buf))
        if n_valid_sid < 1:
            if self._fed[sid]:
                self._bufs[sid] = np.zeros(0, self._buf_dtype)
                return False
            n_valid_sid = 1  # lone sub-patch stream: zero-pad to one patch
        n_valid_sid = min(n_valid_sid, self.chunk_patches)
        wav = self._blank_tile()
        wav[sid, : min(len(buf), cw)] = buf[:cw]
        active = np.zeros(self.S, bool)
        active[sid] = True
        self._dispatch(wav, active, np.full(self.S, n_valid_sid, np.int32))
        self._fed[sid] = True
        self._bufs[sid] = np.zeros(0, self._buf_dtype)
        return True

    @torch.inference_mode()
    def _finalize(self) -> torch.Tensor:
        return stream_finalize_scores(self.model, self.cfg.model.variant, self.states)

    def scores(self, sid: int) -> np.ndarray:
        self._check(sid)
        if not self._fed[sid]:
            raise RuntimeError(f"stream {sid} has no processed audio yet")
        return self._finalize()[sid].float().cpu().numpy()
