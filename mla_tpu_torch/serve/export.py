"""Model export (counterpart of ``mla_tpu/serve/export.py``): the waveform ->
clip-probs program, with the weights in it, as one self-contained artifact
that runs without the model code.

    meta = export_forward(cfg, state_dict, "model.mlxt", batch=8, seconds=10)
    fn = load_exported("model.mlxt")
    probs = fn(wav_batch)          # [batch, n_classes]

Each program is ``torch.export.export`` of the forward at static shapes
(batch x seconds, or streams x chunk), saved with ``torch.export.save``.
The container is the reference's: a magic line, a length-prefixed JSON
header, then the payloads. The header keeps the reference's keys; its
``format`` is ``mla_tpu_torch.export.v1`` (one-shot) or
``mla_tpu_torch.export.stream.v1`` (streaming), and ``platforms`` names the
device the program was exported on (``["cuda"]`` or ``["cpu"]``). The magic
line is this package's own (``MAGIC``), so the reference's loader refuses
these artifacts at its magic check; this package's loader refuses the
reference's (``JAX_MAGIC``, StableHLO payloads) by name.

A program's prologue decodes the wire it was exported for: int16 / 32768,
8-bit mu-law, or block ADPCM through the registered op
``torch.ops.mla_tpu_torch.adpcm_decode`` (``ops/adpcm.py``: on a card the
hand-written decode kernel). Then the torch-ops front-end
(``ops.frontend.waveform_to_patches``, whatever ``frontend.impl`` says, as
the reference's exporter does) and the model in eval mode, cast to float32;
a program exported on the card calls each CompactCNN block's batch norm +
ReLU as the registered op ``torch.ops.mla_tpu_torch.norm_act_apply``, and
with max pools a stage's last one, pool included, as ``norm_act_apply_pool``
(``ops/norm_act.py``: the fused kernels on a card, their plain versions on
the CPU).

The loaders take ``device=None`` (the card; raises without one unless
device="cpu") and move a program exported on another device with
``torch.export.passes.move_to_device_pass``. Loading imports this module
and what it imports (the op registration, the front-end and attention-pool
ops, the codecs), never the model code.
"""

from __future__ import annotations

import io
import json
import os
import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.data import adpcm as _ad
from mla_tpu_torch.data.audio_io import mulaw_decode
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.ops import norm_act  # noqa: F401 (registers the norm_act ops for loaders)
from mla_tpu_torch.ops.adpcm import adpcm_decode

MAGIC = b"MLXT1\n"
JAX_MAGIC = b"MLAX1\n"  # the reference package's artifacts
FORMAT = "mla_tpu_torch.export.v1"
STREAM_FORMAT = "mla_tpu_torch.export.stream.v1"

_INPUT_DTYPES = ("float32", "int16", "uint8", "adpcm4", "adpcm2")
_WIRE_TORCH = {"float32": torch.float32, "int16": torch.int16, "uint8": torch.uint8,
               "adpcm4": torch.uint8, "adpcm2": torch.uint8}
_WIRE_NUMPY = {"float32": np.float32, "int16": np.int16, "uint8": np.uint8,
               "adpcm4": np.uint8, "adpcm2": np.uint8}


def _wire_geometry(input_dtype: str, n_samples: int):
    """Validate input_dtype and return (adpcm_bits, wire_len): the wire
    geometry both exporters bake into their programs and headers."""
    if input_dtype not in _INPUT_DTYPES:
        raise ValueError(f"input_dtype must be {'|'.join(_INPUT_DTYPES)}, got {input_dtype!r}")
    adpcm_bits = int(input_dtype[-1]) if input_dtype.startswith("adpcm") else None
    wire_len = None
    if adpcm_bits is not None:
        if n_samples % _ad.SERVE_BLOCK:
            raise ValueError(f"{input_dtype} export needs sample counts divisible by "
                             f"{_ad.SERVE_BLOCK}, got {n_samples}")
        wire_len = _ad.wire_length(n_samples, _ad.SERVE_BLOCK, bits=adpcm_bits)
    return adpcm_bits, wire_len


def _wire_decode(wav: torch.Tensor, adpcm_bits: Optional[int], n_samples: int) -> torch.Tensor:
    """The wire -> float32 samples prologue, the decode the live server runs
    in its step, shared by both exporters."""
    if adpcm_bits is not None:
        return adpcm_decode(wav, n_samples, _ad.SERVE_BLOCK, adpcm_bits)
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) / 32768.0
    if wav.dtype == torch.uint8:
        return mulaw_decode(wav)
    return wav


def _write_artifact(path: str, meta: Dict, *payloads: bytes):
    """MAGIC + length-prefixed JSON header + payloads (all but the last
    length-prefixed), the reference's layout."""
    header = json.dumps(meta).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for p in payloads[:-1]:
            f.write(len(p).to_bytes(8, "little"))
            f.write(p)
        f.write(payloads[-1])


def _program_bytes(module: torch.nn.Module, args) -> bytes:
    """``torch.export`` of ``module`` at ``args``' static shapes (traced in
    Python, not by TorchDynamo), saved with its weights."""
    buf = io.BytesIO()
    torch.export.save(torch.export.export(module, args, strict=False), buf)
    return buf.getvalue()


def _eval_model(cfg, state_dict: Mapping, device: torch.device):
    from mla_tpu_torch.serve.streaming import _model_with_weights

    return _model_with_weights(cfg, state_dict, device)


class _Forward(torch.nn.Module):
    """wire [batch, W] -> probs [batch, C] f32."""

    def __init__(self, model, fcfg, adpcm_bits, n_samples):
        super().__init__()
        self.model, self.fcfg = model, fcfg
        self.adpcm_bits, self.n_samples = adpcm_bits, n_samples

    def forward(self, wav):
        wav = _wire_decode(wav, self.adpcm_bits, self.n_samples)
        return self.model(fe.waveform_to_patches(wav, self.fcfg)).to(torch.float32)


def export_forward(cfg, state_dict: Mapping, path: str, batch: int = 8, seconds: float = 10.0,
                   input_dtype: str = "float32", device=None) -> Dict:
    """Export the one-shot forward (wire [batch, n] -> probs [batch, C]) with
    the weights of ``state_dict`` on ``device`` (None = the card) and write
    the artifact to ``path``; returns the header dict. ``input_dtype`` bakes
    the wire in: "int16" (PCM16), "uint8" (8-bit mu-law), "adpcm4" /
    "adpcm2" (block ADPCM wire bytes, ``data/adpcm.py``)."""
    dev = resolve_device(device)
    n_samples = int(round(seconds * cfg.frontend.sample_rate))
    adpcm_bits, wire_len = _wire_geometry(input_dtype, n_samples)
    module = _Forward(_eval_model(cfg, state_dict, dev), cfg.frontend, adpcm_bits,
                      n_samples).eval()
    example = torch.zeros((batch, wire_len or n_samples), dtype=_WIRE_TORCH[input_dtype],
                          device=dev)
    with torch.no_grad():
        payload = _program_bytes(module, (example,))
    meta = {
        "format": FORMAT,
        "batch": batch,
        "n_samples": n_samples,
        "sample_rate": cfg.frontend.sample_rate,
        "n_classes": cfg.model.n_classes,
        "variant": cfg.model.variant,
        "platforms": [dev.type],
        "input_dtype": input_dtype,
    }
    if wire_len:
        meta["wire_length"] = wire_len
    _write_artifact(path, meta, payload)
    return meta


class _Chunk(torch.nn.Module):
    """((levels, tl), wire [S, W], n_valid [S]) -> (levels, tl): one chunk
    folded into every stream's state under the patch mask, as the live
    server's step folds it (every row active)."""

    def __init__(self, model, fcfg, acts, adpcm_bits, chunk_samples):
        super().__init__()
        self.model, self.fcfg, self.acts = model, fcfg, acts
        self.adpcm_bits, self.chunk_samples = adpcm_bits, chunk_samples

    def forward(self, state, wav, n_valid):
        levels_in, tl = state
        wav = _wire_decode(wav, self.adpcm_bits, self.chunk_samples)
        patches = fe.waveform_to_patches(wav, self.fcfg)
        levels = self.model.segment_logits(patches)
        tmask = torch.arange(patches.shape[1], device=wav.device)[None, :] < n_valid[:, None]
        out = []
        for (num, den, m), (g, cl) in zip(levels_in, levels):
            g = torch.where(tmask[..., None], g, -torch.inf)
            st = ap.update_stream_state(ap.StreamState(num, den, m), g, cl, *self.acts)
            out.append((st.num, st.den, st.m))
        if tl is not None:
            g_stack = torch.stack([g for g, _ in levels], dim=2)
            f_stack = torch.stack([ap.cla_activation(cl, self.acts[1]) for _, cl in levels],
                                  dim=2)
            active = torch.ones(wav.shape[0], dtype=torch.bool, device=wav.device)
            tl = tuple(ap.update_timeline_state(ap.TimelineState(*tl), g_stack, f_stack, active,
                                                n_valid))
        return tuple(out), tl


class _Finalize(torch.nn.Module):
    """levels -> probs [S, C] f32 (the variant's streaming tail)."""

    def __init__(self, model, variant):
        super().__init__()
        self.model, self.variant = model, variant

    def forward(self, levels):
        from mla_tpu_torch.serve.streaming import stream_finalize_scores

        states = [ap.StreamState(*t) for t in levels]
        return stream_finalize_scores(self.model, self.variant, states).to(torch.float32)


def _initial_state(streams: int, n_classes: int, n_levels: int, timeline_cap: int,
                   device) -> tuple:
    """Fresh ``(levels, tl)`` as plain tuples: per level (num 0, den 0, m
    -inf) [S, C] f32; the ring (g, f [S, cap, L, C] f32, cursor, count [S]
    int32) or None."""
    levels = tuple(tuple(ap.init_stream_state((streams, n_classes), device=device))
                   for _ in range(n_levels))
    tl = (tuple(ap.init_timeline_state(streams, timeline_cap, n_levels, n_classes,
                                       device=device)) if timeline_cap else None)
    return levels, tl


def export_streaming(cfg, state_dict: Mapping, path: str, streams: int = 1,
                     chunk_patches: int = 5, input_dtype: str = "float32",
                     timeline_cap: int = 0, device=None) -> Dict:
    """Export the streaming tagger as a program pair: a chunk fold
    ``((levels, tl), wav [S, chunk], n_valid [S]) -> (levels, tl)`` and
    ``finalize(levels) -> probs [S, C]``, weights in both. States cross as
    nested tuples, one ``(num, den, m)`` per level, so the loader needs no
    state class; ``n_valid`` masks a padded final chunk as the live
    server's flush does. ``timeline_cap`` > 0 also folds the localization
    ring inside the chunk program (``StreamingArtifact.timeline`` reads it);
    0 passes ``tl=None`` through. ``input_dtype`` bakes the wire in, as in
    :func:`export_forward`."""
    from mla_tpu_torch.serve.streaming import (
        STREAMING_VARIANTS,
        _samples_per_patches,
        n_stream_levels,
        stream_activations,
    )

    if cfg.model.variant not in STREAMING_VARIANTS:
        raise ValueError(f"unknown streaming variant {cfg.model.variant!r}; "
                         f"pick from {STREAMING_VARIANTS}")
    if timeline_cap and timeline_cap < chunk_patches:
        raise ValueError(f"timeline_cap {timeline_cap} must be >= chunk_patches "
                         f"{chunk_patches}")
    dev = resolve_device(device)
    model = _eval_model(cfg, state_dict, dev)
    n_levels = n_stream_levels(cfg.model)
    acts = stream_activations(cfg.model)
    chunk_samples = _samples_per_patches(cfg.frontend, chunk_patches)
    c = cfg.model.n_classes
    adpcm_bits, wire_len = _wire_geometry(input_dtype, chunk_samples)
    state = _initial_state(streams, c, n_levels, timeline_cap, dev)
    wav = torch.zeros((streams, wire_len or chunk_samples), dtype=_WIRE_TORCH[input_dtype],
                      device=dev)
    n_valid = torch.full((streams,), chunk_patches, dtype=torch.int32, device=dev)
    with torch.no_grad():
        p_chunk = _program_bytes(
            _Chunk(model, cfg.frontend, acts, adpcm_bits, chunk_samples).eval(),
            (state, wav, n_valid))
        p_fin = _program_bytes(_Finalize(model, cfg.model.variant).eval(), (state[0],))
    meta = {
        "format": STREAM_FORMAT,
        "streams": streams,
        "chunk_patches": chunk_patches,
        "chunk_samples": chunk_samples,
        "hop_samples": (cfg.frontend.example_hop_frames * cfg.frontend.hop_length
                        * chunk_patches),
        "sample_rate": cfg.frontend.sample_rate,
        "n_classes": c,
        "n_levels": n_levels,
        "variant": cfg.model.variant,
        "platforms": [dev.type],
        "input_dtype": input_dtype,
        "timeline_cap": timeline_cap,
        "att_activation": acts[0],
    }
    if wire_len:
        meta["wire_length"] = wire_len
    _write_artifact(path, meta, p_chunk, p_fin)
    return meta


def _read_artifact(path: str, want: str):
    """(meta, payloads) of one of this package's artifacts of format
    ``want``; raises on a file that is not an export, is the reference
    package's, or is of the other kind."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic not in (MAGIC, JAX_MAGIC):
            raise ValueError(f"{path} is not an mla_tpu_torch export (bad magic {magic!r})")
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        fmt = meta.get("format")
        if magic == JAX_MAGIC or fmt not in (FORMAT, STREAM_FORMAT):
            raise ValueError(
                f"{path} is a {fmt} artifact, not a PyTorch one ({FORMAT} / {STREAM_FORMAT}): "
                "the JAX package (mla_tpu.serve.export) loads its own StableHLO artifacts")
        if fmt != want:
            raise ValueError(f"{path} is a streaming artifact; use load_exported_streaming"
                             if fmt == STREAM_FORMAT else
                             f"{path} is a {fmt} artifact; use load_exported for one-shot "
                             "exports")
        payloads = []
        if fmt == STREAM_FORMAT:
            payloads.append(f.read(int.from_bytes(f.read(8), "little")))
        payloads.append(f.read())
    return meta, payloads


def _load_program(payload: bytes, meta: Dict, dev: torch.device):
    """The saved program as a callable module on ``dev``: a program exported
    on another device type is moved there by the export move pass."""
    with warnings.catch_warnings():  # torch's reader wraps the archive's bytes read-only
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        ep = torch.export.load(io.BytesIO(payload))
    if meta["platforms"] != [dev.type]:
        try:
            from torch.export.passes import move_to_device_pass
        except ImportError as e:
            raise RuntimeError(
                f"this artifact was exported on {meta['platforms']}, and moving it to {dev} "
                f"needs torch.export.passes.move_to_device_pass, which torch "
                f"{torch.__version__} does not have; export it on {dev.type}") from e
        ep = move_to_device_pass(ep, dev)
    return ep.module()


def _as_wire(wav, meta: Dict, rows_key: str, dev: torch.device) -> torch.Tensor:
    """The caller's wire as a tensor of the artifact's dtype on ``dev``,
    checked against the program's static shape."""
    idt = meta.get("input_dtype", "float32")
    if isinstance(wav, torch.Tensor):
        wav = wav.to(device=dev, dtype=_WIRE_TORCH[idt])
    else:
        wav = torch.from_numpy(np.ascontiguousarray(wav, _WIRE_NUMPY[idt])).to(dev)
    want = (meta[rows_key], meta.get("wire_length") or meta[
        "n_samples" if rows_key == "batch" else "chunk_samples"])
    if tuple(wav.shape) != want:
        raise ValueError(f"the exported program is static-shaped {want}, got "
                         f"{tuple(wav.shape)}")
    return wav.contiguous()


def load_exported(path: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Load a one-shot artifact on ``device`` (None = the card); returns
    ``fn(wav [batch, W]) -> probs [batch, C]`` (numpy) with ``fn.meta``
    holding the header."""
    dev = resolve_device(device)
    meta, (payload,) = _read_artifact(path, FORMAT)
    program = _load_program(payload, meta, dev)

    @torch.no_grad()
    def fn(wav) -> np.ndarray:
        return program(_as_wire(wav, meta, "batch", dev)).cpu().numpy()

    fn.meta = meta
    return fn


class StreamingArtifact:
    """A loaded streaming export: ``init_state() -> (levels, tl)``,
    ``chunk(state, wav, n_valid=None) -> state``, ``finalize(state) -> probs
    [S, C]`` (numpy), and the ring's ``timeline`` / ``events`` readouts. No
    model code.

    CHUNK OVERLAP CONTRACT: each chunk call consumes ``meta["chunk_samples"]``
    samples but the stream only advances by ``meta["hop_samples"]`` (less
    than chunk_samples by the STFT window's tail), so consecutive chunks
    overlap: slice ``wav[off : off + chunk_samples]`` and step ``off +=
    hop_samples``, as the live server's buffers do. Advancing by
    chunk_samples drops frame context at every boundary."""

    def __init__(self, meta: Dict, chunk_program, finalize_program, device: torch.device):
        self.meta = meta
        self.device = device
        self._chunk = chunk_program
        self._fin = finalize_program

    def init_state(self):
        m = self.meta
        return _initial_state(m["streams"], m["n_classes"], m["n_levels"],
                              m.get("timeline_cap", 0), self.device)

    @torch.no_grad()
    def chunk(self, state, wav, n_valid=None):
        """Fold one chunk [S, chunk_samples] (or [S, wire_length] wire bytes)
        into ``state``; ``n_valid`` [S] counts each row's real patches (None:
        every patch). The new state stays on the device."""
        wav = _as_wire(wav, self.meta, "streams", self.device)
        if n_valid is None:
            n_valid = torch.full((self.meta["streams"],), self.meta["chunk_patches"],
                                 dtype=torch.int32, device=self.device)
        elif isinstance(n_valid, torch.Tensor):
            n_valid = n_valid.to(device=self.device, dtype=torch.int32)
        else:
            n_valid = torch.from_numpy(np.asarray(n_valid, np.int32)).to(self.device)
        return self._chunk(state, wav, n_valid)

    @torch.no_grad()
    def finalize(self, state) -> np.ndarray:
        levels, _ = state
        return self._fin(levels).cpu().numpy()

    def timeline(self, state, sid: int = 0):
        """Stream ``sid``'s localization window (export with timeline_cap >
        0): ``(start_patch, [(weights [T, C], probs [T, C]) per level])``,
        the live server's readout."""
        levels, tl = state
        if tl is None:
            raise RuntimeError("timeline disabled; export with timeline_cap > 0")
        return ap.read_timeline([ap.StreamState(*t) for t in levels], ap.TimelineState(*tl), sid,
                                self.meta["att_activation"])

    def events(self, state, sid: int = 0, threshold=0.5, merge_gap_s: float = 0.0,
               min_dur_s: float = 0.0, class_names=None):
        """Discrete events from the ring's window: the live service's
        threshold / gap-merge / minimum-duration chain
        (``serve.events.detect_events``), timestamps on the stream's absolute
        patch grid."""
        from mla_tpu_torch.serve.events import detect_events

        start_patch, levels = self.timeline(state, sid)
        w = np.mean([wl for wl, _ in levels], axis=0)
        f = np.mean([fl for _, fl in levels], axis=0)
        hop_s = (self.meta["hop_samples"] / self.meta["chunk_patches"]) / self.meta["sample_rate"]
        return detect_events(f, w, hop_s=hop_s, start_patch=start_patch, threshold=threshold,
                             merge_gap_s=merge_gap_s, min_dur_s=min_dur_s,
                             class_names=class_names)


def load_exported_streaming(path: str, device=None) -> StreamingArtifact:
    """Load a streaming artifact on ``device`` (None = the card)."""
    dev = resolve_device(device)
    meta, (p_chunk, p_fin) = _read_artifact(path, STREAM_FORMAT)
    return StreamingArtifact(meta, _load_program(p_chunk, meta, dev),
                             _load_program(p_fin, meta, dev), dev)
