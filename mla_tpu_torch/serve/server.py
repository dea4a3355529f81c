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

On the adpcm4 / adpcm2 wires the buffers hold wire bytes in whole 64-sample
block units (``data/adpcm.py``): a pre-encoded feed is routed as it is, a
sample feed is encoded at feed time with a per-stream sub-block remainder,
and the tick decodes on the device (``ops/adpcm.py``, a CUDA kernel).

The packed tick (``tick_packed``; ``packed_buffer`` / ``gather_ready_packed``
/ ``put_packed`` / ``_packed_step`` for a front that drives it) makes a
regular tick one upload of a flat uint8 buffer, [S * row wire bytes][S
active bytes], unpacked on the device. The server keeps a few staging
buffers of that layout and knows which of their rows already hold wire
silence, so a gather rewrites only the rows that changed since the
buffer's last use, not every row of S. ``timeline_cap`` keeps a per-stream
localization ring on the device, written inside the step. Weights reload
with ``prepare_reload`` / ``commit_reload`` while streams stay open. The
device steps are functional: ``states, tl = step(states, tl, ...)`` returns
new tensors, so a (states, tl) pair a reader holds is a snapshot.

With ``mesh`` (a single-process ``parallel.mesh.Mesh``) the stream axis
shards in contiguous blocks of S / n over ``mesh[mesh_axis]``: shard k holds
streams [k S/n, (k+1) S/n) on the first device of the axis' k-th row, with
its own states, ring and ``active`` / ``n_valid`` slices, and a model
replica shared by the shards on one device. Streams are independent, so
the shards never communicate. ``states``, ``tl`` and ``model`` become lists
with one entry per shard; a packed buffer takes the [S, packed_row_bytes]
rows layout (each row its wire bytes and its active byte), whose shard
blocks go up in one copy each. Read a stream through ``scores_from`` /
``timeline_from``, which find its shard.

Weights already sharded over the mesh (a ``parallel.tensor.ShardedStateDict``
over this ``mesh``, from ``place_sharded``: tensor parallelism, the
reference's variables placed by ``param_shardings``) keep that layout, as
the reference keeps a placement on its mesh: each data row's replica is
tensor parallel over that row's devices, built from the row's own shards.
The front-end and the trunk run once per data row, on the row's first
device; only the sharded layers split over the row. A plain ``state_dict``
is replicated, one replica per distinct device, as without a model axis.
A reload keeps the layout the server was built with, whichever form the
new weights come in.
"""

from __future__ import annotations

import sys
from typing import List, Mapping, Optional

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.data import adpcm
from mla_tpu_torch.data.audio_io import mulaw_decode, mulaw_encode, pcm16_quantize
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.ops.adpcm import adpcm_decode
from mla_tpu_torch.parallel import tensor
from mla_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mla_tpu_torch.serve.streaming import (
    STREAMING_VARIANTS,
    _model_with_weights,
    _samples_per_patches,
    _whole_patches,
    n_stream_levels,
    stream_activations,
    stream_finalize_scores,
)


def _layout(state_dict: Mapping) -> dict:
    """{key: (whole shape, dtype)} of a ``state_dict`` or a
    ``ShardedStateDict``, batch norm's step counters aside."""
    shapes = (state_dict.shapes if isinstance(state_dict, tensor.ShardedStateDict)
              else {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()})
    return {k: (tuple(s), dt) for k, (s, dt) in shapes.items()
            if not k.endswith("num_batches_tracked")}


_WIRES = {"float32": np.float32, "int16": np.int16, "uint8": np.uint8,
          "adpcm4": np.uint8, "adpcm2": np.uint8}

STAGING_BUFFERS = 4  # staging buffers a server keeps; past them each is new


class _Staging:
    """A staging buffer the server hands out again. ``silent``: the wire
    rows that hold wire silence, as a gather left them (None: unknown, e.g.
    after a front's own writes); ``known``: the same, taken at its hand-out,
    for the gather that fills it; ``copies``: the events of its last
    upload, one per target device."""

    __slots__ = ("buf", "silent", "known", "copies")

    def __init__(self, buf: np.ndarray):
        self.buf, self.silent, self.known, self.copies = buf, None, None, []

    def free(self) -> bool:
        """Nothing but the server holds the buffer (the slot and the call's
        argument are the two references) and its upload has finished."""
        return sys.getrefcount(self.buf) == 2 and all(e.query() for e in self.copies)


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
                 mesh=None, mesh_axis: str = "data", timeline_cap: int = 0, device=None):
        """``transfer_dtype`` is the wire the buffers hold and the upload
        carries: "float32", "int16" (PCM16, dequantized on the device),
        "uint8" (8-bit mu-law, expanded on the device), "adpcm4" or "adpcm2"
        (4- or 2-bit block ADPCM, decoded on the device).

        ``timeline_cap`` > 0 keeps each stream's last timeline_cap patches'
        gate logits and segment probabilities per level on the device
        (``ops.attention_pool.TimelineState``, S * cap * levels * classes *
        8 bytes), written inside the step; ``timeline()`` reads it. 0 adds
        no op to the step.

        ``mesh`` shards the stream axis over ``mesh[mesh_axis]`` (see the
        module docstring); max_streams must divide by the axis size. The
        mesh's devices then replace ``device``. ``state_dict`` is a plain
        ``state_dict``, or a ``ShardedStateDict`` over ``mesh``: a
        tensor-parallel replica per data row (see the module docstring)."""
        if cfg.model.variant not in STREAMING_VARIANTS:
            raise ValueError(f"unknown streaming variant {cfg.model.variant!r}; "
                             f"pick from {STREAMING_VARIANTS}")
        if transfer_dtype not in _WIRES:
            raise ValueError(
                f"transfer_dtype must be float32|int16|uint8|adpcm4|adpcm2, got {transfer_dtype!r}")
        self._shards = None  # [(device, slice of streams)] on a mesh
        if mesh is not None:
            n = mesh.shape[mesh_axis]
            if max_streams % n:
                raise ValueError(
                    f"max_streams {max_streams} not divisible by mesh {mesh_axis}={n}")
            per = max_streams // n
            self._shards = [(torch.device(d), slice(k * per, (k + 1) * per))
                            for k, d in enumerate(mesh.axis_devices(mesh_axis))]
            device = self._shards[0][0]
        self._mesh, self._tp_rows = mesh, None
        if (isinstance(state_dict, tensor.ShardedStateDict) and state_dict.mesh is mesh
                and mesh is not None and mesh.shape[MODEL_AXIS] > 1):
            if mesh_axis != DATA_AXIS:
                raise ValueError("a tensor-parallel server shards its streams over 'data'")
            self._tp_rows = [list(row) for row in mesh.devices]
        if timeline_cap and timeline_cap < chunk_patches:
            # one chunk's ring slots must be distinct (masked scatter)
            raise ValueError(f"timeline_cap {timeline_cap} must be >= chunk_patches "
                             f"{chunk_patches}")
        self.device = resolve_device(device)
        self.transfer_dtype = transfer_dtype
        self._buf_dtype = _WIRES[transfer_dtype]
        # silence in wire units: mu-law code 0 is full-scale -1.0, 128 is 0.0
        self._pad_value = 128 if self._buf_dtype == np.uint8 else 0
        self.cfg = cfg
        self._layout = _layout(state_dict)
        self.model = self._replicas(state_dict)
        self.S = max_streams
        self.chunk_patches = chunk_patches
        self.chunk_samples = _samples_per_patches(cfg.frontend, chunk_patches)
        self.hop_samples = (
            cfg.frontend.example_hop_frames * cfg.frontend.hop_length * chunk_patches
        )
        self._adpcm = None
        if transfer_dtype in ("adpcm4", "adpcm2"):
            bits, blk = int(transfer_dtype[-1]), adpcm.SERVE_BLOCK
            if self.chunk_samples % blk or self.hop_samples % blk:
                raise ValueError(
                    f"{transfer_dtype} needs chunk/hop sample counts divisible by {blk} "
                    f"(chunk={self.chunk_samples}, hop={self.hop_samples}); use "
                    "transfer_dtype='int16' for this front-end geometry")
            wb = adpcm.wire_block_bytes(blk, bits)
            enc = adpcm.adpcm4_encode if bits == 4 else adpcm.adpcm2_encode
            self._adpcm = {
                "block": blk, "wb": wb, "bits": bits, "encode": enc,
                "chunk_wire": self.chunk_samples // blk * wb,
                "hop_wire": self.hop_samples // blk * wb,
                # 4-bit: a silence block decodes to exact zeros (7 >> 3 == 0);
                # 2-bit: to +-3 LSB (7 >> 1 == 3), fed only to masked rows
                "silence": enc(np.zeros(blk, np.int16), block=blk),
            }
            self._rem: List[np.ndarray] = [np.zeros(0, np.int16) for _ in range(self.S)]
        self._acts = stream_activations(cfg.model)
        self._bufs: List[Optional[np.ndarray]] = [None] * self.S
        self._fed = np.zeros(self.S, bool)
        self.dispatches = 0  # device steps run (ticks and flushes)
        self.patch_rows = 0  # patch rows the device steps computed, ready or not
        n_levels, c = n_stream_levels(cfg.model), cfg.model.n_classes
        self.timeline_cap = int(timeline_cap)

        def fresh(rows, dev):  # (states, tl) of ``rows`` streams on ``dev``
            return ([ap.init_stream_state((rows, c), device=dev) for _ in range(n_levels)],
                    ap.init_timeline_state(rows, self.timeline_cap, n_levels, c, device=dev)
                    if self.timeline_cap else None)

        if self._shards is None:
            self.states, self.tl = fresh(self.S, self.device)
        else:
            parts = [fresh(sl.stop - sl.start, d) for d, sl in self._shards]
            self.states, self.tl = [p[0] for p in parts], [p[1] for p in parts]
        # the packed layout: [S * row_wire_bytes wire][S active bytes]
        units, _ = self._chunk_hop_units()
        self._itemsize = np.dtype(self._buf_dtype).itemsize
        row_wire_bytes = units * self._itemsize
        self._wav_bytes = self.S * row_wire_bytes
        self.packed_row_bytes = row_wire_bytes + 1
        self.packed_nbytes = self._wav_bytes + self.S
        # one row of wire silence as bytes, for the inactive rows of a packed buffer
        self._blank_row_u8 = np.ascontiguousarray(self._blank_tile()[0]).view(np.uint8)
        self._staging: List[_Staging] = []
        # the packed tick's n_valid, made once: its one upload is the buffer
        self._n_valid_chunk = (
            torch.full((self.S,), chunk_patches, dtype=torch.int32, device=self.device)
            if self._shards is None else
            [torch.full((sl.stop - sl.start,), chunk_patches, dtype=torch.int32, device=d)
             for d, sl in self._shards])

    def _replicas(self, state_dict: Mapping):
        """The model on the server's device; on a mesh a list with one
        entry per shard: one replica per distinct device, or, tensor
        parallel, one per data row over the row's devices."""
        if self._tp_rows is not None:
            return [self._tp_replica(state_dict, d) for d in range(len(self._tp_rows))]
        if isinstance(state_dict, tensor.ShardedStateDict):
            state_dict = state_dict.full()
        if self._shards is None:
            return _model_with_weights(self.cfg, state_dict, self.device)
        by_device = {d: _model_with_weights(self.cfg, state_dict, d)
                     for d in dict.fromkeys(d for d, _ in self._shards)}
        return [by_device[d] for d, _ in self._shards]

    def _tp_replica(self, state_dict: Mapping, d: int):
        """Data row ``d``'s replica, tensor parallel over the row's devices
        and loaded with the row's shards (whole weights are sharded over
        the mesh first)."""
        if not (isinstance(state_dict, tensor.ShardedStateDict) and state_dict.mesh is self._mesh):
            state_dict = tensor.place_sharded(
                state_dict.full() if isinstance(state_dict, tensor.ShardedStateDict)
                else state_dict, self._mesh, self.cfg.model.hidden_units)
        row = self._tp_rows[d]
        model = build_model(self.cfg.model, device="cpu").to(row[0]).eval()
        tensor.tensor_parallel(model, tensor.ModelAxis(devices=row), state_dict.hidden_units)
        tensor.load_shards(model, state_dict.row(d))
        return model

    def _locate(self, sid: int):
        """(shard index, row in the shard) of a stream; (None, sid) unsharded."""
        if self._shards is None:
            return None, sid
        per = self._shards[0][1].stop
        return sid // per, sid % per

    @torch.inference_mode()
    def _step(self, states, tl, wav: torch.Tensor, active: torch.Tensor,
              n_valid: torch.Tensor, model=None):
        """One device step from (states, tl) to new (states, tl). wav [S,
        chunk_samples] in the wire dtype; active [S] bool - fold only these
        rows; n_valid [S] int - real patches per row (a flush pads the tail;
        padded patches get gate logits of -inf, which every gate activation
        maps to 0, and keep their ring slots). On the adpcm wires wav is [S,
        chunk_wire] uint8 wire bytes. ``model`` (default the server's) runs
        the step; on a mesh each shard's rows go through this with the
        shard's replica."""
        model = self.model if model is None else model
        if self._adpcm is not None:
            wav = adpcm_decode(wav, self.chunk_samples, self._adpcm["block"],
                               self._adpcm["bits"])
        elif wav.dtype == torch.int16:
            wav = wav.to(torch.float32) / 32768.0
        elif wav.dtype == torch.uint8:
            wav = mulaw_decode(wav)
        patches = fe.apply_frontend(wav, self.cfg.frontend)  # [S, P, 96, 64]
        levels = model.segment_logits(patches)
        p = patches.shape[1]
        self.patch_rows += patches.shape[0] * p
        tmask = torch.arange(p, device=patches.device)[None, :] < n_valid[:, None]  # [S, P]
        mask = active[:, None]
        new_states = []
        for st, (g, c) in zip(states, levels):
            g = torch.where(tmask[..., None], g, -torch.inf)
            upd = ap.update_stream_state(st, g, c, *self._acts)
            new_states.append(ap.StreamState(*(torch.where(mask, u, o)
                                               for u, o in zip(upd, st))))
        if tl is not None:
            # the ring takes the raw gate logits; padded patches keep their slots
            g_stack = torch.stack([g for g, _ in levels], dim=2)
            f_stack = torch.stack([ap.cla_activation(c, self._acts[1]) for _, c in levels],
                                  dim=2)
            tl = ap.update_timeline_state(tl, g_stack, f_stack, active, n_valid)
        return new_states, tl

    def _wire(self, raw: torch.Tensor) -> torch.Tensor:
        """[rows, row_wire_bytes] uint8 -> [rows, units] in the wire dtype: a
        multi-byte wire is reinterpreted little-endian, as numpy wrote it. A
        block of the rows layout is strided: it is copied, contiguous."""
        if self._itemsize == 1:
            return raw.contiguous()
        dt = torch.int16 if self._itemsize == 2 else torch.float32
        return raw.reshape(-1).view(dt).reshape(raw.shape[0], -1)

    def _packed_step(self, states, tl, packed):
        """The regular tick's step from one packed buffer on the device
        (``put_packed``'s result): states, tl -> new states, tl. A caller
        that drives it stores the result and marks the active streams fed,
        as ``tick_packed`` does. On a mesh ``packed`` and the results are
        lists with one entry per shard."""
        if self._shards is None:
            wav = self._wire(packed[: self._wav_bytes].view(self.S, -1))
            active = packed[self._wav_bytes:] != 0
            return self._step(states, tl, wav, active, self._n_valid_chunk)
        out = [self._step(states[k], tl[k], self._wire(rows[:, :-1]), rows[:, -1] != 0,
                          self._n_valid_chunk[k], self.model[k])
               for k, rows in enumerate(packed)]
        return [o[0] for o in out], [o[1] for o in out]

    def _dispatch(self, wav: np.ndarray, active: np.ndarray, n_valid: np.ndarray):
        if self._shards is None:
            put = [torch.from_numpy(a).to(self.device, non_blocking=True)
                   for a in (wav, active, n_valid)]
            self.states, self.tl = self._step(self.states, self.tl, *put)
        else:
            out = []
            for k, (dev, sl) in enumerate(self._shards):
                put = [torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev, non_blocking=True)
                       for a in (wav, active, n_valid)]
                out.append(self._step(self.states[k], self.tl[k], *put, model=self.model[k]))
            self.states, self.tl = [o[0] for o in out], [o[1] for o in out]
        self.dispatches += 1

    def warmup(self, packed: bool = False):
        """Run one all-inactive tick and a finalize before serving: builds
        the front-end kernel and warms the library kernels, and leaves every
        stream state unchanged. ``packed=True`` also runs one all-inactive
        packed tick."""
        blank = self._blank_tile()
        self._dispatch(blank, np.zeros(self.S, bool),
                       np.full(self.S, self.chunk_patches, np.int32))
        if packed:
            buf = self.packed_buffer()
            rows, act_bytes = self._packed_views(buf)
            rows[:] = np.ascontiguousarray(blank).view(np.uint8).reshape(rows.shape)
            act_bytes[:] = 0
            self.states, self.tl = self._packed_step(self.states, self.tl,
                                                     self.put_packed(buf))
        for _, sl in self._shards or [(self.device, slice(0, self.S))]:
            self.scores_from(self.model, self.states, sl.start)  # one finalize per shard
        for dev in dict.fromkeys(d for d, _ in self._shards or [(self.device, None)]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

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
        if self._adpcm is not None:
            self._rem[sid] = np.zeros(0, np.int16)

        k, row = self._locate(sid)

        def reset(t, value):  # a new tensor: snapshots of the old stay intact
            t = t.clone()
            t[row] = value
            return t

        def reset_all(states, tl):
            states = [ap.StreamState(reset(st.num, 0.0), reset(st.den, 0.0),
                                     reset(st.m, -torch.inf)) for st in states]
            if tl is not None:
                # count 0 hides the slot's old ring rows; new writes start at
                # cursor 0 and replace them before they become readable
                tl = tl._replace(cursor=reset(tl.cursor, 0), count=reset(tl.count, 0))
            return states, tl

        if k is None:
            self.states, self.tl = reset_all(self.states, self.tl)
        else:
            states, tl = list(self.states), list(self.tl)
            states[k], tl[k] = reset_all(states[k], tl[k])
            self.states, self.tl = states, tl
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

    def _coerce_adpcm(self, sid: int, samples: np.ndarray,
                      wire: Optional[bool]) -> np.ndarray:
        """adpcm servers buffer wire bytes. uint8 input (or wire=True) is
        pre-encoded wire, in whole block units; float32 / int16 is encoded
        here, keeping the sub-block remainder per stream."""
        a = self._adpcm
        samples = np.asarray(samples)
        if wire or (wire is None and samples.dtype == np.uint8):
            if samples.dtype != np.uint8 or len(samples) % a["wb"]:
                raise ValueError(f"{self.transfer_dtype} wire feed must be uint8 in whole "
                                 f"{a['wb']}-byte block units")
            if len(self._rem[sid]):
                # wire blocks appended now would land before the remainder's audio
                raise ValueError(
                    f"stream {sid} holds {len(self._rem[sid])} not-yet-encoded samples "
                    f"from a float/int16 feed; pad sample feeds to whole {a['block']}-sample "
                    "blocks before switching to pre-encoded wire")
            return samples
        if samples.dtype == np.uint8:  # wire=False: mu-law codes, expanded first
            samples = mulaw_decode(samples)
        buf = np.concatenate([self._rem[sid], pcm16_quantize(samples)])
        nb = len(buf) // a["block"]
        self._rem[sid] = buf[nb * a["block"]:]
        if nb == 0:
            return np.zeros(0, np.uint8)
        return a["encode"](buf[: nb * a["block"]], block=a["block"])

    def feed(self, sid: int, samples: np.ndarray, wire: Optional[bool] = None):
        """Append audio to a stream (float32, int16 or uint8 mu-law). On the
        adpcm wires ``wire`` says what uint8 input is: True (or None) marks
        pre-encoded wire bytes, False mu-law samples; other wires ignore it."""
        self._check(sid)
        new = (self._coerce_adpcm(sid, samples, wire) if self._adpcm is not None
               else self._coerce(samples))
        self._bufs[sid] = np.concatenate([self._bufs[sid], new])

    def pending(self, sid: int) -> int:
        """Buffered audio in samples (on the adpcm wires: the samples the
        buffered wire blocks and the remainder stand for)."""
        self._check(sid)
        if self._adpcm is not None:
            a = self._adpcm
            return len(self._bufs[sid]) // a["wb"] * a["block"] + len(self._rem[sid])
        return len(self._bufs[sid])

    def _chunk_hop_units(self):
        """(chunk, hop) in buffer units: samples, or wire bytes on the adpcm
        wires (whole blocks, which decode alike when a chunk re-reads them)."""
        if self._adpcm is not None:
            return self._adpcm["chunk_wire"], self._adpcm["hop_wire"]
        return self.chunk_samples, self.hop_samples

    def _blank_tile(self) -> np.ndarray:
        """[S, chunk units] of silence in the wire format."""
        if self._adpcm is not None:
            a = self._adpcm
            return np.tile(a["silence"], (self.S, a["chunk_wire"] // a["wb"]))
        return np.full((self.S, self.chunk_samples), self._pad_value, self._buf_dtype)

    def chunks_ready(self, sid: int) -> int:
        """How many tick()s the stream's buffer can supply now (0 if closed)."""
        b = self._bufs[sid] if 0 <= sid < self.S else None
        cw, hw = self._chunk_hop_units()
        if b is None or len(b) < cw:
            return 0
        return (len(b) - cw) // hw + 1

    def gather_ready(self):
        """Slice one chunk from every ready stream and advance those
        buffers. Returns (wav, active) or None."""
        cw, hw = self._chunk_hop_units()
        active = np.array([b is not None and len(b) >= cw for b in self._bufs])
        if not active.any():
            return None
        wav = self._blank_tile()
        for sid in np.flatnonzero(active):
            wav[sid] = self._bufs[sid][:cw]
            self._bufs[sid] = self._bufs[sid][hw:]
        return wav, active

    def packed_buffer(self) -> np.ndarray:
        """A staging buffer in the one-upload layout, flat [packed_nbytes]
        uint8. On a CUDA device it is a numpy view of pinned memory, which
        ``put_packed`` copies asynchronously; on the CPU it is plain memory.
        Pass the buffer to ``put_packed`` as returned, once it is filled.
        The server keeps up to ``STAGING_BUFFERS`` of them and hands one out
        again only once nothing else holds it and its upload has finished,
        so no buffer in use or in flight is written. On a mesh the buffer
        is [S, packed_row_bytes], the rows layout. One thread at a time."""
        for st in self._staging:
            if st.free():
                st.known, st.silent = st.silent, None
                return st.buf
        shape = ((self.packed_nbytes,) if self._shards is None
                 else (self.S, self.packed_row_bytes))
        if self.device.type == "cuda":
            buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
        else:
            buf = np.empty(shape, np.uint8)
        if len(self._staging) < STAGING_BUFFERS:
            self._staging.append(_Staging(buf))
        return buf

    def _staged(self, buf: np.ndarray) -> Optional[_Staging]:
        return next((st for st in self._staging if st.buf is buf), None)

    def put_packed(self, buf: np.ndarray):
        """The one host-to-device copy of a buffer from ``packed_buffer``
        (on the CPU, no copy); on a mesh one copy per shard of its block of
        rows (on the CPU too: a block's wire must start aligned), a list."""
        if self.device.type != "cuda":
            t = torch.from_numpy(buf)
        else:
            t = buf.base
            if not (isinstance(t, torch.Tensor) and t.is_pinned()
                    and t.data_ptr() == buf.ctypes.data and buf.size == self.packed_nbytes):
                raise ValueError("put_packed takes a buffer from packed_buffer(), as returned")
        if self._shards is None:
            out = t.to(self.device, non_blocking=True)
        elif self.device.type != "cuda":
            return [t[sl].clone() for _, sl in self._shards]
        else:
            out = [t[sl].to(d, non_blocking=True) for d, sl in self._shards]
        st = self._staged(buf) if self.device.type == "cuda" else None
        if st is not None:  # the buffer is free again once these copies have finished
            st.copies = []
            for d in dict.fromkeys([self.device] if self._shards is None
                                   else [d for d, _ in self._shards]):
                st.copies.append(torch.cuda.Event())
                st.copies[-1].record(torch.cuda.current_stream(d))
        return out

    def _packed_views(self, out: np.ndarray):
        """(wire_rows [S, row_wire_bytes], active_bytes [S]) views into a
        packed buffer of either layout."""
        if out.ndim == 2:
            return out[:, :-1], out[:, -1]
        return out[: self._wav_bytes].reshape(self.S, -1), out[self._wav_bytes:]

    def gather_ready_packed(self, out: np.ndarray):
        """``gather_ready`` writing straight into the one-upload layout: fills
        ``out`` with every row's wire chunk bytes (wire silence for the
        inactive rows) and the active bytes, and advances the ready buffers.
        Returns the active bool vector, or None if no stream has a full
        chunk. A buffer from ``packed_buffer`` is uploaded as this leaves
        it; the rows it already held as silence are not written again."""
        cw, hw = self._chunk_hop_units()
        active = np.array([b is not None and len(b) >= cw for b in self._bufs])
        if not active.any():
            return None
        st = self._staged(out)
        known = st.known if st is not None else None  # rows already wire silence
        rows, act_bytes = self._packed_views(out)
        for sid in range(self.S):
            if active[sid]:
                rows[sid] = np.ascontiguousarray(self._bufs[sid][:cw]).view(np.uint8)
                self._bufs[sid] = self._bufs[sid][hw:]
            elif known is None or not known[sid]:
                rows[sid] = self._blank_row_u8
        act_bytes[:] = active
        if st is not None:
            st.known = st.silent = ~active
        return active

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

    def tick_packed(self) -> int:
        """``tick()`` through the one-upload layout: gather into a packed
        buffer, one host-to-device copy, the packed step."""
        buf = self.packed_buffer()
        active = self.gather_ready_packed(buf)
        if active is None:
            return 0
        self.states, self.tl = self._packed_step(self.states, self.tl, self.put_packed(buf))
        self.dispatches += 1
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
        cw, _ = self._chunk_hop_units()
        while len(self._bufs[sid]) >= cw:  # never discard what a tick would fold
            self.tick()
        buf = self._bufs[sid]
        n_buffered = self.pending(sid)
        if self._adpcm is not None and len(self._rem[sid]):
            # the remainder becomes one last wire block, edge-padded by the
            # encoder; the pad lands only in patches n_valid masks out
            buf = np.concatenate([buf, self._adpcm["encode"](self._rem[sid],
                                                             block=self._adpcm["block"])])
            self._rem[sid] = np.zeros(0, np.int16)
        if n_buffered == 0:
            return False
        n_valid_sid = _whole_patches(self.cfg.frontend, n_buffered)
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
    def _finalize(self, model, states) -> torch.Tensor:
        return stream_finalize_scores(model, self.cfg.model.variant, states)

    def scores(self, sid: int) -> np.ndarray:
        self._check(sid)
        if not self._fed[sid]:
            raise RuntimeError(f"stream {sid} has no processed audio yet")
        return self.scores_from(self.model, self.states, sid)

    def scores_from(self, model, states, sid: int) -> np.ndarray:
        """One stream's scores from a snapshot of (model, states), on the
        host."""
        k, row = self._locate(sid)
        if k is not None:
            model, states = model[k], states[k]
        return self._finalize(model, states)[row].float().cpu().numpy()

    # --- weight reload ---
    def prepare_reload(self, state_dict: Mapping):
        """Stage new weights for a swap: check keys, shapes and dtypes
        against the serving weights' (``ValueError`` on any mismatch; a
        different architecture needs a new server), then build a second
        model with them on the device, in the server's layout. Returns the
        staged model for :meth:`commit_reload`."""
        if _layout(state_dict) != self._layout:
            raise ValueError("reload_weights: the new state_dict does not match the serving "
                             "model (keys, shapes or dtypes); start a new server for a "
                             "different architecture")
        return self._replicas(state_dict)

    def commit_reload(self, staged) -> None:
        """Serve with a model staged by :meth:`prepare_reload`: one attribute
        store (on a mesh every replica at once). Open streams keep their
        accumulators and their ring; chunks folded after it use the new
        weights."""
        self.model = staged

    def reload_weights(self, state_dict: Mapping) -> None:
        """Swap the serving weights while streams stay open."""
        self.commit_reload(self.prepare_reload(state_dict))

    # --- timeline readout ---
    def timeline(self, sid: int):
        """A stream's localization window: the ring's last min(count,
        timeline_cap) patches' (attention weight, segment prob) per level,
        weights normalized against the stream's current accumulators
        (``ops.attention_pool.window_timeline``). Returns ``(start_patch,
        [(weights [T, C], probs [T, C]) per level])``."""
        self._check(sid)
        if not self._fed[sid]:
            raise RuntimeError(f"stream {sid} has no processed audio yet")
        return self.timeline_from(self.states, self.tl, sid)

    def timeline_from(self, states, tl, sid: int):
        """The readout of ``timeline`` from a snapshot of (states, tl)."""
        k, row = self._locate(sid)
        if k is not None:
            states, tl = states[k], tl[k]
        return ap.read_timeline(states, tl, row, self._acts[0])

    @torch.inference_mode()
    def timeline_with_scores_from(self, model, states, tl, sid: int):
        """``(scores, start_patch, levels)`` from a snapshot of (model,
        states, tl), ``model`` being the server's ``model`` when the
        snapshot was taken: the scores ride the timeline's one
        device-to-host copy."""
        k, row = self._locate(sid)
        if k is not None:
            model, states, tl = model[k], states[k], tl[k]
        scores = self._finalize(model, states)[row]
        start, levels, scores = ap.read_timeline(states, tl, row, self._acts[0], extra=scores)
        return scores, start, levels
