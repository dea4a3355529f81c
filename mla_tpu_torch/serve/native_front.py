"""Native-front HTTP tagging service (counterpart of
``mla_tpu/serve/native_front.py``): C++ sockets, parsing and stream buffers
(``native/serve_front.cpp``, compiled as it stands), Python only for device
steps and rare control requests.

The C++ front moves the per-request hot path (HTTP keep-alive parsing,
wire-format validation, per-stream byte buffering, backpressure, sync-fold
waits, the JSON reply) into C++ threads that never take the GIL, so request
handling overlaps the tick thread's step. The API is identical to
``serve/http.py`` (same routes, wire formats and status codes); TagClient
works against either.

Division of labour (the C++ header comment has the full protocol):
  - C++ fast path: POST /v1/streams/<sid>/audio whose Content-Type matches
    the server's wire format, and GET /v1/healthz.
  - Python tick thread: ONE blocking ctypes call (sf_wait_gather; ctypes
    releases the GIL) writes every ready stream's chunk and the active
    mask straight into a packed staging buffer from ``packed_buffer()``;
    one upload, the packed step, then sf_tick_done.
  - Python workers: sf_next_request / sf_respond for open, close, flush,
    scores, timeline, tag, reload, WAV bodies and mismatched wire formats
    (transcoded on the host exactly as the stdlib front does).

The C++ buffers are the single source of truth for pending stream audio;
``BatchedStreamingServer``'s own buffers are used only for a moment on the
flush path (the sub-chunk tail is handed back so ``srv.flush``'s masking
is reused as it is).

    srv = create_native_server(cfg, state_dict, port=0)
    srv.server_address, srv.serve_forever(), srv.shutdown(), srv.server_close()

The library builds at first use into ``build/mla_tpu_torch/`` with the
reference's g++ flags (``ops/_build.py::load_native``); a failed build
raises with g++'s output. ``create_native_server`` runs on the card unless
it is given ``device="cpu"``.
"""

from __future__ import annotations

import ctypes
import json
import re
import threading
from typing import Dict, Optional

import numpy as np

from mla_tpu_torch.config import Config
from mla_tpu_torch.data.adpcm import SERVE_BLOCK, wire_block_bytes
from mla_tpu_torch.data.audio_io import mulaw_decode
from mla_tpu_torch.data.labels import labels_for
from mla_tpu_torch.ops import _build
from mla_tpu_torch.serve.http import (
    _body_bits,
    _decode_audio,
    _host_adpcm_decode,
    _timeline_payload,
)
from mla_tpu_torch.serve.server import BatchedStreamingServer

_WIRE_FMT = {"float32": 0, "int16": 1, "uint8": 2, "adpcm4": 3, "adpcm2": 4}
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()

_SYNC_TIMEOUT_MS = 120_000  # matches SYNC_TIMEOUT_S in serve_front.cpp
_STREAM_RE = re.compile(r"^/v1/streams/(\d+)(?:/(audio|flush|scores|timeline))?$")


class _ReqView(ctypes.Structure):
    # mirrors sf_req_view in serve_front.cpp (field order/padding included)
    _fields_ = [
        ("id", ctypes.c_int64),
        ("method", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("x_samples", ctypes.c_int64),
        ("body_len", ctypes.c_int64),
        ("body", ctypes.POINTER(ctypes.c_uint8)),
        ("path", ctypes.c_char * 512),
        ("query", ctypes.c_char * 256),
        ("ctype", ctypes.c_char * 128),
    ]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sf_start.restype = ctypes.c_void_p
    lib.sf_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_long, u8p, ctypes.c_char_p,
    ]
    lib.sf_port.restype = ctypes.c_int
    lib.sf_port.argtypes = [ctypes.c_void_p]
    lib.sf_stop.argtypes = [ctypes.c_void_p]
    lib.sf_quiesced.restype = ctypes.c_int
    lib.sf_quiesced.argtypes = [ctypes.c_void_p]
    lib.sf_free.argtypes = [ctypes.c_void_p]
    lib.sf_stream_open.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sf_stream_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sf_set_rem.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sf_append.restype = ctypes.c_long
    lib.sf_append.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p, ctypes.c_long]
    lib.sf_chunks_ready.restype = ctypes.c_long
    lib.sf_chunks_ready.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sf_buffered.restype = ctypes.c_long
    lib.sf_buffered.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sf_take_all.restype = ctypes.c_long
    lib.sf_take_all.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p, ctypes.c_long]
    lib.sf_wait_gather.restype = ctypes.c_int
    lib.sf_wait_gather.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.c_int]
    lib.sf_tick_done.argtypes = [ctypes.c_void_p]
    lib.sf_counters.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.sf_wait_drained.restype = ctypes.c_int
    lib.sf_wait_drained.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sf_next_request.restype = ctypes.c_int
    lib.sf_next_request.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_ReqView), ctypes.c_int]
    lib.sf_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_long]
    return lib


def _lib() -> ctypes.CDLL:
    """The C++ front, built at first use (raises if g++ fails)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _declare(_build.load_native("serve_front"))
    return _LIB


class _TickStats:
    """The C++ front's tick gauges (one counter, incremented at gather time
    in sf_wait_gather under the C++ server's mutex; healthz reads the same
    numbers)."""

    def __init__(self, server: "NativeTagServer"):
        self._server = server

    def _read(self):
        t = ctypes.c_longlong()
        s = ctypes.c_longlong()
        h = self._server._h
        if h:
            self._server._lib.sf_counters(h, ctypes.byref(t), ctypes.byref(s))
        return t.value, s.value

    @property
    def ticks(self) -> int:
        return self._read()[0]

    @property
    def ticked_streams(self) -> int:
        return self._read()[1]


class _HTTPError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


class NativeTagServer:
    """The deployable endpoint with its request hot path in C++.

    Exposes the lifecycle surface of the stdlib front's
    ``ThreadingHTTPServer`` (``server_address``, ``serve_forever``,
    ``shutdown``, ``server_close``), so callers swap fronts with one flag.
    The HTTP API is ``serve/http.py``'s."""

    def __init__(self, cfg: Config, state_dict: Dict, port: int = 8000,
                 host: str = "127.0.0.1", max_streams: int = 8,
                 chunk_patches: int = 5, transfer_dtype: str = "int16",
                 mesh=None, batch_grace: float = 0.005, n_workers: int = 2,
                 max_body_bytes: int = 64 * 1024 * 1024,
                 timeline_cap: int = 0, reload_fn=None, device=None):
        lib = _lib()
        self._lib = lib
        self.cfg = cfg
        self.reload_fn = reload_fn
        self.srv = BatchedStreamingServer(
            cfg, state_dict, max_streams=max_streams, chunk_patches=chunk_patches,
            transfer_dtype=transfer_dtype, mesh=mesh, timeline_cap=timeline_cap,
            device=device)
        # build the kernels and warm the step BEFORE the C++ front accepts:
        # a cold first step could outlast its sync-feed wait (SYNC_TIMEOUT_S)
        self.srv.warmup(packed=True)
        self.labels = labels_for(cfg.data.dataset, cfg.model.n_classes)
        srv = self.srv
        self._itemsize = np.dtype(srv._buf_dtype).itemsize
        cw_units, hw_units = srv._chunk_hop_units()
        self._cw_units = cw_units
        chunk_bytes = cw_units * self._itemsize
        hop_bytes = hw_units * self._itemsize
        wb = srv._adpcm["wb"] if srv._adpcm is not None else 0
        blk = srv._adpcm["block"] if srv._adpcm is not None else 0
        blank = np.ascontiguousarray(srv._blank_tile()[0]).view(np.uint8)
        health = (f'"variant": {json.dumps(cfg.model.variant)}, '
                  f'"sample_rate": {cfg.frontend.sample_rate}, '
                  f'"transfer_dtype": {json.dumps(transfer_dtype)}')
        self._h = lib.sf_start(
            host.encode(), port, srv.S, _WIRE_FMT[transfer_dtype],
            chunk_bytes, hop_bytes, wb, blk, 8, max_body_bytes,
            int(batch_grace * 1e6),
            blank.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            health.encode())
        if not self._h:
            raise OSError(f"could not bind native front to {host}:{port}")
        self.server_address = (host, lib.sf_port(self._h))
        # dev guards the device state's read -> compute -> assign window
        # (TickLoop.dev's role); host_lock guards the Python-side slow-path
        # state (srv._bufs on the flush path, srv._rem adpcm remainders, _fed)
        self.dev = threading.Lock()
        self.host_lock = threading.Lock()
        self.ticker = _TickStats(self)
        self._closing = False
        self._done = threading.Event()
        self._threads = [
            threading.Thread(target=self._tick_loop, name="mla-native-tick", daemon=True)
        ] + [
            threading.Thread(target=self._worker_loop, name=f"mla-native-worker-{i}",
                             daemon=True)
            for i in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    # --- lifecycle (ThreadingHTTPServer-shaped) ---
    def serve_forever(self):
        """The C++ accept loop serves from construction; this parks the
        calling thread until shutdown()."""
        self._done.wait()

    def shutdown(self):
        self._done.set()

    def server_close(self):
        self.shutdown()
        if self._h:
            self._closing = True
            self._lib.sf_stop(self._h)  # wakes every blocking ctypes call
            for t in self._threads:
                t.join(timeout=10)
            # sf_free deletes the C++ server's mutex and condition
            # variables: only once every connection thread has exited
            # (sf_stop waits up to 12 s; past that the handle is leaked
            # rather than freed under a live waiter)
            if self._lib.sf_quiesced(self._h):
                self._lib.sf_free(self._h)
            self._h = None

    # --- device tick thread ---
    def _tick_loop(self):
        srv = self.srv
        lib = self._lib
        wav_bytes = srv.S * self._cw_units * self._itemsize
        u8p = ctypes.POINTER(ctypes.c_uint8)
        while not self._closing:
            # sf_wait_gather writes every wire row (blank rows for inactive
            # streams) and the active bytes straight into the packed
            # layout. A new staging buffer per iteration (pinned on the
            # card): the caching host allocator hands its block out again
            # only after the copy from it has finished, so the next gather
            # never writes into a buffer still in flight.
            buf = srv.packed_buffer()
            wav_p = buf.ctypes.data_as(u8p)
            act_p = ctypes.cast(buf.ctypes.data + wav_bytes, u8p)
            n = lib.sf_wait_gather(self._h, wav_p, act_p, 200)
            if n < 0:
                return
            if n == 0:
                continue
            active = buf[wav_bytes:].astype(bool)
            dev_buf = srv.put_packed(buf)
            del buf
            with self.dev:
                srv.states, srv.tl = srv._packed_step(srv.states, srv.tl, dev_buf)
                srv.dispatches += 1
            with self.host_lock:
                srv._fed |= active
            lib.sf_tick_done(self._h)

    # --- slow-path workers ---
    def _worker_loop(self):
        lib = self._lib
        req = _ReqView()
        while True:
            r = lib.sf_next_request(self._h, ctypes.byref(req), 200)
            if r < 0:
                return
            if r == 0:
                if self._closing:
                    return
                continue
            try:
                status, payload = self._dispatch(req)
            except _HTTPError as e:
                status, payload = e.status, {"error": str(e)}
            except (KeyError, ValueError) as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:  # the worker keeps serving; the client sees a 500
                status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            body = json.dumps(payload).encode()
            lib.sf_respond(self._h, req.id, status, body, len(body))

    def _dispatch(self, req: _ReqView):
        method = {1: "GET", 2: "POST", 3: "DELETE"}.get(req.method, "GET")
        path = req.path.decode()
        ctype = req.ctype.decode()
        query = req.query.decode()
        body = ctypes.string_at(req.body, req.body_len) if req.body_len else b""
        xs = req.x_samples if req.x_samples >= 0 else None
        sync = "sync=0" not in query

        def top_k_param(default=5):
            m = re.search(r"top_k=(\d+)", query)
            return int(m.group(1)) if m else default

        m = _STREAM_RE.match(path)
        if method == "POST" and path == "/v1/streams":
            try:
                sid = self._open()
            except RuntimeError as e:
                raise _HTTPError(503, str(e))
            return 200, {"sid": sid, "chunk_samples": self.srv.chunk_samples}
        if method == "POST" and path == "/v1/tag":
            return 200, self._tag(body, ctype, xs, top_k_param())
        if method == "POST" and path == "/v1/reload":
            return 200, self._reload()
        if m:
            sid = int(m.group(1))
            leaf = m.group(2)
            if method == "POST" and leaf == "audio":
                return 200, self._audio_slow(sid, body, ctype, xs, sync)
            if method == "POST" and leaf == "flush":
                try:
                    return 200, {"flushed": bool(self._flush(sid))}
                except KeyError as e:
                    raise _HTTPError(404, str(e))
            if method == "GET" and leaf == "scores":
                try:
                    scores = self._scores(sid)
                except KeyError as e:
                    raise _HTTPError(404, str(e))
                except RuntimeError as e:
                    raise _HTTPError(409, str(e))
                order = np.argsort(-scores)[: top_k_param()]
                return 200, {"top_k": [[self.labels[i], float(scores[i])] for i in order]}
            if method == "GET" and leaf == "timeline":
                try:
                    scores, start, levels = self._timeline_with_scores(sid)
                except KeyError as e:
                    raise _HTTPError(404, str(e))
                except RuntimeError as e:
                    raise _HTTPError(409, str(e))
                return 200, _timeline_payload(self.cfg, self.labels, start, levels, scores,
                                              top_k_param())
            if method == "DELETE" and leaf is None:
                try:
                    self._close(sid)
                except KeyError as e:
                    raise _HTTPError(404, str(e))
                return 200, {"closed": True}
        raise _HTTPError(404, f"no route {path}")

    # --- stream operations (the C++ buffers as the source of truth) ---
    def _open(self) -> int:
        with self.dev, self.host_lock:
            sid = self.srv.open()
        self._lib.sf_stream_open(self._h, sid)
        return sid

    def _close(self, sid: int):
        with self.host_lock:
            self.srv._check(sid)
            self._lib.sf_stream_close(self._h, sid)
            self.srv.close(sid)

    def _append_wire(self, sid: int, wire: np.ndarray) -> int:
        """Append encoded wire bytes to the C++ buffer; returns chunks now
        ready (the HTTP ``advanced`` field, as TickLoop.feed returns)."""
        b = np.ascontiguousarray(wire).view(np.uint8).reshape(-1)
        if not len(b):
            return int(self._lib.sf_chunks_ready(self._h, sid))
        # append + count in one C critical section: the tick thread may
        # take the chunk at once, so a separate query could see 0
        return int(self._lib.sf_append(
            self._h, sid, b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b)))

    def _feed_samples(self, sid: int, samples: np.ndarray, ctype: str,
                      n_samples: Optional[int], sync: bool) -> int:
        """The slow-path half of serve.http._feed: transcode the decoded
        body into the server's wire format on the host, then append it to
        the C++ buffer. Mirrors BatchedStreamingServer.feed's routing."""
        srv = self.srv
        body_bits = _body_bits(ctype)
        with self.host_lock:
            srv._check(sid)
            if srv._adpcm is not None:
                if body_bits == srv._adpcm["bits"]:
                    wire = srv._coerce_adpcm(sid, samples, True)
                else:
                    if body_bits is not None:  # other-width adpcm body
                        samples = _host_adpcm_decode(samples, body_bits, n_samples)
                    elif samples.dtype == np.uint8:  # audio/basic mu-law
                        samples = mulaw_decode(samples)
                    wire = srv._coerce_adpcm(sid, samples, False)
                self._lib.sf_set_rem(self._h, sid, 1 if len(srv._rem[sid]) else 0)
            else:
                if body_bits is not None:
                    samples = _host_adpcm_decode(samples, body_bits, n_samples)
                wire = srv._coerce(samples)
            advanced = self._append_wire(sid, wire)
        if sync and advanced:
            self._lib.sf_wait_drained(self._h, sid, _SYNC_TIMEOUT_MS)
        return advanced

    def _audio_slow(self, sid: int, body: bytes, ctype: str, xs: Optional[int], sync: bool):
        try:
            samples = _decode_audio(body, ctype, self.cfg.frontend.sample_rate)
        except ValueError as e:
            raise _HTTPError(400, str(e))
        try:
            advanced = self._feed_samples(sid, samples, ctype, xs, sync)
        except KeyError as e:
            raise _HTTPError(404, str(e))
        except ValueError as e:
            raise _HTTPError(400, str(e))
        fed = int(len(samples))
        body_bits = _body_bits(ctype)
        if body_bits is not None:
            wb = wire_block_bytes(SERVE_BLOCK, bits=body_bits)
            fed = len(samples) // wb * SERVE_BLOCK
            if (xs is not None and xs <= fed
                    and self.srv.transfer_dtype != f"adpcm{body_bits}"):
                fed = xs  # the host decode sliced the final block's padding
        return {"fed_samples": fed, "advanced": advanced}

    def _flush(self, sid: int) -> bool:
        """Drain whole chunks through the tick thread, then hand the
        sub-chunk tail back to srv.flush (its n_valid masking and adpcm
        remainder fold as they are)."""
        self._lib.sf_wait_drained(self._h, sid, _SYNC_TIMEOUT_MS)
        with self.dev, self.host_lock:
            self.srv._check(sid)
            n = int(self._lib.sf_buffered(self._h, sid))
            if n:
                tail = np.empty(n, np.uint8)
                got = self._lib.sf_take_all(
                    self._h, sid, tail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
                self.srv._bufs[sid] = np.concatenate([
                    self.srv._bufs[sid], tail[:got].view(self.srv._buf_dtype)])
            flushed = self.srv.flush(sid)
            if self.srv._adpcm is not None:
                self._lib.sf_set_rem(self._h, sid, 0)  # flush consumed it
            return flushed

    def _scores(self, sid: int) -> np.ndarray:
        self._lib.sf_wait_drained(self._h, sid, _SYNC_TIMEOUT_MS)
        with self.host_lock:
            self.srv._check(sid)
            if not self.srv._fed[sid]:
                raise RuntimeError(f"stream {sid} has no processed audio yet")
            model, states = self.srv.model, self.srv.states
        # finalize and fetch outside every lock, on a snapshot
        return self.srv._finalize(model, states)[sid].float().cpu().numpy()

    def reload_now(self) -> Dict:
        """In-process weight swap (the stdlib front's reload_now contract;
        the reload watcher calls this)."""
        try:
            out = self._reload()
        except _HTTPError as e:
            raise RuntimeError(str(e))
        return {k: v for k, v in out.items() if k != "reloaded"}

    def _reload(self):
        """Weight swap (serve/http.py's /v1/reload) committed under the
        tick thread's dev lock; open streams keep their state."""
        if self.reload_fn is None:
            raise _HTTPError(409, "no reload source configured (start the "
                                  "service with a reload_fn / the serve verb)")
        try:
            out = self.reload_fn()
            state_dict, info = out if isinstance(out, tuple) else (out, {})
        except Exception as e:
            raise _HTTPError(500, f"reload failed: {type(e).__name__}: {e}")
        try:
            # build and upload the new model OUTSIDE the locks; only the
            # commit serializes with the tick
            staged = self.srv.prepare_reload(state_dict)
        except ValueError as e:  # mismatched state_dict
            raise _HTTPError(409, str(e))
        with self.dev, self.host_lock:
            self.srv.commit_reload(staged)
        return {"reloaded": True, **info}

    def _timeline_with_scores(self, sid: int):
        """(scores, start_patch, levels) from ONE consistent snapshot,
        taken under ``dev`` as well as ``host_lock``: the tick thread
        stores states and tl under ``dev``, so a host_lock-only reader
        could pair a pre-tick states with a post-tick ring. The one
        device-to-host copy runs outside the locks."""
        self._lib.sf_wait_drained(self._h, sid, _SYNC_TIMEOUT_MS)
        with self.dev, self.host_lock:
            self.srv._check(sid)
            if not self.srv._fed[sid]:
                raise RuntimeError(f"stream {sid} has no processed audio yet")
            model, states, tl = self.srv.model, self.srv.states, self.srv.tl
        return self.srv.timeline_with_scores_from(model, states, tl, sid)

    def _tag(self, body: bytes, ctype: str, xs: Optional[int], top_k: int):
        """One-shot tag: a transient slot on the shared batched step,
        released afterwards."""
        try:
            samples = _decode_audio(body, ctype, self.cfg.frontend.sample_rate)
        except ValueError as e:
            raise _HTTPError(400, str(e))
        try:
            sid = self._open()
        except RuntimeError as e:
            raise _HTTPError(503, str(e))
        try:
            self._feed_samples(sid, samples, ctype, xs, sync=True)
            self._flush(sid)
            scores = self._scores(sid)
        except RuntimeError as e:
            raise _HTTPError(422, f"clip unprocessable: {e}")
        except ValueError as e:
            raise _HTTPError(400, str(e))
        finally:
            self._close(sid)
        order = np.argsort(-scores)[:top_k]
        return {"top_k": [[self.labels[i], float(scores[i])] for i in order]}


def create_native_server(
    cfg: Config,
    state_dict: Dict,
    port: int = 8000,
    host: str = "127.0.0.1",
    max_streams: int = 8,
    chunk_patches: int = 5,
    transfer_dtype: str = "int16",
    mesh=None,
    batch_grace: float = 0.005,
    timeline_cap: int = 0,
    reload_fn=None,
    device=None,
) -> NativeTagServer:
    """``serve.http.create_server`` with the C++ front (same arguments, same
    HTTP API; serving starts at once, ``serve_forever`` only parks the
    caller). CLI: ``serve --native``."""
    return NativeTagServer(
        cfg, state_dict, port=port, host=host, max_streams=max_streams,
        chunk_patches=chunk_patches, transfer_dtype=transfer_dtype, mesh=mesh,
        batch_grace=batch_grace, timeline_cap=timeline_cap, reload_fn=reload_fn,
        device=device)
