"""HTTP front for the batched streaming server (counterpart of
``mla_tpu/serve/http.py``): the deployable service.

Stdlib-only (http.server); all device work stays in
``BatchedStreamingServer``. Concurrency shape (``serve/ticker.py``): handler
threads only decode bodies and append to host buffers; a single tick thread
batches every ready stream into one device step, so concurrent clients share
steps and overlap their HTTP routing with device compute.

API (JSON unless noted):
    POST   /v1/streams                      -> {"sid": int, "chunk_samples"}
    POST   /v1/streams/<sid>/audio[?sync=0] raw f32 LE PCM (octet-stream),
                                            int16 LE PCM (audio/L16), mu-law
                                            (audio/basic), ADPCM wire blocks
                                            (audio/adpcm4, audio/adpcm2) or a
                                            WAV file (audio/wav)
                                            -> {"fed_samples", "advanced"}
        default: the reply returns after the completed chunks are folded
        into device state ("advanced" counts folds). ?sync=0 replies as
        soon as the audio is buffered ("advanced" counts chunks made
        ready) so the client can pipeline uploads; backpressure beyond a
        small backlog, and scores/flush always drain first.
        ADPCM bodies should be whole 64-sample blocks mid-stream; a final
        partial block may declare its true sample count in an
        ``X-Samples: <n>`` header so edge padding is sliced off when the
        server decodes the wire on the host.
    POST   /v1/streams/<sid>/flush          -> {"flushed": bool}
    GET    /v1/streams/<sid>/scores?top_k=5 -> {"top_k": [[label, p], ...]}
    GET    /v1/streams/<sid>/timeline?top_k=5
        per-patch localization window (requires timeline_cap > 0):
        {"start_patch", "hop_s", "classes": [[label, p], ...],
         "weights": [[...]], "probs": [[...]]}, one row per 0.96 s patch
        of the last timeline_cap patches, columns the top-k classes,
        level-mean attention weight and segment prob
    DELETE /v1/streams/<sid>                -> {"closed": true}
    POST   /v1/tag?top_k=5                  one-shot: a whole clip in (any
                                            body format above) -> top-k
    GET    /v1/healthz                      -> {"ok": true, ...}
    POST   /v1/reload                       -> {"reloaded": true, ...}
        weight swap while streams stay open (requires reload_fn; the
        ``serve`` verb re-reads the workspace's latest checkpoint)

    srv = create_server(cfg, state_dict, port=0)   # port 0 = ephemeral
    srv.serve_forever()                             # or in a thread

``create_server`` runs on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from mla_tpu_torch.config import Config
from mla_tpu_torch.data import audio_io
from mla_tpu_torch.data.adpcm import (
    SERVE_BLOCK,
    adpcm2_decode,
    adpcm4_decode,
    wire_block_bytes,
)
from mla_tpu_torch.data.labels import labels_for
from mla_tpu_torch.ops.frontend import patch_hop_seconds
from mla_tpu_torch.serve.server import BatchedStreamingServer
from mla_tpu_torch.serve.ticker import TickLoop

_STREAM_RE = re.compile(
    r"^/v1/streams/(\d+)(?:/(audio|flush|scores|timeline))?$")


class _BodyTooLarge(ValueError):
    """Request body over the per-request cap (guards host RAM; long audio
    should be streamed in chunks — that is the whole point of the API)."""


def _decode_audio(body: bytes, content_type: str, sample_rate: int) -> np.ndarray:
    """Request body -> samples. Accepts a WAV file (audio/wav or RIFF
    magic), raw little-endian int16 PCM (Content-Type audio/L16, half the
    bytes of f32), 8-bit mu-law (audio/basic, G.711-style mu=255, a
    quarter of f32), 4- or 2-bit block ADPCM wire (audio/adpcm4,
    audio/adpcm2; decoded on the device when the server runs that wire),
    or raw little-endian float32 PCM (anything else)."""
    # explicit Content-Types take precedence over magic sniffing: mu-law
    # bytes are dense in [0,255], so a chunk CAN legitimately start with
    # b"RIFF" — only sniff when the client didn't declare a raw format
    if content_type.startswith("audio/L16") or content_type.startswith("audio/l16"):
        if len(body) % 2:
            raise ValueError("audio/L16 body length must be a multiple of 2 (int16 LE)")
        return np.frombuffer(body, dtype="<i2")  # server dequantizes/coerces
    if content_type.startswith("audio/basic"):
        # uint8 arrays are mu-law codes by server convention; with
        # transfer_dtype="uint8" the bytes go to HBM still compressed
        return np.frombuffer(body, dtype=np.uint8)
    if (content_type.startswith("audio/adpcm4")
            or content_type.startswith("audio/adpcm2")):
        return np.frombuffer(body, dtype=np.uint8)  # wire blocks
    if content_type.startswith("audio/wav") or body[:4] == b"RIFF":
        wav, sr = audio_io.read_wav_bytes(body)
        if sr != sample_rate:
            wav = audio_io.resample(wav, sr, sample_rate)
        return wav
    if len(body) % 4:
        raise ValueError(
            "raw PCM body length must be a multiple of 4 (float32 LE); "
            "send Content-Type: audio/L16 for int16 PCM"
        )
    return np.frombuffer(body, dtype="<f4").astype(np.float32)


def _body_bits(content_type: str) -> Optional[int]:
    """The code width of an ADPCM body (audio/adpcm4, audio/adpcm2), else None."""
    return (4 if content_type.startswith("audio/adpcm4")
            else 2 if content_type.startswith("audio/adpcm2") else None)


def _feed(st: "_TaggerState", sid: int, samples: np.ndarray,
          content_type: str, n_samples: Optional[int] = None,
          sync: bool = True) -> int:
    """Route decoded body samples into the server (via its tick loop),
    reconciling the two uint8 body meanings (mu-law codes vs adpcm4 wire
    blocks) against the server's own wire format. Returns the number of
    chunks the feed completed — folded into device state before return
    when ``sync`` (the default); made ready when the client asked for a
    pipelined feed (``?sync=0``, bounded by server-side backpressure).

    ``n_samples`` (the X-Samples request header) is the true sample count
    an adpcm4 body carries. Without it, a final partial block's edge
    padding (up to block-1 repeated samples) would be injected mid-stream
    when the body is host-decoded for a non-adpcm4 server; the SDK only
    pads at flush, but raw HTTP clients may pad every chunk."""
    body_bits = _body_bits(content_type)
    srv_adpcm = getattr(st.server, "_adpcm", None)
    if srv_adpcm is not None:
        if body_bits == srv_adpcm["bits"]:  # matching wire: zero host work
            return st.ticker.feed(sid, samples, wire=True, sync=sync)
        if body_bits is not None:  # other-width adpcm body: host transcode
            samples = _host_adpcm_decode(samples, body_bits, n_samples)
        elif samples.dtype == np.uint8:  # audio/basic: expand mu-law
            samples = audio_io.mulaw_decode(samples)
        return st.ticker.feed(sid, samples, wire=False, sync=sync)
    if body_bits is not None:  # adpcm body to a non-adpcm server
        samples = _host_adpcm_decode(samples, body_bits, n_samples)
    return st.ticker.feed(sid, samples, sync=sync)


def _host_adpcm_decode(samples: np.ndarray, bits: int,
                       n_samples: Optional[int]) -> np.ndarray:
    dec = adpcm4_decode if bits == 4 else adpcm2_decode
    return dec(samples, n=n_samples, block=SERVE_BLOCK)


def _timeline_payload(cfg, labels, start_patch, levels, scores,
                      top_k: int) -> Dict:
    """JSON body for GET .../timeline: level-MEAN attention weights and
    segment probs for the stream's current top-k classes, one row per
    0.96 s patch in the recorded window (shared by the stdlib and native
    tiers so the wire format stays identical)."""
    order = np.argsort(-scores)[:top_k]
    w = np.mean([wl for wl, _ in levels], axis=0)  # [T, C]
    f = np.mean([fl for _, fl in levels], axis=0)
    hop_s = patch_hop_seconds(cfg.frontend)
    return {
        "start_patch": int(start_patch),
        "hop_s": hop_s,
        "classes": [[labels[i], float(scores[i])] for i in order],
        "weights": [[float(w[t, i]) for i in order]
                    for t in range(w.shape[0])],
        "probs": [[float(f[t, i]) for i in order]
                  for t in range(f.shape[0])],
    }


class _TaggerState:
    """Shared state behind the handler: the device server and its tick loop.

    Handler threads run no device step: they buffer and encode through
    ``ticker`` (serve/ticker.py), and one tick thread batches every ready
    stream into a single masked device step."""

    def __init__(self, cfg: Config, state_dict: Dict, max_streams: int,
                 chunk_patches: int, transfer_dtype: str, mesh=None,
                 batch_grace: float = 0.005, timeline_cap: int = 0,
                 reload_fn=None, device=None):
        self.cfg = cfg
        self.reload_fn = reload_fn
        self.server = BatchedStreamingServer(
            cfg, state_dict, max_streams=max_streams, chunk_patches=chunk_patches,
            transfer_dtype=transfer_dtype, mesh=mesh, timeline_cap=timeline_cap,
            device=device,
        )
        # build the kernels and warm the step before traffic: a cold first
        # step (nvcc at first use) could outlast a client's wait
        self.server.warmup(packed=True)
        self.ticker = TickLoop(self.server, batch_grace=batch_grace)
        self.labels = labels_for(cfg.data.dataset, cfg.model.n_classes)


class _Handler(BaseHTTPRequestHandler):
    state: _TaggerState  # set by create_server on the subclass

    # keep-alive: a streaming client posts many small bodies per second,
    # and per-request TCP setup + a fresh handler thread per connection
    # would be paid on each. Every reply carries Content-Length, oversized
    # bodies set close_connection before the 413 (see _read_body), so
    # HTTP/1.1 persistence is safe. Dead connections are reaped by the
    # socket timeout below (handler threads are daemons regardless).
    protocol_version = "HTTP/1.1"
    timeout = 120

    # silence the default per-request stderr lines (service logs go to the
    # caller's logging setup, not the socket handler)
    def log_message(self, fmt, *args):  # pragma: no cover - cosmetic
        pass

    def _reply(self, code: int, obj: Dict):
        # keep-alive hygiene: if this request carried a body no route
        # consumed (unknown route, flush/DELETE with an unexpected body),
        # the unread bytes would desync the next request on the persistent
        # connection — drop it after replying (SDK always sends
        # Content-Length: 0 on those routes; only raw clients hit this)
        if (not getattr(self, "_body_consumed", True)
                and int(self.headers.get("Content-Length") or 0) > 0):
            self.close_connection = True
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:  # announce it (413s, unread bodies)
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str):
        self._reply(code, {"error": msg})

    max_body_bytes = 64 * 1024 * 1024  # ~17 min of f32 audio per request

    def _read_body(self) -> bytes:
        self._body_consumed = True
        n = int(self.headers.get("Content-Length") or 0)
        if n > self.max_body_bytes:
            # the body is never read on this path; drop the connection so
            # the 413 stays correct even if protocol_version is ever bumped
            # to HTTP/1.1 (an unread body would desync keep-alive)
            self.close_connection = True
            raise _BodyTooLarge(n)
        return self.rfile.read(n) if n else b""

    def _sync_param(self) -> bool:
        """``?sync=0`` on an audio POST asks for a pipelined feed: the
        reply returns once the audio is buffered (chunks made ready in
        ``advanced``) instead of after the device fold — clients overlap
        their next upload with ticks; scores/flush still drain first."""
        return not ("?" in self.path and "sync=0" in self.path.split("?", 1)[1])

    def _x_samples(self) -> Optional[int]:
        """Optional X-Samples header: the true sample count of an adpcm4
        body (so a final partial block's padding can be sliced off when
        the body is host-decoded). None when absent or malformed."""
        v = self.headers.get("X-Samples")
        if v is None:
            return None
        try:
            n = int(v)
        except ValueError:
            return None
        return n if n >= 0 else None

    def do_GET(self):
        # no GET route reads a body, but a raw client MAY send one
        # (Content-Length on GET is legal); unread bytes would desync
        # keep-alive exactly like an unconsumed POST body — let _reply's
        # guard close the connection in that case
        self._body_consumed = False
        st = self.state
        if self.path.startswith("/v1/healthz"):
            open_n = st.ticker.open_streams()
            self._reply(200, {"ok": True, "open_streams": open_n,
                              "backlog": st.ticker.backlog(),
                              "max_streams": st.server.S,
                              "ticks": st.ticker.ticks,
                              "ticked_streams": st.ticker.ticked_streams,
                              "variant": st.cfg.model.variant,
                              "sample_rate": st.cfg.frontend.sample_rate,
                              "transfer_dtype": st.server.transfer_dtype})
            return
        m = _STREAM_RE.match(self.path.split("?")[0])
        if m and m.group(2) == "scores":
            sid = int(m.group(1))
            top_k = self._top_k_param()
            try:
                scores = st.ticker.scores(sid)
            except (KeyError, RuntimeError) as e:
                self._error(409 if isinstance(e, RuntimeError) else 404, str(e))
                return
            order = np.argsort(-scores)[:top_k]
            self._reply(200, {"top_k": [[st.labels[i], float(scores[i])] for i in order]})
            return
        if m and m.group(2) == "timeline":
            sid = int(m.group(1))
            try:
                # one consistent snapshot: the classes labeling the window
                # must reflect the same folded chunks as the window rows
                scores, start, levels = st.ticker.timeline_with_scores(sid)
            except KeyError as e:
                self._error(404, str(e))
                return
            except RuntimeError as e:
                # no audio yet -> 409; timeline disabled -> 409 too (the
                # resource exists, the server just wasn't started with it)
                self._error(409, str(e))
                return
            self._reply(200, _timeline_payload(
                st.cfg, st.labels, start, levels, scores,
                self._top_k_param()))
            return
        self._error(404, f"no route {self.path}")

    def _top_k_param(self, default: int = 5) -> int:
        if "?" in self.path and "top_k=" in self.path:
            try:
                return int(self.path.split("top_k=")[1].split("&")[0])
            except ValueError:
                pass
        return default

    def do_POST(self):
        self._body_consumed = False  # see _reply: keep-alive body hygiene
        st = self.state
        if self.path.split("?")[0] == "/v1/reload":
            # weight swap: re-read the configured source and commit it
            # under the tick thread's device lock; open streams keep their
            # accumulators. One implementation per front: this delegates to
            # _TaggerHTTPServer.reload_now (the reload watcher's entry
            # point too).
            try:
                info = self.server.reload_now()
            except RuntimeError as e:  # no reload source configured
                self._error(409, str(e))
                return
            except ValueError as e:  # mismatched tree
                self._error(409, str(e))
                return
            except Exception as e:
                self._error(500, f"reload failed: {type(e).__name__}: {e}")
                return
            self._reply(200, {"reloaded": True, **info})
            return
        if self.path.split("?")[0] == "/v1/tag":
            # one-shot convenience (reference C15): whole clip -> top-k,
            # via a transient slot on the shared batched program (same
            # compiled chunk step, no per-request compile)
            try:
                body = self._read_body()
            except _BodyTooLarge as e:
                self._error(413, f"body {e.args[0]} bytes exceeds "
                                 f"{self.max_body_bytes}; use the stream API")
                return
            try:
                samples = _decode_audio(body, self.headers.get("Content-Type", ""),
                                        st.cfg.frontend.sample_rate)
            except ValueError as e:
                self._error(400, str(e))
                return
            try:
                sid = st.ticker.open()
            except RuntimeError as e:
                self._error(503, str(e))
                return
            try:
                _feed(st, sid, samples,
                      self.headers.get("Content-Type", ""),
                      n_samples=self._x_samples())
                st.ticker.flush(sid)  # folds whole chunks + the tail
                scores = st.ticker.scores(sid)
            except RuntimeError as e:
                self._error(422, f"clip unprocessable: {e}")
                return
            except ValueError as e:  # malformed wire body
                self._error(400, str(e))
                return
            finally:
                st.ticker.close(sid)
            order = np.argsort(-scores)[: self._top_k_param()]
            self._reply(200, {"top_k": [[st.labels[i], float(scores[i])]
                                        for i in order]})
            return
        if self.path == "/v1/streams":
            try:
                sid = st.ticker.open()
            except RuntimeError as e:
                self._error(503, str(e))
                return
            self._reply(200, {"sid": sid, "chunk_samples": st.server.chunk_samples})
            return
        m = _STREAM_RE.match(self.path.split("?")[0])
        if m and m.group(2) == "audio":
            sid = int(m.group(1))
            try:
                body = self._read_body()
            except _BodyTooLarge as e:
                self._error(413, f"body {e.args[0]} bytes exceeds "
                                 f"{self.max_body_bytes}; stream audio in chunks")
                return
            try:
                samples = _decode_audio(body, self.headers.get("Content-Type", ""),
                                        st.cfg.frontend.sample_rate)
            except ValueError as e:
                self._error(400, str(e))
                return
            try:
                advanced = _feed(st, sid, samples,
                                 self.headers.get("Content-Type", ""),
                                 n_samples=self._x_samples(),
                                 sync=self._sync_param())
            except KeyError as e:
                self._error(404, str(e))
                return
            except ValueError as e:  # malformed wire body
                self._error(400, str(e))
                return
            ctype = self.headers.get("Content-Type", "")
            fed = int(len(samples))
            body_bits = _body_bits(ctype)
            if body_bits is not None:
                # the body was wire BYTES; report the samples they carry,
                # consistent with every other body format and pending()
                wb = wire_block_bytes(SERVE_BLOCK, bits=body_bits)
                fed = len(samples) // wb * SERVE_BLOCK
                xs = self._x_samples()
                if (xs is not None and xs <= fed
                        and st.server.transfer_dtype != f"adpcm{body_bits}"):
                    # host-decode path sliced padding off with n=X-Samples;
                    # on a matching-wire server the wire is buffered whole,
                    # so every block's samples really were fed
                    fed = xs
            self._reply(200, {"fed_samples": fed, "advanced": advanced})
            return
        if m and m.group(2) == "flush":
            sid = int(m.group(1))
            try:
                flushed = st.ticker.flush(sid)
            except KeyError as e:
                self._error(404, str(e))
                return
            self._reply(200, {"flushed": bool(flushed)})
            return
        self._error(404, f"no route {self.path}")

    def do_DELETE(self):
        self._body_consumed = False  # see _reply: keep-alive body hygiene
        m = _STREAM_RE.match(self.path.split("?")[0])
        if m and m.group(2) is None:
            sid = int(m.group(1))
            try:
                self.state.ticker.close(sid)
            except KeyError as e:
                self._error(404, str(e))
                return
            self._reply(200, {"closed": True})
            return
        self._error(404, f"no route {self.path}")


def _call_reload_fn(reload_fn):
    """Normalize a reload_fn result to (state_dict, info): the one place
    that owns the 'state_dict or (state_dict, info_dict)' contract for both
    fronts and the watcher."""
    if reload_fn is None:
        raise RuntimeError("no reload source configured (start the "
                           "service with a reload_fn / the serve verb)")
    out = reload_fn()
    return out if isinstance(out, tuple) else (out, {})


class _TaggerHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that also stops the tick thread when the service
    shuts down."""

    state: _TaggerState  # set by create_server

    def reload_now(self) -> Dict:
        """Swap weights from the configured reload_fn (the /v1/reload
        handler and the reload watcher both call this)."""
        state_dict, info = _call_reload_fn(self.state.reload_fn)
        self.state.ticker.reload_weights(state_dict)
        return info

    def server_close(self):
        super().server_close()
        self.state.ticker.stop()


def start_reload_watcher(srv, ckpt_dir: str, interval_s: float,
                         initial_step: Optional[int] = None):
    """Poll ``ckpt_dir`` (the port's checkpoint directory:
    ``step_<8 digits>.pt`` files, renamed into place whole) every
    ``interval_s`` and swap the service's weights through
    ``srv.reload_now()`` whenever a newer step appears (``serve
    --reload_every``). Works on both fronts (each has ``reload_now``).
    Returns a threading.Event; set it to stop the watcher.

    ``initial_step``: the step the server loaded. Pass it when known:
    seeding from the directory when the watcher starts would skip a
    checkpoint written while the server was built and warmed up."""
    step_re = re.compile(r"^step_(\d{8})\.pt$")

    def latest_step():
        try:
            steps = [int(m.group(1)) for m in map(step_re.match, os.listdir(ckpt_dir)) if m]
        except OSError:
            return None
        return max(steps) if steps else None

    stop = threading.Event()
    seen = latest_step() if initial_step is None else initial_step

    def watch():
        nonlocal seen
        while not stop.wait(interval_s):
            step = latest_step()
            if step is None or step == seen:
                continue
            try:
                srv.reload_now()
                seen = step
                print(f"# auto-reload: weights from checkpoint step {step}", flush=True)
            except Exception as e:  # keep serving on a bad or partial reload
                print(f"# auto-reload failed at step {step}: {type(e).__name__}: {e}",
                      flush=True)

    threading.Thread(target=watch, name="mla-reload-watch", daemon=True).start()
    return stop


def create_server(
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
) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving; call .serve_forever()).

    ``transfer_dtype`` is the wire the server buffers and uploads:
    "int16" (default; PCM16, dequantized on the device), "float32",
    "uint8" (8-bit mu-law, expanded on the device) or "adpcm4" / "adpcm2"
    (block ADPCM, decoded on the device by ``ops/adpcm.py``'s kernel).
    ``batch_grace``: how long the tick thread waits for more streams to
    fill a chunk before dispatching (serve/ticker.py). ``timeline_cap`` > 0
    enables GET /v1/streams/<sid>/timeline: the last timeline_cap patches'
    localization readout, recorded on the device inside the step.
    ``reload_fn`` (a zero-arg callable returning a new state_dict, or
    ``(state_dict, info_dict)``) enables POST /v1/reload: a weight swap
    while open streams keep their accumulators. ``device`` None is the
    card (raises without one); only ``device="cpu"`` runs on the CPU. A
    device mesh is not ported yet (ROADMAP.md queue A, item 9): ``mesh``
    raises ``NotImplementedError``."""
    state = _TaggerState(cfg, state_dict, max_streams, chunk_patches,
                         transfer_dtype, mesh=mesh, batch_grace=batch_grace,
                         timeline_cap=timeline_cap, reload_fn=reload_fn, device=device)
    handler = type("Handler", (_Handler,), {"state": state})
    srv = _TaggerHTTPServer((host, port), handler)
    srv.state = state
    return srv
