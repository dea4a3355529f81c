"""Python client for the HTTP tagging service (own copy of
``mla_tpu/serve/client.py``; it talks to either front, ``serve/http.py`` or
``serve/native_front.py``). The client owns the wire encoders (PCM16, 8-bit
mu-law, 4- and 2-bit block ADPCM from ``data/adpcm.py``), so the server
never touches samples when the client encodes.

stdlib-only on the network side (http.client + numpy).

    c = TagClient("http://host:8000")
    c.tag(wav)                        # one-shot: [(label, prob), ...]
    c.tag_file("clip.wav")
    with c.stream(wire="adpcm4") as s:
        s.feed(block); s.feed(block)  # arbitrary block sizes
        s.flush()
        s.scores(top_k=5)

Wire formats (``wire=``): "float32" (4 B/sample), "int16" (2), "mulaw"
(1), "adpcm4" (~0.55) and "adpcm2" (encoded client-side in 64-sample blocks
with a sub-block remainder carried between feeds). The server decodes int16 /
mu-law / adpcm on the device when its transfer_dtype matches; mismatched
combinations still work (the server transcodes on the host).
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from mla_tpu_torch.data import adpcm
from mla_tpu_torch.data.audio_io import mulaw_encode, pcm16_quantize
from mla_tpu_torch.serve.events import events_from_timeline_payload

_CTYPE = {
    "float32": "application/octet-stream",
    "int16": "audio/L16",
    "mulaw": "audio/basic",
    "adpcm4": "audio/adpcm4",
    "adpcm2": "audio/adpcm2",
    "wav": "audio/wav",
}


class _WireEncoder:
    """Stateful sample -> wire-bytes encoder for one stream. adpcm4 needs
    the state: blocks are 64 samples, so a sub-block remainder is carried
    between feed() calls (flush() pads the final partial block — the
    server masks sub-patch tails anyway)."""

    def __init__(self, wire: str):
        if wire not in ("float32", "int16", "mulaw", "adpcm4", "adpcm2"):
            raise ValueError(
                "wire must be float32|int16|mulaw|adpcm4|adpcm2, "
                f"got {wire!r}")
        self.wire = wire
        self._rem = np.zeros(0, np.int16)

    @staticmethod
    def _int16(x: np.ndarray) -> np.ndarray:
        return pcm16_quantize(x)

    @staticmethod
    def _float(x: np.ndarray) -> np.ndarray:
        """float32 [-1,1] view of the input; int16 PCM is dequantized —
        raw int16 magnitudes fed to a float wire would clip to full scale
        (every sample >= 1 saturates) and tag garbage."""
        x = np.asarray(x)
        if x.dtype == np.int16:
            return x.astype(np.float32) / 32768.0
        return np.asarray(x, np.float32)

    def encode(self, x: np.ndarray, final: bool = False) -> bytes:
        if self.wire == "float32":
            return self._float(x).tobytes()
        if self.wire == "int16":
            return self._int16(x).astype("<i2").tobytes()
        if self.wire == "mulaw":
            return mulaw_encode(self._float(x)).tobytes()
        enc = (adpcm.adpcm2_encode if self.wire == "adpcm2"
               else adpcm.adpcm4_encode)
        buf = np.concatenate([self._rem, self._int16(x)])
        nb = len(buf) // adpcm.SERVE_BLOCK
        if final:
            self._rem = np.zeros(0, np.int16)
            if len(buf) == 0:
                return b""
            return enc(buf, block=adpcm.SERVE_BLOCK).tobytes()
        self._rem = buf[nb * adpcm.SERVE_BLOCK:]
        if nb == 0:
            return b""
        return enc(buf[: nb * adpcm.SERVE_BLOCK],
                   block=adpcm.SERVE_BLOCK).tobytes()


class TagClient:
    """Thin HTTP client; one instance per service. Connections are
    PERSISTENT (HTTP/1.1 keep-alive, one per calling thread) — a stream
    posts many small bodies per second and per-request TCP setup plus the
    server's per-connection handler thread cost more than a compressed
    tick (measured 5x on the adpcm4 wire). Thread-safe: each thread gets
    its own socket, so N threads driving N streams don't serialize."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        if "//" not in base_url:  # "host:8000" parses host as the scheme
            base_url = "http://" + base_url
        u = urlparse(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"only http:// is supported, got {base_url!r}")
        if u.path not in ("", "/"):
            raise ValueError(
                f"base_url path {u.path!r} would be silently dropped — the "
                "service mounts at /v1 on the host root (reverse-proxy "
                "prefixes are not supported)")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 8000
        self.timeout = timeout
        self._local = threading.local()

    def close(self):
        """Drop this thread's persistent connection (sockets are
        per-thread; other threads' connections close with their threads
        or at GC)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            conn.close()

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 ctype: str = "application/octet-stream") -> dict:
        headers = {"Content-Type": ctype} if body is not None else {}
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=self.timeout)
                self._local.conn = conn
            try:
                conn.request(method, path, body=body, headers=headers)
            except (ConnectionResetError, BrokenPipeError):
                # SEND-phase failure: the request body was not fully
                # delivered, so the server cannot have processed it
                # (Content-Length framing — a handler reads the whole
                # body before acting). Safe to retry ANY method; this is
                # the common idle-reap case (native front reaps
                # keep-alive connections after IDLE_TIMEOUT_S).
                self.close()
                if attempt:
                    raise
                continue
            except Exception:
                self.close()  # unknown connection state: don't reuse
                raise
            try:
                resp = conn.getresponse()
                raw = resp.read()
            except http.client.RemoteDisconnected:
                # stale keep-alive: the server closed the idle connection
                # WITHOUT responding, so the request was not processed —
                # reconnect and retry once (a real outage fails again)
                self.close()
                if attempt:
                    raise
                continue
            except (ConnectionResetError, BrokenPipeError):
                # RESPONSE-phase reset: can arrive AFTER the server
                # processed the request but before the reply was read —
                # retrying a non-idempotent POST (e.g. a stream audio
                # feed) would duplicate its effect. Retry only GETs.
                self.close()
                if attempt or method != "GET":
                    raise
                continue
            except Exception:
                self.close()  # unknown connection state: don't reuse
                raise
            if resp.will_close:
                self.close()
            try:
                payload = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                # not the service's JSON (proxy error page, truncated
                # body): surface the HTTP status, not a parse error
                raise TagServiceError(
                    resp.status, f"non-JSON response: {raw[:200]!r}")
            if resp.status != 200:
                raise TagServiceError(resp.status,
                                      payload.get("error", str(payload)))
            return payload

    def health(self) -> dict:
        return self._request("GET", "/v1/healthz")

    def reload(self) -> dict:
        """Ask the service to hot-swap its weights from its configured
        checkpoint source (POST /v1/reload; requires the server to run
        with a reload_fn — `serve` wires it to the workspace's latest
        checkpoint). Zero downtime: open streams keep their state."""
        return self._request("POST", "/v1/reload")

    def tag(self, wav: np.ndarray, top_k: int = 5,
            wire: str = "int16") -> List[Tuple[str, float]]:
        """One-shot: waveform (float [-1,1] or int16, service sample rate)
        -> [(label, prob), ...]. ``wire`` picks the upload encoding."""
        enc = _WireEncoder(wire)
        body = enc.encode(np.asarray(wav).reshape(-1), final=True)
        out = self._request("POST", f"/v1/tag?top_k={top_k}", body,
                            _CTYPE[wire])
        return [(name, float(p)) for name, p in out["top_k"]]

    def tag_file(self, path: str, top_k: int = 5) -> List[Tuple[str, float]]:
        """POST a wav file as-is (the server decodes/resamples)."""
        with open(path, "rb") as f:
            body = f.read()
        out = self._request("POST", f"/v1/tag?top_k={top_k}", body,
                            _CTYPE["wav"])
        return [(name, float(p)) for name, p in out["top_k"]]

    def stream(self, wire: str = "int16", sync: bool = True) -> "TagStream":
        """``sync=False`` asks the server for pipelined feeds (?sync=0):
        each feed returns once buffered server-side, overlapping the next
        upload with device ticks — higher throughput for continuous
        streams; scores()/flush() still reflect everything fed."""
        return TagStream(self, wire, sync=sync)


class TagStream:
    """One long-form stream: feed arbitrary sample blocks, read scores at
    any time. Context-manager closes the server slot."""

    def __init__(self, client: TagClient, wire: str, sync: bool = True):
        self._c = client
        self._enc = _WireEncoder(wire)
        self._ctype = _CTYPE[wire]
        self._qs = "" if sync else "?sync=0"
        out = client._request("POST", "/v1/streams")
        self.sid = out["sid"]
        self.chunk_samples = out.get("chunk_samples")

    def feed(self, samples: np.ndarray) -> int:
        """Send a block; returns how many server chunks advanced."""
        body = self._enc.encode(np.asarray(samples).reshape(-1))
        if not body:
            return 0  # adpcm4 sub-block remainder: nothing to send yet
        return self.feed_wire(body)

    def feed_wire(self, body: bytes) -> int:
        """Send already-encoded wire bytes in this stream's format (for
        feeders that hold pre-encoded audio — a relay, a codec pipeline, a
        benchmark: no client-side encode in the hot path). The body must
        be whole wire units (4 B/sample float32, 2 int16, 1 mu-law; whole
        64-sample blocks for adpcm4 — mixing feed() sub-block remainders
        with feed_wire is rejected server-side rather than reordered)."""
        out = self._c._request(
            "POST", f"/v1/streams/{self.sid}/audio{self._qs}", body,
            self._ctype)
        return int(out.get("advanced", 0))

    def flush(self) -> bool:
        tail = self._enc.encode(np.zeros(0, np.int16), final=True)
        if tail:
            self._c._request("POST",
                             f"/v1/streams/{self.sid}/audio{self._qs}",
                             tail, self._ctype)
        out = self._c._request("POST", f"/v1/streams/{self.sid}/flush")
        return bool(out.get("flushed", False))

    def scores(self, top_k: int = 5) -> List[Tuple[str, float]]:
        out = self._c._request(
            "GET", f"/v1/streams/{self.sid}/scores?top_k={top_k}")
        return [(name, float(p)) for name, p in out["top_k"]]

    def timeline(self, top_k: int = 5) -> dict:
        """Per-patch localization window (requires the server to run with
        timeline_cap > 0): {"start_patch", "hop_s", "classes": [[label,
        clip_prob], ...], "weights": [[...]], "probs": [[...]]} — one row
        per 0.96 s patch, columns = the stream's current top-k classes
        (level-mean attention weight and segment prob)."""
        return self._c._request(
            "GET", f"/v1/streams/{self.sid}/timeline?top_k={top_k}")

    def events(self, top_k: int = 5, threshold=0.5,
               merge_gap_s: float = 0.0, min_dur_s: float = 0.0) -> list:
        """Discrete events over the stream's timeline window (client-side
        post-processing — serve/events.py): [{"label", "t_start", "t_end",
        "score", "mean", "att_mass", "class_idx"}, ...], timestamps
        absolute on the stream's patch grid. ``threshold``: scalar or a
        {label: threshold} table (eval --calibrate output)."""
        return events_from_timeline_payload(
            self.timeline(top_k=top_k), threshold=threshold,
            merge_gap_s=merge_gap_s, min_dur_s=min_dur_s)

    def close(self):
        if self.sid is not None:
            self._c._request("DELETE", f"/v1/streams/{self.sid}")
            self.sid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TagServiceError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
