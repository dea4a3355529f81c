"""ctypes bindings for the native audio-ingest library (counterpart of
``mla_tpu/data/native.py``): C++ wav decode, polyphase resample, mu-law and
the ADPCM encoders (threaded across rows), and a streaming ring buffer.
A host library, not a device kernel.

``native/audio_ingest.cpp`` is compiled unedited by ``g++`` at first use
into ``build/mla_tpu_torch/`` (``ops/_build.py::load_native``). On a host
without ``g++``, or where the build fails, ``available()`` is False and
the callers in ``data/audio_io.py`` and ``data/adpcm.py`` take their numpy
and scipy paths, as the reference's do. ``CALLS`` counts the calls of each
entry point, so a run can show that the library carried its work.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from math import gcd
from typing import Dict, Optional, Tuple

import numpy as np

CALLS: Dict[str, int] = {name: 0 for name in (
    "wav_decode", "resample", "mulaw_encode", "mulaw_decode", "adpcm4_encode",
    "adpcm2_encode")}

_LIB = None  # None: not tried yet; False: tried and failed
_LOCK = threading.Lock()
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I16 = ctypes.POINTER(ctypes.c_int16)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_long, c_void_p = ctypes.c_long, ctypes.c_void_p
    lib.wav_decode.restype = c_long
    lib.wav_decode.argtypes = [ctypes.c_char_p, c_long, _F32, c_long,
                               ctypes.POINTER(ctypes.c_int)]
    lib.resample_poly.restype = c_long
    lib.resample_poly.argtypes = [_F32, c_long, c_long, c_long, _F32, c_long]
    lib.ring_new.restype = c_void_p
    lib.ring_free.argtypes = [c_void_p]
    lib.ring_push.argtypes = [c_void_p, _F32, c_long]
    lib.ring_size.restype = c_long
    lib.ring_size.argtypes = [c_void_p]
    lib.ring_pop_chunk.restype = ctypes.c_int
    lib.ring_pop_chunk.argtypes = [c_void_p, _F32, c_long, c_long]
    lib.mulaw_encode.argtypes = [_F32, c_long, _U8]
    lib.mulaw_decode.argtypes = [_U8, c_long, _F32]
    lib.adpcm4_encode.argtypes = [_I16, c_long, c_long, c_long, _U8]
    lib.adpcm2_encode.argtypes = [_I16, c_long, c_long, c_long, _U8]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    with _LOCK:
        if _LIB is None:
            from mla_tpu_torch.ops._build import load_native

            try:
                _LIB = _declare(load_native("audio_ingest"))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _LIB = False
    return _LIB or None


def _require(name: str) -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native audio_ingest unavailable (g++ build failed or missing)")
    CALLS[name] += 1
    return lib


def available() -> bool:
    return _lib() is not None


def wav_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """wav bytes -> (mono float32 waveform, sample_rate). Raises on a parse
    error."""
    lib = _require("wav_decode")
    sr = ctypes.c_int(0)
    n = lib.wav_decode(data, len(data), None, 0, ctypes.byref(sr))
    if n < 0:
        raise ValueError("not a parseable RIFF/WAVE file")
    out = np.empty(n, np.float32)
    got = lib.wav_decode(data, len(data), out.ctypes.data_as(_F32), n, ctypes.byref(sr))
    if got != n:
        raise ValueError(f"wav decode failed ({got})")
    return out, sr.value


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample with ``scipy.signal.resample_poly``'s semantics."""
    lib = _require("resample")
    x = np.ascontiguousarray(x, np.float32)
    if sr_in == sr_out:
        return x.copy()
    g = gcd(sr_in, sr_out)
    n_out = (len(x) * (sr_out // g) + (sr_in // g) - 1) // (sr_in // g)
    out = np.empty(n_out, np.float32)
    got = lib.resample_poly(x.ctypes.data_as(_F32), len(x), sr_in, sr_out,
                            out.ctypes.data_as(_F32), n_out)
    if got < 0:
        raise RuntimeError(f"native resample failed ({got})")
    return out[:got]


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8 mu-law codes (equal to
    ``audio_io.mulaw_encode``)."""
    lib = _require("mulaw_encode")
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.uint8)
    lib.mulaw_encode(x.ctypes.data_as(_F32), len(x), out.ctypes.data_as(_U8))
    return out


def mulaw_decode(q: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> float32 (equal to ``audio_io.mulaw_decode``)."""
    lib = _require("mulaw_decode")
    q = np.ascontiguousarray(q, np.uint8)
    out = np.empty(len(q), np.float32)
    lib.mulaw_decode(q.ctypes.data_as(_U8), len(q), out.ctypes.data_as(_F32))
    return out


def _adpcm_encode(name: str, x: np.ndarray, block: int, bits: int) -> np.ndarray:
    lib = _require(name)
    x = np.ascontiguousarray(x, np.int16)
    rows, n = x.shape
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    wire = np.zeros((rows, n * bits // 8 + 3 * (n // block)), np.uint8)
    getattr(lib, name)(x.ctypes.data_as(_I16), rows, n, block, wire.ctypes.data_as(_U8))
    return wire


def adpcm4_encode(x: np.ndarray, block: int) -> np.ndarray:
    """int16 [rows, n] (n a multiple of block) -> the block-interleaved wire
    uint8 [rows, (n / block) * (block / 2 + 3)], bit-identical to
    ``data/adpcm.py``'s numpy encoder (the spec); rows encode on parallel
    threads when the host has cores."""
    return _adpcm_encode("adpcm4_encode", x, block, 4)


def adpcm2_encode(x: np.ndarray, block: int) -> np.ndarray:
    """2-bit twin of :func:`adpcm4_encode`: [rows, (n / block) * (block / 4 + 3)]."""
    return _adpcm_encode("adpcm2_encode", x, block, 2)


class NativeRingBuffer:
    """Streaming sample buffer backed by the C++ ring: push samples, pop
    windows of ``chunk`` samples advancing by ``advance``."""

    def __init__(self):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native audio_ingest unavailable (g++ build failed or missing)")
        self._lib = lib
        self._h = lib.ring_new()

    def push(self, x: np.ndarray):
        x = np.ascontiguousarray(x, np.float32)
        self._lib.ring_push(self._h, x.ctypes.data_as(_F32), len(x))

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    def pop_chunk(self, chunk: int, advance: int) -> Optional[np.ndarray]:
        out = np.empty(chunk, np.float32)
        ok = self._lib.ring_pop_chunk(self._h, out.ctypes.data_as(_F32), chunk, advance)
        return out if ok else None

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_free(self._h)
            self._h = None
