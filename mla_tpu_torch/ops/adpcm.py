"""ADPCM wire decode on the device (``csrc/adpcm.cu``): the adpcm4 / adpcm2
block wires of ``data/adpcm.py`` -> float32 samples, bit-exact.

The JAX package decodes these wires with a ``lax.scan`` over a block's
samples (``mla_tpu/data/adpcm.py::_decode_jnp``, ``_decode2_jnp``); no Pallas
kernel is involved. The port decodes in one hand-written kernel instead of
a few hundred eager launches per call.

``adpcm_decode`` calls the registered op ``torch.ops.mla_tpu_torch.adpcm_decode``
(``torch.library.custom_op``), so a traced program (``torch.export``,
``serve/export.py``) records the decode as one node. The op's CUDA
implementation launches a kernel (or raises); its CPU implementation is the
plain torch version, ``adpcm_decode_reference``; its fake implementation
gives the output's shape to a trace. Importing this module registers the op,
which is all a loader of an exported program needs. The kernel has two
variants: ``scan`` (each block decoded by up to 32 lanes as a prefix scan
over clamped-add maps) and ``serial`` (one lane per block).
``decode_variant`` picks one from the codes' width and the block, by what
each measured on the card; the pick is the op's string argument.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_VARIANT`` per variant.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mla_tpu_torch.data.adpcm import STEP_TABLE, padded_samples
from mla_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches, for showing a run went through the kernel
LAUNCHES_BY_VARIANT = {"scan": 0, "serial": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"mla_adpcm_decode": [_P, _P, _L, _I, _I, _I, _I, _P],
               "mla_adpcm_decode_scan": [_P, _P, _L, _I, _I, _I, _I, _P]}


def decode_variant(bits: int, block: int) -> str:
    """The kernel a decode of ``bits``-bit codes in ``block``-sample units
    launches. ``scan`` for 4-bit codes in blocks of 256 or more: there it
    beat ``serial`` (14.1 against 15.3 us at [64, 64000], H100). ``serial``
    for the rest: at block 64 it was within 1% of ``scan`` on 4-bit codes read
    from device memory and 7% faster on codes in the L2 cache (where a tick's
    just-uploaded wire is), 12% faster on 2-bit codes, and on 2-bit codes in
    blocks of 256 it was 11% faster (PERF.md has the runs). Between 64 and 256
    nothing was timed."""
    return "scan" if bits == 4 and block >= 256 else "serial"


@functools.lru_cache(maxsize=8)
def _step_table(device: torch.device) -> torch.Tensor:
    """The step table padded to 256 entries with zeros: a header index past
    88 reads step 0, as the JAX decoders' one-hot lookup gives."""
    table = torch.zeros(256, dtype=torch.int32)
    table[:len(STEP_TABLE)] = torch.from_numpy(STEP_TABLE)
    return table.to(device)


def _plan(wire: torch.Tensor, n: Optional[int], block: int, bits: int):
    """(n_pad, n) for a wire [..., W]; raises on what the decode does not take."""
    if wire.dtype != torch.uint8:
        raise TypeError(f"adpcm_decode: wire must be uint8, got {wire.dtype}")
    if bits not in (2, 4):
        raise ValueError(f"adpcm_decode: bits must be 2 or 4, got {bits}")
    if block <= 0 or block % (8 // bits):
        raise ValueError(f"adpcm_decode: block={block} is not a whole number of "
                         f"{bits}-bit code bytes")
    if wire.dim() < 1 or wire.numel() == 0:
        raise ValueError(f"adpcm_decode: wire is empty, shape {tuple(wire.shape)}")
    n_pad = padded_samples(wire.shape[-1], block, bits)
    n = n_pad if n is None else n
    if not 0 < n <= n_pad:
        raise ValueError(f"adpcm_decode: n={n} outside 1..{n_pad}, the samples the wire holds")
    return n_pad, n


def adpcm_decode_reference(wire: torch.Tensor, n: Optional[int] = None, block: int = 256,
                           bits: int = 4) -> torch.Tensor:
    """The kernel's plain torch version: int32 ops vectorised over all rows
    x blocks, a loop over the block's samples (``data/adpcm.py``'s decoder)."""
    n_pad, n = _plan(wire, n, block, bits)
    lead = wire.shape[:-1]
    cb, nb = block * bits // 8, n_pad // block
    u = wire.reshape(-1, nb, cb + 3).to(torch.int32)  # bytes 0..255, no sign to wrap
    pred = u[..., cb] + (u[..., cb + 1] << 8)
    pred = (pred - (pred >= 32768).to(torch.int32) * 65536).reshape(-1)
    index = u[..., cb + 2].reshape(-1)
    packed = u[..., :cb].reshape(-1, cb)
    mask = (1 << bits) - 1
    codes = torch.stack([(packed >> (bits * k)) & mask for k in range(8 // bits)],
                        dim=-1).reshape(-1, block)
    table = _step_table(wire.device)
    out = torch.empty(codes.shape, dtype=torch.int32, device=wire.device)
    for i in range(block):
        code = codes[:, i]
        step = table[index]
        if bits == 4:
            delta = ((step >> 3) + ((code >> 2) & 1) * step + ((code >> 1) & 1) * (step >> 1)
                     + (code & 1) * (step >> 2))
            pred = torch.clamp(pred + torch.where((code & 8) != 0, -delta, delta), -32768, 32767)
            m = code & 7
            index = torch.clamp(index + torch.where(m < 4, -1, 2 * m - 6), 0, 88)
        else:
            mag = code & 1
            delta = (step >> 1) + mag * step
            pred = torch.clamp(pred + torch.where((code & 2) != 0, -delta, delta), -32768, 32767)
            index = torch.clamp(index + torch.where(mag > 0, 2, -1), 0, 88)
        out[:, i] = pred
    out = out.reshape(-1, n_pad)[:, :n]
    return (out.to(torch.float32) / 32768.0).reshape(lead + (n,))


@torch.library.custom_op("mla_tpu_torch::adpcm_decode", mutates_args=(), device_types="cuda")
def _adpcm_decode_op(wire: torch.Tensor, n: int, block: int, bits: int,
                     variant: str) -> torch.Tensor:
    """The op on a CUDA tensor: one launch of the ``variant`` kernel on the
    current stream."""
    global LAUNCHES
    n_pad, n = _plan(wire, n, block, bits)
    if not wire.is_contiguous():
        raise ValueError("adpcm_decode: wire must be contiguous")
    lead = wire.shape[:-1]
    rows = wire.numel() // wire.shape[-1]
    out = torch.empty(lead + (n,), dtype=torch.float32, device=wire.device)
    lib = _build.load("adpcm", _SIGNATURES)
    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        args = (wire.data_ptr(), out.data_ptr(), rows * (n_pad // block), n_pad // block, block,
                n, bits)
        launch = lib.mla_adpcm_decode_scan if variant == "scan" else lib.mla_adpcm_decode
        err = launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"adpcm_decode {variant} kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return out


@_adpcm_decode_op.register_kernel("cpu")
def _adpcm_decode_op_cpu(wire: torch.Tensor, n: int, block: int, bits: int,
                         variant: str) -> torch.Tensor:
    return adpcm_decode_reference(wire, n, block, bits)


@_adpcm_decode_op.register_fake
def _adpcm_decode_op_fake(wire: torch.Tensor, n: int, block: int, bits: int,
                          variant: str) -> torch.Tensor:
    return wire.new_empty(tuple(wire.shape[:-1]) + (n,), dtype=torch.float32)


def adpcm_decode(wire: torch.Tensor, n: Optional[int] = None, block: int = 256,
                 bits: int = 4, *, _variant: Optional[str] = None) -> torch.Tensor:
    """Wire [..., W] uint8 (``block``-sample units of ``bits``-bit codes) ->
    float32 samples [..., n] in [-1, 1] (n=None: every decoded sample),
    through the registered op. A CUDA tensor launches the kernel
    ``decode_variant`` picks on the current stream; a CPU tensor takes the
    plain torch version. ``_variant`` ("scan" or "serial") overrides the
    pick, for timing the variants side by side."""
    if _variant is None:
        _variant = decode_variant(bits, block)
    if _variant not in LAUNCHES_BY_VARIANT:
        raise ValueError(f"unknown variant {_variant!r}; pick from {sorted(LAUNCHES_BY_VARIANT)}")
    _, n = _plan(wire, n, block, bits)
    if wire.device.type not in ("cuda", "cpu"):
        raise ValueError(f"adpcm_decode runs on cuda or cpu, got {wire.device}")
    return torch.ops.mla_tpu_torch.adpcm_decode(wire, n, block, bits, _variant)


def decode_bytes_moved(wire: torch.Tensor, n: int) -> int:
    """Device-memory traffic the decode must make (roofline denominator):
    every wire byte read once and every f32 sample written once."""
    rows = wire.numel() // wire.shape[-1]
    return wire.numel() + 4 * rows * n
