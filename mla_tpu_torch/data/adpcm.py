"""Block-independent IMA ADPCM wire codecs (own copy of the numpy side of
``mla_tpu/data/adpcm.py``): 4-bit (adpcm4, the serving default) and 2-bit
(adpcm2, the thinnest serving wire; training staging stops at adpcm4).

Blocks of ``block`` samples are coded independently: each self-contained
wire unit is ``[codes block * bits / 8 | pred0 int16-LE | index0]``, so a
stream of units can be sliced at any block boundary and every block decodes
on its own. The encoder resets at each block (predictor = the block's first
sample, step index from the block's mean |first difference|) and shares the
decoder's reconstruction step, all in exact int32 arithmetic.

This module is the host side: the numpy encoders and decoders. The
encoders take the C++ library (``data/native.py``, threaded across rows,
bit-identical) when it is built, as the reference's do. The device
decode is ``mla_tpu_torch.ops.adpcm.adpcm_decode`` (a CUDA kernel, or its
plain torch version for a CPU tensor), bit-identical to the decoders here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mla_tpu_torch.data.audio_io import pcm16_quantize

# IMA/DVI ADPCM tables (the published standard constants)
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], dtype=np.int32)

INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)
INDEX_TABLE_2 = np.array([-1, 2], dtype=np.int32)  # 2-bit: by the magnitude bit

DEFAULT_BLOCK = 256  # training staging
# serving: chunk and hop boundaries (multiples of the 160-sample hop) land
# on whole 64-sample blocks, so the wire is sliced per tick without re-coding
SERVE_BLOCK = 64


def wire_block_bytes(block: int = DEFAULT_BLOCK, bits: int = 4) -> int:
    """Bytes per self-contained wire block (block * bits / 8 codes + 3 header)."""
    return block * bits // 8 + 3


def wire_length(n: int, block: int = DEFAULT_BLOCK, bits: int = 4) -> int:
    """Wire bytes per row for n samples (codes + per-block headers)."""
    return (-(-n // block)) * wire_block_bytes(block, bits)


def wire_bytes_per_sample(block: int = DEFAULT_BLOCK, bits: int = 4) -> float:
    """Wire cost per sample (4-bit: 0.512 at block=256; mu-law is 1.0)."""
    return bits / 8 + 3.0 / block


def padded_samples(w: int, block: int = DEFAULT_BLOCK, bits: int = 4) -> int:
    """Samples a row of ``w`` wire bytes decodes to (whole blocks); raises
    if ``w`` is not a whole number of block units."""
    n_pad = w // wire_block_bytes(block, bits) * block
    if wire_length(n_pad, block, bits) != w:
        raise ValueError(f"wire width {w} is not a whole number of "
                         f"{bits}-bit block={block} groups")
    return n_pad


def _as_int16_rows(x: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """[..., n] float [-1, 1] or int16 -> ([rows, n] int16, leading shape)."""
    x = np.asarray(x)
    return pcm16_quantize(x).reshape(-1, x.shape[-1]), x.shape[:-1]


def _pad_blocks(x: np.ndarray, block: int) -> np.ndarray:
    """Edge-pad the sample axis to a whole number of blocks (diff 0 in the
    pad, so it costs the quantizer nothing)."""
    pad = (-x.shape[-1]) % block
    if pad:
        x = np.concatenate([x, np.repeat(x[:, -1:], pad, axis=1)], axis=1)
    return x


def _init_index(blocks: np.ndarray) -> np.ndarray:
    """Per-block start index: the smallest step >= the block's integer mean
    |first difference|. blocks: [L, B] int32."""
    b = blocks.shape[1]
    if b < 2:
        return np.zeros(blocks.shape[0], np.int32)
    mean_diff = np.abs(np.diff(blocks, axis=1)).sum(axis=1) // (b - 1)
    return np.searchsorted(STEP_TABLE, mean_diff).clip(0, 88).astype(np.int32)


def _encode(x: np.ndarray, block: int, bits: int) -> np.ndarray:
    """Both encoders: the native library's when it is built, else
    :func:`numpy_encode`."""
    from mla_tpu_torch.data import native

    if not native.available():
        return numpy_encode(x, block, bits)
    xi, lead = _as_int16_rows(x)
    enc = native.adpcm4_encode if bits == 4 else native.adpcm2_encode
    return enc(_pad_blocks(xi, block), block).reshape(lead + (-1,))


def numpy_encode(x: np.ndarray, block: int = DEFAULT_BLOCK, bits: int = 4) -> np.ndarray:
    """The numpy encoder (the codec's spec, whether or not the native
    library is built): vectorised over all rows x blocks, a loop over the
    block's samples."""
    xi, lead = _as_int16_rows(x)
    xi = _pad_blocks(xi, block)
    rows, n_pad = xi.shape
    blocks = xi.astype(np.int32).reshape(rows * (n_pad // block), block)  # [L, B]
    pred = blocks[:, 0].copy()
    index = _init_index(blocks)
    pred0, index0 = pred.astype(np.int16), index.astype(np.uint8)
    codes = np.empty(blocks.shape, np.uint8)
    for i in range(block):
        step = STEP_TABLE[index]
        diff = blocks[:, i] - pred
        sign = (diff < 0).astype(np.int32)
        mag = np.abs(diff)
        if bits == 4:
            n3 = (mag >= step).astype(np.int32)
            mag = mag - n3 * step
            h = step >> 1
            n2 = (mag >= h).astype(np.int32)
            mag = mag - n2 * h
            q = step >> 2
            n1 = (mag >= q).astype(np.int32)
            code = (sign << 3) | (n3 << 2) | (n2 << 1) | n1
            # reconstruction feedback: identical to the decoder step
            delta = (step >> 3) + n3 * step + n2 * h + n1 * q
            index = np.clip(index + INDEX_TABLE[code & 7], 0, 88)
        else:
            m = (mag >= step).astype(np.int32)
            code = (sign << 1) | m
            delta = (step >> 1) + m * step
            index = np.clip(index + INDEX_TABLE_2[m], 0, 88)
        codes[:, i] = code
        pred = np.clip(pred + np.where(sign, -delta, delta), -32768, 32767)
    per_byte = 8 // bits  # codes per byte, sample order from the low bits
    packed = np.zeros((blocks.shape[0], block // per_byte), np.uint8)
    for k in range(per_byte):
        packed |= (codes[:, k::per_byte] << (bits * k)).astype(np.uint8)
    wire = np.concatenate([packed, pred0.view(np.uint8).reshape(-1, 2),
                           index0.reshape(-1, 1)], axis=1)
    return wire.reshape(lead + (-1,))


def adpcm4_encode(x: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Encode int16 PCM (or float [-1, 1]) [..., n] -> one uint8 wire
    buffer [..., wire_length(n, block)]."""
    return _encode(x, block, 4)


def adpcm2_encode(x: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Encode int16 PCM (or float [-1, 1]) [..., n] -> one uint8 wire
    buffer [..., wire_length(n, block, bits=2)] (4 codes per byte)."""
    return _encode(x, block, 2)


def _split_wire(wire: np.ndarray, n_pad: int, block: int, bits: int = 4):
    """wire [R, W] -> (packed codes [R, nb, block * bits / 8], pred0 int32
    [R, nb], index0 int32 [R, nb]). The int16 predictor is rebuilt from its
    little-endian byte pair with the sign taken explicitly."""
    nb, cb = n_pad // block, block * bits // 8
    u = wire.reshape(wire.shape[0], nb, cb + 3)
    pred0 = u[:, :, cb].astype(np.int32) + (u[:, :, cb + 1].astype(np.int32) << 8)
    pred0 = pred0 - (pred0 >= 32768) * 65536
    return u[:, :, :cb], pred0, u[:, :, cb + 2].astype(np.int32)


def _decode(wire, n: Optional[int], block: int, bits: int) -> np.ndarray:
    wire = np.asarray(wire, np.uint8)
    n_pad = padded_samples(wire.shape[-1], block, bits)
    if n is not None and n > n_pad:
        raise ValueError(f"n={n} is more than the {n_pad} samples the wire holds")
    lead = wire.shape[:-1]
    wire = wire.reshape(-1, wire.shape[-1])
    packed, pred, index = _split_wire(wire, n_pad, block, bits)
    packed = packed.astype(np.int32)
    mask = (1 << bits) - 1
    codes = np.stack([(packed >> (bits * k)) & mask for k in range(8 // bits)],
                     axis=-1).reshape(-1, block)
    pred, index = pred.reshape(-1), index.reshape(-1)
    out = np.empty(codes.shape, np.int32)
    for i in range(block):
        code = codes[:, i]
        step = STEP_TABLE[index]
        if bits == 4:
            delta = (step >> 3) + ((code >> 2) & 1) * step \
                + ((code >> 1) & 1) * (step >> 1) + (code & 1) * (step >> 2)
            pred = np.clip(pred + np.where(code & 8, -delta, delta), -32768, 32767)
            index = np.clip(index + INDEX_TABLE[code & 7], 0, 88)
        else:
            mag = code & 1
            delta = (step >> 1) + mag * step
            pred = np.clip(pred + np.where(code & 2, -delta, delta), -32768, 32767)
            index = np.clip(index + INDEX_TABLE_2[mag], 0, 88)
        out[:, i] = pred
    out = out.reshape(wire.shape[0], n_pad)[:, :n]
    return (out.astype(np.float32) / 32768.0).reshape(lead + (out.shape[-1],))


def adpcm4_decode(wire: np.ndarray, n: Optional[int] = None,
                  block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Wire buffer [..., W] -> float32 waveform [..., n] in [-1, 1] on the
    host; ``n`` slices off block padding (default: all decoded samples)."""
    return _decode(wire, n, block, 4)


def adpcm2_decode(wire: np.ndarray, n: Optional[int] = None,
                  block: int = DEFAULT_BLOCK) -> np.ndarray:
    """2-bit twin of ``adpcm4_decode``."""
    return _decode(wire, n, block, 2)
