"""HDF5 packing / loading (own copy of ``mla_tpu/data/hdf5.py``).

Layout, the upstream AudioSet packing convention:
  x              [clips, T, 128] uint8-quantized embeddings, f32 waveforms
                 [clips, samples], or f32 patches [clips, T, 96, 64]
  y              [clips, n_classes] bool multi-hot labels
  video_id_list  [clips] bytes
De-quantization of the 8-bit features: (q - 128) / 128 * ``scale``, values
in [-1, 1) at the default scale of 1. h5py is imported lazily; without it,
packing and loading raise ``RuntimeError`` naming it.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except ImportError:
    HAVE_H5PY = False

DEQUANT_SCALE = 1.0


def require_h5py(what: str):
    """The h5py module, or ``RuntimeError`` naming it and ``what``."""
    if not HAVE_H5PY:
        raise RuntimeError(f"h5py unavailable; cannot {what}")
    return h5py


def uint8_to_float32(x: np.ndarray, scale: float = DEQUANT_SCALE) -> np.ndarray:
    """De-quantize 8-bit packed embeddings: (q - 128) / 128 * scale."""
    return ((np.asarray(x, dtype=np.float32) - 128.0) / 128.0) * scale


def float32_to_uint8(x: np.ndarray, scale: float = DEQUANT_SCALE) -> np.ndarray:
    """Quantize to the 8-bit convention. Values outside [-scale, scale)
    saturate; more than 1% of them saturating warns (pass a larger
    ``scale`` to both pack and load for wide features)."""
    x = np.asarray(x, dtype=np.float32)
    clipped = float(np.mean((x < -scale) | (x >= scale)))
    if clipped > 0.01:
        warnings.warn(
            f"float32_to_uint8: {clipped:.1%} of values fall outside "
            f"[-{scale}, {scale}) and will saturate; pass scale= to widen "
            "the quantization range (load with the same scale)",
            stacklevel=2,
        )
    q = np.round(x / scale * 128.0 + 128.0)
    return np.clip(q, 0, 255).astype(np.uint8)


def bool_to_float32(y: np.ndarray) -> np.ndarray:
    return np.asarray(y, dtype=np.float32)


def pack_hdf5(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    video_ids: Optional[np.ndarray] = None,
    quantize: bool = False,
) -> None:
    """Pack (features, labels[, ids]) into the HDF5 layout above."""
    require_h5py("pack HDF5")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if video_ids is None:
        video_ids = np.array([f"clip{i:08d}".encode() for i in range(len(x))])
    with h5py.File(path, "w") as f:
        if quantize:
            f.create_dataset("x", data=float32_to_uint8(x), compression="gzip")
        else:
            f.create_dataset("x", data=np.asarray(x, np.float32), compression="gzip")
        f.create_dataset("y", data=np.asarray(y, bool), compression="gzip")
        f.create_dataset("video_id_list", data=np.asarray(video_ids, dtype="S"))


def load_data(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HDF5 -> (x f32, y f32, video_ids); uint8-packed features are
    de-quantized on load."""
    require_h5py("load HDF5")
    with h5py.File(path, "r") as f:
        x = f["x"][...]
        y = bool_to_float32(f["y"][...])
        ids = f["video_id_list"][...] if "video_id_list" in f else None
    if x.dtype == np.uint8:
        x = uint8_to_float32(x)
    else:
        x = np.asarray(x, np.float32)
    return x, y, ids


def load_many(paths) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate several packs (e.g. bal_train.h5 + unbal_train.h5)."""
    xs, ys, ids = [], [], []
    for p in paths:
        x, y, i = load_data(p)
        xs.append(x)
        ys.append(y)
        ids.append(i)
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(ids)
