"""Out-of-core HDF5 dataset source (own copy of ``mla_tpu/data/ooc.py``):
training sets too large for host memory stream from disk, a batch at a time.

  - ``HDF5ColumnReader``: a lazy, picklable view of one HDF5 dataset. The
    file opens on first access in each process (an h5py handle cannot cross
    a fork or a pickle), so one object serves the training loop and the
    ``DataLoader`` workers of ``data/pipeline.py``; a process that finds a
    handle its parent opened drops it and opens its own.
  - ``MultiColumnReader``: several packs' columns concatenated along rows.
  - ``OutOfCoreDataset``: the ``ArrayDataset``-shaped triple with ``x``
    behind a reader. Labels stay in RAM: the balanced sampler needs the
    whole label matrix, and at AudioSet scale y is ~1 GB of bool against
    ~640 GB of waveforms.
  - ``take``: a random batch (unsorted, with duplicates) read as one sorted
    unique read, rows scattered back to the requested order.

``train/loop.py`` encodes each batch to the staging wire after the read, so
the disk-to-host copy is the packed f32 / uint8 and host-to-device the
configured ``data.staging_dtype``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from mla_tpu_torch.data import hdf5 as _h5


class HDF5ColumnReader:
    """Lazy per-process view of one HDF5 dataset (column). Reads return the
    rows asked for and nothing more; uint8-packed features are de-quantized
    per read."""

    def __init__(self, path: str, key: str = "x"):
        self.path = os.path.abspath(path)
        self.key = key
        self._d = None  # opened lazily, per process
        self._pid = None
        h5py = _h5.require_h5py("read HDF5")
        with h5py.File(self.path, "r") as f:
            d = f[key]
            self.shape: Tuple[int, ...] = tuple(d.shape)
            self._raw_dtype = d.dtype
        self.dtype = np.dtype(np.float32)

    # pickling sends (path, key); the receiving process opens its own handle
    def __reduce__(self):
        return (HDF5ColumnReader, (self.path, self.key))

    def _dataset(self):
        if self._d is None or self._pid != os.getpid():
            # a forked child inherits the parent's handle: never read through it
            h5py = _h5.require_h5py("read HDF5")
            self._d = h5py.File(self.path, "r")[self.key]
            self._pid = os.getpid()
        return self._d

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        # the logical f32 size (what loading it would cost): the number the
        # training loop budgets device residency against
        return int(np.prod(self.shape)) * 4

    def __len__(self) -> int:
        return self.shape[0]

    def _post(self, rows: np.ndarray) -> np.ndarray:
        if self._raw_dtype == np.uint8:
            return _h5.uint8_to_float32(rows)
        return np.asarray(rows, np.float32)

    def __getitem__(self, idx) -> np.ndarray:
        """Scalar ints, slices and increasing index arrays (h5py's
        contract); arbitrary batches go through ``OutOfCoreDataset.take``."""
        return self._post(self._dataset()[idx])


class MultiColumnReader:
    """Several packs' columns concatenated along rows (sharded packs, e.g.
    bal_train + unbal_train: ``load_many`` without loading anything). The
    same lazy, picklable contract as ``HDF5ColumnReader``; indices are split
    per file with ``searchsorted``, so an increasing batch stays one sorted
    read per file it touches."""

    def __init__(self, paths, key: str = "x"):
        if not paths:
            raise ValueError("MultiColumnReader needs at least one pack")
        self.readers = [HDF5ColumnReader(p, key) for p in paths]
        tails = {r.shape[1:] for r in self.readers}
        if len(tails) != 1:
            raise ValueError(f"packs disagree on row shape: {sorted(tails)}")
        rows = [r.shape[0] for r in self.readers]
        self._offsets = np.cumsum([0] + rows)
        self.shape: Tuple[int, ...] = (int(self._offsets[-1]),) + self.readers[0].shape[1:]
        self.dtype = np.dtype(np.float32)

    def __reduce__(self):
        return (MultiColumnReader, ([r.path for r in self.readers], self.readers[0].key))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * 4

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(len(self)), dtype=np.int64)
        elif np.isscalar(idx) or getattr(idx, "ndim", None) == 0:
            f = int(np.searchsorted(self._offsets, int(idx), "right")) - 1
            return self.readers[f][int(idx) - int(self._offsets[f])]
        idx = np.asarray(idx, np.int64)
        out = []
        for f, r in enumerate(self.readers):
            lo, hi = self._offsets[f], self._offsets[f + 1]
            m = (idx >= lo) & (idx < hi)
            if m.any():
                out.append(r[idx[m] - lo])  # still increasing within the file
        return np.concatenate(out) if out else np.zeros((0,) + self.shape[1:], np.float32)


class OutOfCoreDataset:
    """ArrayDataset-shaped triple whose x streams from disk. ``path`` is one
    pack or a list of packs (rows concatenated in order)."""

    def __init__(self, path):
        paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
        self.x = (HDF5ColumnReader(paths[0], "x") if len(paths) == 1
                  else MultiColumnReader(paths, "x"))
        h5py = _h5.require_h5py("read HDF5")
        ys, ids = [], []
        for p in paths:
            with h5py.File(p, "r") as f:
                ys.append(_h5.bool_to_float32(f["y"][...]))
                ids.append(f["video_id_list"][...] if "video_id_list" in f else None)
        self.y = np.concatenate(ys) if len(ys) > 1 else ys[0]
        self.ids = (np.concatenate(ids)
                    if len(ids) > 1 and all(i is not None for i in ids) else ids[0])
        k = {2: "waveform", 3: "features", 4: "patches"}.get(self.x.ndim)
        if k is None:
            raise ValueError(f"unrecognized packed feature rank {self.x.ndim}")
        self.kind = k

    def take(self, idx: np.ndarray) -> np.ndarray:
        """Random-order (possibly duplicated) batch read: one sorted unique
        read, rows scattered back to the requested order."""
        idx = np.asarray(idx, np.int64)
        uniq, inverse = np.unique(idx, return_inverse=True)
        return self.x[uniq][inverse]


def take_rows(ds, idx: np.ndarray) -> np.ndarray:
    """Batch-gather for any dataset: one with a ``take`` method routes
    through it, in-RAM arrays fancy-index."""
    take = getattr(ds, "take", None)
    if take is not None:
        return take(idx)
    return ds.x[np.asarray(idx)]


def generate_synthetic_pack(
    path: str,
    n_clips: int,
    n_classes: int,
    clip_seconds: float = 10.0,
    sample_rate: int = 16000,
    seed: int = 0,
    rows_per_write: int = 256,
    multi_label: bool = True,
) -> int:
    """Write a synthetic waveform pack incrementally (never more than
    ``rows_per_write`` clips in RAM); returns the bytes on disk.
    Uncompressed, one row per chunk: HDF5 reads whole chunks and training
    reads rows at random, so a multi-row chunk would read a whole write
    block from disk per sampled clip. Each write block is seeded by its first
    row, so any block regenerates on its own."""
    from mla_tpu_torch.data.synthetic import synth_waveforms

    h5py = _h5.require_h5py("write HDF5")
    n_samples = int(round(clip_seconds * sample_rate))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        dx = f.create_dataset("x", shape=(n_clips, n_samples), dtype=np.float32,
                              chunks=(1, n_samples))
        dy = f.create_dataset("y", shape=(n_clips, n_classes), dtype=bool)
        ids = []
        for s in range(0, n_clips, rows_per_write):
            e = min(s + rows_per_write, n_clips)
            xw, yw = synth_waveforms(e - s, n_classes, clip_seconds, sample_rate,
                                     multi_label=multi_label, seed=seed + s)
            dx[s:e] = xw
            dy[s:e] = yw.astype(bool)
            ids.extend(f"ooc{j:09d}".encode() for j in range(s, e))
        f.create_dataset("video_id_list", data=np.asarray(ids, dtype="S"))
    return os.path.getsize(path)
