"""AudioSet bottleneck-feature packer (own copy of ``mla_tpu/data/audioset.py``).

AudioSet's release is TFRecords of per-second 128-d quantized VGGish
embeddings as ``tf.SequenceExample``: context ``video_id`` / ``labels``,
feature list ``audio_embedding`` of 10 uint8[128] frames. This module packs
them into the HDF5 layout of ``data/hdf5.py`` (``prep --tfrecords``).

TensorFlow serves only as the file reader, imported when a function here
needs it; everything downstream reads the HDF5 pack.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.data import hdf5 as _h5


def _require_tf():
    try:
        import tensorflow as tf

        return tf
    except ImportError as e:
        raise RuntimeError("tensorflow is required to read AudioSet TFRecords") from e


def read_sequence_examples(
    tfrecord_paths: Sequence[str],
    n_classes: int = 527,
    max_frames: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TFRecords of SequenceExamples -> (x uint8 [N, T, 128], y bool
    [N, n_classes], video_ids bytes [N]). Clips shorter than ``max_frames``
    are edge-padded (the last frame repeated), longer ones truncated: the
    upstream packing convention for fixed [N, 10, 128] tensors."""
    tf = _require_tf()
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    ids: List[bytes] = []
    for path in tfrecord_paths:
        for raw in tf.data.TFRecordDataset(path):
            ex = tf.train.SequenceExample()
            ex.ParseFromString(raw.numpy())
            ctx = ex.context.feature
            vid = ctx["video_id"].bytes_list.value[0] if "video_id" in ctx else b"?"
            labels = list(ctx["labels"].int64_list.value) if "labels" in ctx else []
            frames = [
                np.frombuffer(f.bytes_list.value[0], dtype=np.uint8)
                for f in ex.feature_lists.feature_list["audio_embedding"].feature
            ]
            if not frames:
                continue
            arr = np.stack(frames)[:max_frames]
            if arr.shape[0] < max_frames:  # edge-pad short clips
                pad = np.repeat(arr[-1:], max_frames - arr.shape[0], axis=0)
                arr = np.concatenate([arr, pad])
            y = np.zeros(n_classes, bool)
            y[[lab for lab in labels if lab < n_classes]] = True
            xs.append(arr)
            ys.append(y)
            ids.append(vid)
    if not xs:
        raise ValueError(f"no SequenceExamples found in {list(tfrecord_paths)}")
    return np.stack(xs), np.stack(ys), np.asarray(ids, dtype="S")


def pack_audioset(
    tfrecord_glob: str,
    out_path: str,
    n_classes: int = 527,
    max_frames: int = 10,
) -> int:
    """Pack a TFRecord shard glob (e.g. ``bal_train/*.tfrecord``) into the
    HDF5 layout. Features stay uint8 (de-quantized on load by
    ``data.hdf5.load_data``). Returns the clip count."""
    paths = sorted(_glob.glob(tfrecord_glob))
    if not paths:
        raise FileNotFoundError(f"no tfrecords match {tfrecord_glob!r}")
    x, y, ids = read_sequence_examples(paths, n_classes, max_frames)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    h5py = _h5.require_h5py("pack AudioSet")
    with h5py.File(out_path, "w") as f:
        f.create_dataset("x", data=x, compression="gzip")  # uint8, pre-quantized
        f.create_dataset("y", data=y, compression="gzip")
        f.create_dataset("video_id_list", data=ids)
    return len(x)


def write_sequence_examples(
    path: str,
    x_uint8: np.ndarray,
    labels: Sequence[Sequence[int]],
    video_ids: Optional[Sequence[bytes]] = None,
):
    """Write SequenceExamples in the AudioSet release format (a test fixture
    and export utility)."""
    tf = _require_tf()
    with tf.io.TFRecordWriter(path) as w:
        for i, clip in enumerate(x_uint8):
            ex = tf.train.SequenceExample()
            vid = video_ids[i] if video_ids is not None else f"vid{i:06d}".encode()
            ex.context.feature["video_id"].bytes_list.value.append(vid)
            ex.context.feature["labels"].int64_list.value.extend(labels[i])
            fl = ex.feature_lists.feature_list["audio_embedding"]
            for frame in clip:
                fl.feature.add().bytes_list.value.append(frame.tobytes())
            w.write(ex.SerializeToString())
