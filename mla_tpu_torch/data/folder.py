"""Local wav-folder ingest (own copy of ``mla_tpu/data/folder.py``): pack an
ESC-50 / UrbanSound8K style corpus on disk into the HDF5 layout of
``data/hdf5.py``.

Two labeling conventions:
  - class subdirectories:  root/<class_name>/*.wav
  - a metadata CSV (ESC-50 ``meta/esc50.csv`` style): one row per file with
    a filename column and either a category name column or an integer
    target column; other columns are ignored, and a 'fold' column drives
    the cross-validation protocol.

Output: fixed-length float32 waveforms [N, samples] + bool multi-hot labels
[N, C] + ids, ready for ``DataConfig(dataset="hdf5", hdf5_path=...)``. Clips
are decoded by ``data/audio_io.py::load_wav_16k`` (scipy), resampled to the
front-end's rate and zero-padded or center-cropped to a fixed length.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.data import audio_io, hdf5


def _scan_subdirs(root: str) -> Tuple[List[str], List[str]]:
    """root/<class>/*.wav -> (paths, class name per path)."""
    paths, names = [], []
    for entry in sorted(os.listdir(root)):
        sub = os.path.join(root, entry)
        if not os.path.isdir(sub):
            continue
        for fn in sorted(os.listdir(sub)):
            if fn.lower().endswith(".wav"):
                paths.append(os.path.join(sub, fn))
                names.append(entry)
    return paths, names


def _scan_csv(root: str, labels_csv: str,
              folds: Optional[Sequence[int]] = None) -> Tuple[List[str], List[str]]:
    """Metadata CSV -> (paths, class name per path). Columns: 'filename'
    (or the first column) names the file; 'category' / 'label' / 'class'
    names the class, else an integer 'target' / 'classID' column does.
    ``folds`` keeps only the rows whose integer 'fold' column is in the set
    (train on folds {1..k}\\{i}, evaluate on fold i)."""
    with open(labels_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{labels_csv}: empty metadata CSV")
    cols = rows[0].keys()
    fn_col = next((c for c in cols if c.lower() in ("filename", "file", "slice_file_name")),
                  next(iter(cols)))
    name_col = next((c for c in cols if c.lower() in ("category", "label", "class")), None)
    target_col = next((c for c in cols if c.lower() in ("target", "classid", "class_id")), None)
    fold_col = next((c for c in cols if c.lower() == "fold"), None)
    if name_col is None and target_col is None:
        raise ValueError(
            f"{labels_csv}: need a category/label/class or target/classID column, "
            f"have {sorted(cols)}")
    if folds is not None and fold_col is None:
        raise ValueError(f"{labels_csv}: fold filter given but no 'fold' column")
    # UrbanSound8K nests files under fold directories: list them once
    fold_dirs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    keep = set(int(f) for f in folds) if folds is not None else None
    paths, names = [], []
    for r in rows:
        if keep is not None and int(r[fold_col]) not in keep:
            continue
        p = os.path.join(root, r[fn_col])
        if not os.path.exists(p):
            p = next((os.path.join(root, d, r[fn_col]) for d in fold_dirs
                      if os.path.exists(os.path.join(root, d, r[fn_col]))), p)
        paths.append(p)
        names.append(r[name_col] if name_col else f"class_{int(r[target_col])}")
    return paths, names


def scan_folder(
    root: str, labels_csv: Optional[str] = None,
    folds: Optional[Sequence[int]] = None,
) -> Tuple[List[str], np.ndarray, List[str]]:
    """-> (wav paths, int label per path, sorted class names)."""
    if folds is not None and not labels_csv:
        raise ValueError("fold filtering needs a metadata CSV with a 'fold' column")
    paths, names = _scan_csv(root, labels_csv, folds) if labels_csv else _scan_subdirs(root)
    if not paths:
        raise ValueError(f"no wav files found under {root}"
                         + (f" for folds {sorted(folds)}" if folds else ""))
    if folds is not None:
        # the label space comes from the full CSV: every fold split shares
        # one class indexing even where a fold misses a class
        _, all_names = _scan_csv(root, labels_csv, None)
        classes = sorted(set(all_names))
    else:
        classes = sorted(set(names))
    index: Dict[str, int] = {c: i for i, c in enumerate(classes)}
    y = np.array([index[n] for n in names], np.int64)
    return paths, y, classes


def csv_folds(labels_csv: str) -> List[int]:
    """Distinct 'fold' values of a metadata CSV (the protocol's k)."""
    with open(labels_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    fold_col = next((c for c in (rows[0].keys() if rows else []) if c.lower() == "fold"), None)
    if fold_col is None:
        raise ValueError(f"{labels_csv}: no 'fold' column")
    return sorted({int(r[fold_col]) for r in rows})


def _decode_rows(paths: List[str], y_idx: np.ndarray, n_classes: int,
                 clip_seconds: float, sample_rate: int):
    """Decode and resample the wavs once -> (x [N, samples], y [N, C] bool, ids)."""
    n_samples = int(round(clip_seconds * sample_rate))
    x = np.zeros((len(paths), n_samples), np.float32)
    y = np.zeros((len(paths), n_classes), bool)
    ids = []
    for i, (p, k) in enumerate(zip(paths, y_idx)):
        wav = audio_io.load_wav_16k(p, sample_rate)
        if len(wav) >= n_samples:  # center crop of a long clip
            s = (len(wav) - n_samples) // 2
            x[i] = wav[s : s + n_samples]
        else:
            x[i, : len(wav)] = wav
        y[i, int(k)] = True
        ids.append(os.path.basename(p).encode())
    return x, y, np.asarray(ids, dtype="S")


def pack_cv_folds(
    root: str,
    out_dir: str,
    clip_seconds: float,
    sample_rate: int = 16000,
    labels_csv: Optional[str] = None,
    folds: Optional[Sequence[int]] = None,
) -> Tuple[Dict[int, Tuple[str, str]], List[str]]:
    """Pack every cross-validation rotation in one pass: decode the corpus
    once, then write ``fold{i}_train.h5`` (all other folds) and
    ``fold{i}_eval.h5`` (fold i) per held-out fold i. Returns
    ({fold: (train_path, eval_path)}, class_names)."""
    if not labels_csv:
        raise ValueError("the CV protocol needs a metadata CSV with a 'fold' column")
    all_folds = csv_folds(labels_csv)
    use = sorted(int(f) for f in folds) if folds else all_folds
    unknown = set(use) - set(all_folds)
    if unknown:
        raise ValueError(f"folds {sorted(unknown)} not in CSV (has {all_folds})")
    rows_by_fold = {}
    classes: List[str] = []
    for f in all_folds:
        paths_f, y_f, classes = scan_folder(root, labels_csv, folds=[f])
        rows_by_fold[f] = (paths_f, y_f)
    os.makedirs(out_dir, exist_ok=True)
    dec = {f: _decode_rows(p, y, len(classes), clip_seconds, sample_rate)
           for f, (p, y) in rows_by_fold.items()}
    out: Dict[int, Tuple[str, str]] = {}
    for f in use:
        train = [dec[g] for g in all_folds if g != f]
        tx = np.concatenate([t[0] for t in train])
        ty = np.concatenate([t[1] for t in train])
        tids = np.concatenate([t[2] for t in train])
        tp = os.path.join(out_dir, f"fold{f}_train.h5")
        ep = os.path.join(out_dir, f"fold{f}_eval.h5")
        hdf5.pack_hdf5(tp, tx, ty, tids)
        ex, ey, eids = dec[f]
        hdf5.pack_hdf5(ep, ex, ey, eids)
        out[f] = (tp, ep)
    return out, classes


def pack_folder(
    root: str,
    out_path: str,
    clip_seconds: float,
    sample_rate: int = 16000,
    labels_csv: Optional[str] = None,
    n_classes: Optional[int] = None,
    folds: Optional[Sequence[int]] = None,
) -> Tuple[int, List[str]]:
    """Pack a wav folder into the HDF5 layout; returns (n_clips,
    class_names). ``folds`` selects CSV rows by their 'fold' column; pass
    ``n_classes`` when packing fold subsets so every split shares one label
    space even if a fold misses a class."""
    paths, y_idx, classes = scan_folder(root, labels_csv, folds)
    c = n_classes or len(classes)
    if c < len(classes):
        raise ValueError(f"n_classes={c} < {len(classes)} classes found")
    x, y, ids = _decode_rows(paths, y_idx, c, clip_seconds, sample_rate)
    hdf5.pack_hdf5(out_path, x, y, ids)
    return len(paths), classes
