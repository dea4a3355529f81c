"""k-fold cross-validation (counterpart of ``mla_tpu/train/cv.py``): the
ESC-50 / UrbanSound8K protocol. Train on folds {1..k}\\{i}, evaluate on fold
i, report the mean and standard deviation over i.

One call packs every rotation once (the corpus decoded a single time), runs
``fit`` per held-out fold on ``dataset="hdf5"``, and gathers the final eval
metrics into one summary and ``cv_results.csv``."""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.data.folder import pack_cv_folds
from mla_tpu_torch.train.loop import fit


def cross_validate(
    cfg: Config,
    wav_dir: str,
    labels_csv: str,
    workspace: str,
    folds: Optional[Sequence[int]] = None,
    log: bool = True,
    device=None,
) -> Dict:
    """Run the fold rotation on ``device`` (None = the card; raises without
    one unless device="cpu"); returns {"folds": {i: final eval stats},
    "mean": {...}, "std": {...}, "classes": [...], "csv": path} and writes
    ``workspace/cv_results.csv``.

    ``cfg`` is the per-fold training config; its data section is replaced by
    each rotation's pack pair. ``cfg.model.n_classes`` must equal the
    corpus's class count (checked after packing)."""
    device = resolve_device(device)  # before any host work: no card, no packing
    os.makedirs(workspace, exist_ok=True)
    packs, classes = pack_cv_folds(
        wav_dir, os.path.join(workspace, "packs"), clip_seconds=cfg.data.clip_seconds,
        sample_rate=cfg.frontend.sample_rate, labels_csv=labels_csv, folds=folds)
    if cfg.model.n_classes != len(classes):
        raise ValueError(
            f"config has n_classes={cfg.model.n_classes} but the corpus has "
            f"{len(classes)} classes; --set model.n_classes={len(classes)}")
    per_fold: Dict[int, Dict[str, float]] = {}
    for f, (train_h5, eval_h5) in sorted(packs.items()):
        cfg_f = dataclasses.replace(
            cfg, name=f"{cfg.name}_fold{f}",
            data=dataclasses.replace(cfg.data, dataset="hdf5", hdf5_path=train_h5,
                                     eval_hdf5_path=eval_h5))
        res = fit(cfg_f, workspace=os.path.join(workspace, f"fold{f}"), log=log, device=device)
        if not res.eval_stats:
            raise RuntimeError(f"fold {f} produced no eval stats (num_steps < eval_every?)")
        final = {k: v for k, v in res.eval_stats[-1].items() if k != "step"}
        final["final_loss"] = res.history[-1]["loss"] if res.history else float("nan")
        per_fold[f] = final

    keys = sorted({k for s in per_fold.values() for k in s})
    mean = {k: float(np.mean([s[k] for s in per_fold.values()])) for k in keys}
    std = {k: float(np.std([s[k] for s in per_fold.values()])) for k in keys}

    csv_path = os.path.join(workspace, "cv_results.csv")
    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["fold"] + keys)
        for f in sorted(per_fold):
            w.writerow([f] + [per_fold[f][k] for k in keys])
        w.writerow(["mean"] + [mean[k] for k in keys])
        w.writerow(["std"] + [std[k] for k in keys])

    return {"folds": {int(f): per_fold[f] for f in sorted(per_fold)}, "mean": mean,
            "std": std, "classes": classes, "csv": csv_path}
