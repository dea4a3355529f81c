"""Logging (own copy of ``mla_tpu/utils/logging.py``): a file + stdout
logger per run and a CSV scalar writer for loss / throughput / eval curves.
The TensorBoard sink is not ported (ROADMAP.md queue A, item 8)."""

from __future__ import annotations

import csv
import logging as _logging
import os
import sys
from typing import Dict, Optional


def create_logging(log_dir: str, name: str = "train") -> _logging.Logger:
    """File + stdout logger, one numbered file per run (logs/0000.log,
    incrementing)."""
    os.makedirs(log_dir, exist_ok=True)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f"{i:04d}.log")):
        i += 1
    path = os.path.join(log_dir, f"{i:04d}.log")
    logger = _logging.getLogger(f"mla_tpu_torch.{name}.{i}")
    logger.setLevel(_logging.DEBUG)
    logger.handlers.clear()
    fmt = _logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = _logging.FileHandler(path, mode="w")
    fh.setFormatter(fmt)
    sh = _logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class ScalarWriter:
    """Append-only CSV scalar log: step, key, value."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "train.tensorboard is not ported yet (ROADMAP.md queue A, item 8: TensorBoard)")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        new = not os.path.exists(path)
        self._f = open(path, "a", newline="")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(["step", "key", "value"])

    def write(self, step: int, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self._w.writerow([step, k, float(v)])
        self._f.flush()

    def close(self):
        self._f.close()
