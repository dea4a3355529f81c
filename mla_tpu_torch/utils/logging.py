"""Logging (own copy of ``mla_tpu/utils/logging.py``): a file + stdout
logger per run and a CSV scalar writer for loss / throughput / eval curves,
with an optional TensorBoard event-file sink."""

from __future__ import annotations

import csv
import logging as _logging
import os
import sys
from typing import Dict, Optional


def create_logging(log_dir: str, name: str = "train", filemode: str = "w") -> _logging.Logger:
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
    fh = _logging.FileHandler(path, mode=filemode)
    fh.setFormatter(fmt)
    sh = _logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class ScalarWriter:
    """Append-only CSV scalar log: step, key, value.

    ``tensorboard_dir`` adds a TensorBoard event-file sink
    (``torch.utils.tensorboard.SummaryWriter``, one ``add_scalar`` per key,
    flushed per ``write``); when it does not import, the writer keeps the
    CSV alone and warns, as the reference does without tensorflow."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        new = not os.path.exists(path)
        self._f = open(path, "a", newline="")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(["step", "key", "value"])
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:  # noqa: BLE001 - the sink is optional
                _logging.getLogger("mla_tpu_torch").warning(
                    "tensorboard sink unavailable (%s); CSV only", e)

    def write(self, step: int, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self._w.writerow([step, k, float(v)])
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
