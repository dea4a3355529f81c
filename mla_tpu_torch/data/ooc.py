"""Batch gather by row index (own copy of ``take_rows`` from
``mla_tpu/data/ooc.py``; the out-of-core reader itself is not ported,
ROADMAP.md queue A, item 8)."""

from __future__ import annotations

import numpy as np


def take_rows(ds, idx: np.ndarray) -> np.ndarray:
    """Batch-gather for any dataset: one with a ``take`` method routes
    through it, in-RAM arrays fancy-index."""
    take = getattr(ds, "take", None)
    if take is not None:
        return take(idx)
    return ds.x[np.asarray(idx)]
