"""Class-balanced minibatch sampling (own copy of ``mla_tpu/data/sampler.py``;
the tests hold its index streams and ``state_dict`` equal to the reference's).

Deterministic and resumable with O(n_classes) state: every permutation is a
pure function of ``(seed, stream, epoch)``: the class round-robin order of
``(seed, 1, order_epoch)`` and each class-k clip order of ``(seed, 2, k,
epoch_k)``. A checkpoint stores only per-class ``(epoch, cursor)`` pairs and
permutations are regenerated on demand.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class BalancedSampler:
    """Round-robin over classes; within a class, draw clips from a seeded
    permutation, reshuffling independently per class when exhausted."""

    def __init__(self, y: np.ndarray, batch_size: int, seed: int = 0):
        if y.ndim != 2:
            raise ValueError(f"labels must be [clips, classes], got {y.shape}")
        self.y = np.asarray(y, bool)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.n_clips, self.n_classes = self.y.shape
        self.class_indices = [np.nonzero(self.y[:, k])[0] for k in range(self.n_classes)]
        self.valid_classes = np.array(
            [k for k, idx in enumerate(self.class_indices) if len(idx)], dtype=np.int64
        )
        if len(self.valid_classes) == 0:
            raise ValueError("no class has any positive clip")
        self._reset()

    def _reset(self):
        self.step = 0
        self._order_epoch = 0
        self._class_cursor = 0
        self._epochs: Dict[int, int] = {}   # class -> permutation epoch
        self._cursors: Dict[int, int] = {}  # class -> position in that epoch
        self._perm_cache: Dict[int, tuple] = {}  # class -> (epoch, perm)
        self._order = self._make_order(self._order_epoch)

    # --- counter-based permutation streams (pure functions of the seed) ---

    def _make_order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng(
            [self.seed, 1, epoch]).permutation(self.valid_classes)

    def _class_perm(self, k: int, epoch: int) -> np.ndarray:
        cached = self._perm_cache.get(k)
        if cached is None or cached[0] != epoch:
            perm = np.random.default_rng(
                [self.seed, 2, k, epoch]).permutation(self.class_indices[k])
            self._perm_cache[k] = (epoch, perm)
            return perm
        return cached[1]

    def _next_from_class(self, k: int) -> int:
        epoch = self._epochs.get(k, 0)
        cur = self._cursors.get(k, 0)
        if cur >= len(self.class_indices[k]):
            epoch += 1
            self._epochs[k] = epoch
            cur = 0
        perm = self._class_perm(k, epoch)
        self._cursors[k] = cur + 1
        return int(perm[cur])

    def _next_class(self) -> int:
        if self._class_cursor >= len(self._order):
            self._order_epoch += 1
            self._order = self._make_order(self._order_epoch)
            self._class_cursor = 0
        k = int(self._order[self._class_cursor])
        self._class_cursor += 1
        return k

    def next_batch(self) -> np.ndarray:
        """Indices of the next balanced batch."""
        idx = np.empty(self.batch_size, dtype=np.int64)
        for i in range(self.batch_size):
            idx[i] = self._next_from_class(self._next_class())
        self.step += 1
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()

    def state_dict(self) -> Dict:
        """Full sampler state as JSON-safe plain ints: seed, step, the
        class-order (epoch, cursor) and per-class (epoch, cursor) pairs."""
        return {
            "version": 3,
            "seed": self.seed,
            "step": self.step,
            "order_epoch": self._order_epoch,
            "class_cursor": self._class_cursor,
            "epochs": {str(k): int(v) for k, v in self._epochs.items()},
            "cursors": {str(k): int(v) for k, v in self._cursors.items()},
        }

    def load_state_dict(self, state: Dict):
        """Restore exactly where a run left off, in O(1), from a version-3
        state (the only version this package writes)."""
        if int(state.get("version", 1)) != 3:
            raise ValueError(f"sampler state version {state.get('version')!r}: only "
                             "version 3 (counter-based streams) is read")
        self.seed = int(state["seed"])
        self._reset()
        self.step = int(state["step"])
        self._order_epoch = int(state["order_epoch"])
        self._class_cursor = int(state["class_cursor"])
        self._order = self._make_order(self._order_epoch)
        self._epochs = {int(k): int(v) for k, v in state["epochs"].items()}
        self._cursors = {int(k): int(v) for k, v in state["cursors"].items()}


class SequentialSampler:
    """Plain eval-order batching."""

    def __init__(self, n_clips: int, batch_size: int):
        self.n_clips = n_clips
        self.batch_size = batch_size

    def __iter__(self):
        for s in range(0, self.n_clips, self.batch_size):
            yield np.arange(s, min(s + self.batch_size, self.n_clips))
