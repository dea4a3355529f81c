"""The stateless balanced input pipeline (counterpart of
``mla_tpu/data/pipeline.py``), on a torch ``DataLoader`` in place of grain.

Two layers, as in the reference:
  - ``balanced_index_dataset``: an unbounded, indexable stream of clip
    indices whose distribution is class-balanced, a pure function of (seed,
    position): position p takes class row ``p mod n_valid`` of a per-epoch
    permutation drawn by ``np.random.default_rng((seed, 1, epoch))`` and a
    clip of that class drawn by ``np.random.default_rng((seed, 2, p))``, the
    reference's generators, so the stream equals grain's index for index.
    Any worker or restart reads the same stream; there is no sampler state.
  - ``make_train_iterator``: positions -> gathered (x, y) batches, one
    ``DataLoader`` item per batch (workers keep the order), resumable in
    O(1) from a global batch index and sliceable across hosts.
"""

from __future__ import annotations

import multiprocessing
from typing import Iterator, Tuple

import numpy as np
import torch.utils.data

from mla_tpu_torch.data.ooc import take_rows
from mla_tpu_torch.data.synthetic import ArrayDataset

_UNBOUNDED = 2 ** 62  # the stream's length: positions never run out


def _per_class_tables(y: np.ndarray):
    """Dense [n_valid, max_count] clip table of the classes that have a
    positive clip, and each row's count, for O(1) lookups."""
    class_indices = [np.nonzero(y[:, k])[0] for k in range(y.shape[1])]
    valid = np.array([k for k, idx in enumerate(class_indices) if len(idx)], np.int64)
    if len(valid) == 0:
        raise ValueError("no class has any positive clip")
    max_n = max(len(class_indices[k]) for k in valid)
    table = np.zeros((len(valid), max_n), np.int64)
    counts = np.zeros(len(valid), np.int64)
    for row, k in enumerate(valid):
        idx = class_indices[k]
        table[row, : len(idx)] = idx
        counts[row] = len(idx)
    return table, counts


class BalancedIndexStream:
    """Clip index at each position of the balanced stream, from
    ``start_position`` on: ``stream[i]`` is position ``start_position + i``.
    Its content at a position does not depend on where reading started."""

    def __init__(self, y: np.ndarray, seed: int = 0, start_position: int = 0):
        self.table, self.counts = _per_class_tables(y)
        self.seed, self.start = seed, start_position

    def index_at(self, p: int) -> int:
        """The clip index at absolute position ``p``."""
        epoch, slot = divmod(p, len(self.counts))
        class_perm = np.random.default_rng((self.seed, 1, epoch)).permutation(len(self.counts))
        row = int(class_perm[slot])
        draw = int(np.random.default_rng((self.seed, 2, p)).integers(0, self.counts[row]))
        return int(self.table[row, draw])

    def __getitem__(self, i: int) -> int:
        return self.index_at(self.start + int(i))


def balanced_index_dataset(y: np.ndarray, seed: int = 0,
                           start_position: int = 0) -> BalancedIndexStream:
    """The unbounded class-balanced index stream from ``start_position``
    (resuming there is O(1)); slicing it by position shards it across
    hosts."""
    return BalancedIndexStream(y, seed, start_position)


class _Batches(torch.utils.data.Dataset):
    """Item k: this host's slice of global batch ``start_index + k``, as
    (x [per_host, ...], y [per_host, C]) numpy arrays."""

    def __init__(self, ds: ArrayDataset, batch_size: int, seed: int, start_index: int,
                 host_index: int, host_count: int):
        self.ds = ds
        self.stream = BalancedIndexStream(ds.y, seed)
        self.batch_size, self.start = batch_size, start_index
        self.per_host = batch_size // host_count
        self.offset = host_index * self.per_host

    def __len__(self) -> int:
        return _UNBOUNDED // self.batch_size - self.start

    def positions(self, k: int) -> range:
        """Global positions of item k: the host's contiguous slice of its
        global batch."""
        base = (self.start + k) * self.batch_size + self.offset
        return range(base, base + self.per_host)

    def __getitem__(self, k: int):
        idx = np.array([self.stream.index_at(p) for p in self.positions(int(k))], np.int64)
        return take_rows(self.ds, idx), self.ds.y[idx]


def _as_is(item):
    return item


def make_train_iterator(
    ds: ArrayDataset,
    batch_size: int,
    seed: int = 0,
    workers: int = 0,
    start_index: int = 0,
    host_index: int = 0,
    host_count: int = 1,
    read_buffer_batches: int = 4,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Unbounded (x, y) batch iterator with balanced classes.

    ``workers`` > 0 gathers batches in that many ``DataLoader`` worker
    processes, spawned (a fresh interpreter each, the dataset pickled to it:
    forking a process that runs CUDA and other threads is unsafe; an
    out-of-core reader pickles as its path and opens the pack there), each
    running ``read_buffer_batches`` batches ahead (the order stays the
    stream's). ``start_index`` (in global batches) resumes in O(1): the
    stream is a pure function of absolute position. With
    ``host_count`` H, host h yields the h-th contiguous ``batch_size / H``
    slice of every global batch, so the hosts' step-s slices concatenate to
    the unsharded stream's batch s. Closing the iterator stops the workers.
    """
    if batch_size % host_count:
        raise ValueError(f"batch_size {batch_size} not divisible by {host_count} hosts")
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    batches = _Batches(ds, batch_size, seed, start_index, host_index, host_count)
    loader = torch.utils.data.DataLoader(
        batches, batch_size=None, shuffle=False, num_workers=workers, collate_fn=_as_is,
        prefetch_factor=max(1, read_buffer_batches) if workers else None,
        multiprocessing_context=multiprocessing.get_context("spawn") if workers else None)
    it = iter(loader)
    try:
        for x, y in it:
            yield x, y
    finally:
        del it  # shuts the workers down


def class_histogram(y: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Diagnostic: per-class positive counts in a drawn index set."""
    return y[indices].sum(axis=0)
