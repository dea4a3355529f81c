"""Tracing and timing helpers (counterpart of ``mla_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (host ops, and the card's
kernels and copies on a CUDA host) and writes it as a Chrome / Perfetto
JSON file under its directory; ``annotate`` names a region inside it
(``record_function``). ``sync`` waits for the card; ``time_fn`` and
``StepTimer`` time on the host's clock after such a wait, and
``memory_stats`` reads the caching allocator's byte counters.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written on exit to
    ``<log_dir>/trace_<time>_<pid>.json`` (Chrome / Perfetto format); the
    default directory is ``mla_tpu_torch_trace`` in the temporary directory.
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mla_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def annotate(name: str):
    """Named region inside a trace (a span on the profiler's timeline)."""
    return torch.profiler.record_function(name)


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree: Any) -> Any:
    """Wait until the card has finished the work that produced ``tree``'s
    tensors (``torch.cuda.synchronize`` when one lies on a CUDA device);
    returns ``tree``."""
    if any(t.is_cuda for t in _leaves(tree)):
        torch.cuda.synchronize()
    return tree


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Dict[str, float]:
    """Host wall time of ``iters`` calls of ``fn(*args)``, issued back to back
    and synchronized once at the end, after ``warmup`` synchronized calls."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    sync(outs)
    total = time.perf_counter() - t0
    return {
        "mean_ms": total / iters * 1e3,
        "total_s": total,
        "iters_per_sec": iters / total,
    }


@dataclass
class StepTimer:
    """Rolling train-loop throughput meter (clips per second, step latency)."""

    window: int = 50
    _times: List[float] = field(default_factory=list)
    _items: List[int] = field(default_factory=list)
    _last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def step(self, n_items: int):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._items.append(n_items)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._items.pop(0)
        self._last = now

    @property
    def items_per_sec(self) -> float:
        t = sum(self._times)
        return sum(self._items) / t if t > 0 else 0.0

    @property
    def mean_step_ms(self) -> float:
        return 1e3 * sum(self._times) / len(self._times) if self._times else 0.0


def memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's byte counters of ``device`` (None = the
    current card): ``torch.cuda.memory_stats`` filtered to the keys that
    hold bytes. Empty for a CPU device or on a host without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items() if "bytes" in k}
