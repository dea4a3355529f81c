"""Tracing and timing helpers (counterpart of ``mla_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (host ops, and the card's
kernels and copies on a CUDA host) and writes it as a Chrome / Perfetto
JSON file under its directory; the spans it held are in that file, and it
empties their store when it ends.

``annotate`` is the program's span. It records only while a
``torch.profiler`` runs in the process (``enabled``: the switch the
benchmark's traced run and the ``profile`` verb throw); off, it returns one
shared null context and creates nothing. On, each span keeps its name, an
id, the id of the span open around it on the same thread, the thread,
start and end on ``time.perf_counter_ns`` and integer attributes in an
in-memory store of at most ``MAX_SPANS``, enters ``record_function`` of
the same name (so a trace that covers its thread shows it beside the
kernels it launched), and with a CUDA ``device`` records a pair of timing
events on the current stream, turned into ``device_ms`` only when
``spans`` reads the store. ``record`` adds a span whose start was stamped
earlier; ``clear`` empties the store. Program span names start with
``mla.``. ``recorded`` tells whether the profiler records the calling
thread, where a span's range is also on the trace's timeline; ``OFF`` is
the null span, for a site that records only there.

``sync`` waits for the card; ``time_fn`` times on the host's clock after
such a wait, and ``memory_stats`` reads the caching allocator's byte
counters.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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
    try:
        with profile(activities=activities) as prof:
            yield log_dir
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
    finally:
        clear()  # the spans are in the trace file; their device events go


MAX_SPANS = 1 << 20  # the store keeps the newest spans up to this count
_STORE: collections.deque = collections.deque(maxlen=MAX_SPANS)
_READ = threading.Lock()  # one reader resolves the device events at a time
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .open: this thread's open spans, innermost last


def enabled() -> bool:
    """True while a ``torch.profiler`` runs in the process. The flag is
    process-wide: it reads True on every thread, also those the profiler
    does not record."""
    return _autograd_profiler._is_profiler_enabled


def recorded() -> bool:
    """True where the running profiler records the calling thread's
    operators (a thread-local state: the thread that started it, and the
    autograd threads it hands its state to)."""
    return _autograd_profiler._is_profiler_enabled and torch.autograd._profiler_enabled()


def _open_spans() -> list:
    try:
        return _LOCAL.open
    except AttributeError:
        _LOCAL.open = []
        return _LOCAL.open


def _event(device: torch.device) -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """One span. ``parent`` is the ``id`` of the span open around it on the
    same ``thread`` (``threading.get_native_id``), 0 for none;
    ``start_ns`` and ``end_ns`` are ``time.perf_counter_ns``; ``attrs``
    holds ints or tuples of ints; ``device_ms`` is the card's time between
    the span's two events (None without a CUDA device, or until read)."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "attrs", "device_ms",
                 "_device", "_ev0", "_ev1", "_rf", "_owner", "_boundary")

    def __init__(self, name: str, device, attrs: dict, owner: Optional["Span"] = None):
        self.name, self.attrs, self._owner = name, attrs, owner
        self.id = next(_IDS)
        self.parent, self.thread = 0, threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self.device_ms = None
        dev = None if device is None else torch.device(device)
        self._device = dev if dev is not None and dev.type == "cuda" else None
        self._ev0 = self._ev1 = self._rf = self._boundary = None

    def __enter__(self) -> "Span":
        stack = _open_spans()
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._device is not None:
            owner = self._owner
            self._ev0 = owner._boundary if owner is not None else _event(self._device)
            self._boundary = self._ev0
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._device is not None:
            self._ev1 = _event(self._device)
            if self._owner is not None:
                self._owner._boundary = self._ev1
        self._rf.__exit__(*exc)
        _open_spans().pop()
        self._rf = self._owner = self._boundary = None
        _STORE.append(self)
        return False

    def phase(self, name: str, **attrs) -> "Span":
        """A child span that begins where this span's last phase ended: on
        the card one event ends a phase and begins the next, so N phases in
        a row take N + 1 events (this span's start is the first)."""
        return Span(name, self._device, attrs, owner=self)

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)


class _Off:
    """What ``annotate`` returns while no profiler runs: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def phase(self, name: str, **attrs) -> "_Off":
        return self

    def set(self, **attrs) -> None:
        pass


OFF = _Off()  # the null span: what ``annotate`` returns while off


def annotate(name: str, device=None, **attrs):
    """The program's span around a block (see the module docstring):
    ``with annotate("mla.x", device, key=1) as span: ...``. ``device``: a
    CUDA device adds the card's time between the block's start and end on
    the current stream. Off (no profiler running, or inside a
    ``torch.compile`` / ``torch.export`` trace) it returns a shared null
    context that is falsy and whose ``phase`` and ``set`` do nothing."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return OFF
    return Span(name, device, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Store a span stamped elsewhere (``start_ns`` may come from another
    thread) as the calling thread's, with no parent and no device time;
    nothing while no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    s = Span(name, None, attrs)
    s.start_ns, s.end_ns = start_ns, end_ns
    _STORE.append(s)


def spans(name: Optional[str] = None, since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> List[Span]:
    """Copies of the stored spans named ``name`` (None: every name) that
    begin within [since_ns, until_ns], oldest first. Waits once for each
    card that has events not yet read, and turns them into ``device_ms``."""
    with _READ:
        stored = list(_STORE)
        pending = [s for s in stored if s._ev1 is not None]
        for dev in dict.fromkeys(s._device for s in pending):
            torch.cuda.synchronize(dev)
        for s in pending:
            s.device_ms = s._ev0.elapsed_time(s._ev1)
            s._ev0 = s._ev1 = None
    out = []
    for s in stored:
        if ((name is None or s.name == name) and (since_ns is None or s.start_ns >= since_ns)
                and (until_ns is None or s.start_ns <= until_ns)):
            c = copy.copy(s)
            c.attrs = dict(s.attrs)
            out.append(c)
    return out


def clear() -> None:
    """Empty the store."""
    _STORE.clear()


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


def memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's byte counters of ``device`` (None = the
    current card): ``torch.cuda.memory_stats`` filtered to the keys that
    hold bytes. Empty for a CPU device or on a host without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items() if "bytes" in k}
