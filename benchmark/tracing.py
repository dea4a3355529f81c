"""The traced window: ``torch.profiler`` over the CPU and the card, reduced
to what the per-layer readers and the result's ``breakdown`` take: the union
of the device's busy intervals, device time by kernel name, and the longest
idle gaps labelled by what the host was doing (the benchmark's own
``record_function`` spans first, else the host operator running)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

# the spans the benchmark's own files put around their calls into the program
SPANS = ("generate", "feed", "scores", "step", "gather", "forward")
WINDOW = "traced_window"  # the span that marks the traced part on the profiler's clock


def span(name: str, on: bool):
    """A ``record_function`` span when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Tracer:
    """Switch the profiler on and off and mark the traced part of a window
    on its clock; ``summary`` holds the reduction once it is off."""

    def __init__(self):
        self.prof = None
        self.started = False
        self.t0 = self.t1 = self.start_s = None
        self.summary: Optional[Dict] = None
        self._mark = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        on_card = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        return profile(activities=[ProfilerActivity.CPU] + on_card)

    def warm_up(self, device):
        """Start and stop a profiler once around one small operation, in
        set-up: the first start of a process initializes the device
        tracing, which takes seconds and holds the interpreter meanwhile."""
        prof = self._profile()
        prof.start()
        (torch.ones(1, device=device) + 1).sum().item()
        prof.stop()

    def begin(self):
        """Switch the profiler on (nothing counts until ``open``)."""
        self.prof = self._profile()
        self.prof.start()

    def open(self):
        """Open the traced part: the span ``WINDOW`` marks it on the
        profiler's clock."""
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.started = True
        self.t0 = time.perf_counter()

    def close(self):
        """Close the traced part once the card has finished its work."""
        _sync()
        self.t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)

    def end(self):
        """Switch the profiler off and reduce what it recorded."""
        self.prof.stop()
        self.summary = summarize(self.prof)
        self.prof = None

    def start(self):
        """``begin`` and ``open`` in a loop that only this thread drives:
        first wait for the card, so that no kernel launched before runs,
        unrecorded, inside the traced part."""
        t = time.perf_counter()
        _sync()
        self.begin()
        self.open()
        self.start_s = self.t0 - t


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


# host calls that only wait for the card: a gap is labelled by one only when
# nothing else was running on the host
_WAITS = ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "Memcpy")


def _label(host: List[Tuple[float, float, str]], t: float) -> str:
    """What the host was doing at ``t``: the benchmark spans open then, else
    the host operator begun last of those open then that does not only wait
    for the card, else such a wait, else "none"."""
    open_ = [(s, n) for s, e, n in host if s <= t < e]
    spans = sorted({n for _, n in open_ if n in SPANS})
    if spans:
        return "+".join(spans)
    work = [x for x in open_ if not x[1].startswith(_WAITS)]
    return max(work or open_)[1] if open_ else "none"


def _annotation(ev) -> bool:
    """A span's or the profiler's own mark on the device timeline, not work."""
    return (getattr(ev, "is_user_annotation", False) or ev.name in SPANS + (WINDOW,)
            or ev.name.startswith("ProfilerStep"))


def summarize(prof) -> Dict:
    """busy_s, window_s, device seconds by kernel name, and the ten
    longest idle gaps of the traced window (the host span ``WINDOW``), all on
    the profiler's clock."""
    events = prof.events()
    marks = [ev for ev in events if ev.name == WINDOW
             and ev.device_type != torch.autograd.DeviceType.CUDA]
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    window_us = hi - lo
    dev, host = [], []
    for ev in events:
        s, e = ev.time_range.start - lo, ev.time_range.end - lo
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not _annotation(ev) and e > 0 and s < window_us:
                dev.append((max(s, 0.0), min(e, window_us), ev.name))
        elif ev.name != WINDOW:
            host.append((s, e, ev.name))
    busy = _merge([(s, e) for s, e, _ in dev])
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    edges = [0.0] + [x for iv in busy for x in iv] + [window_us]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": window_us / 1e6,
        "by_name": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_label(host, t), g / 1e6] for g, t in gaps[:10]],
    }


def idle_percent(run) -> Optional[float]:
    """The share of a run's traced window with nothing on the card, in %."""
    s = run.tracer.summary if run.tracer is not None else None
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def kernel_seconds(summary: Dict, symbol: str) -> float:
    """Device seconds of every kernel whose name holds ``symbol``."""
    return sum(v for k, v in summary["by_name"].items() if symbol in k)
