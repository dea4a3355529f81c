"""The program's own spans (``mla_tpu_torch.utils.profiling``) for the
per-layer readers whose source is ``program_span`` or ``program_counter``:
the spans that begin inside a run's traced part (``Tracer.t0`` to
``Tracer.t1``, on the same clock as the spans' ``perf_counter_ns``), and
the statistics the readers take of them. Where the traced part holds none
of a reader's spans (no traced part, or a program that records none), the
reader returns None."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional

from benchmark.core import nearest_rank


def _read(run, name: str, until: bool) -> list:
    tr = run.tracer
    if tr is None or tr.t0 is None or tr.t1 is None:
        return []
    from mla_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)  # absent from a program without spans
    if spans is None:
        return []
    return spans(name, int(tr.t0 * 1e9), int(tr.t1 * 1e9) if until else None)


def traced(run, name: str) -> list:
    """The spans named ``name`` that begin inside the traced part, oldest
    first."""
    return _read(run, name, until=True)


def children(run, parents: Iterable, name: str) -> list:
    """The spans named ``name`` whose parent is one of ``parents``, also
    where they begin after the traced part closed."""
    ids = {p.id for p in parents}
    return [s for s in _read(run, name, until=False) if s.parent in ids] if ids else []


def host_ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def device_ms(spans) -> List[float]:
    """The spans' device times, leaving out spans without one."""
    return [s.device_ms for s in spans if s.device_ms is not None]


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile by nearest rank, None of nothing."""
    return nearest_rank(values, 0.95) if values else None


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
