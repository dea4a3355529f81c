"""How late the load generator handed the window's pieces over, against
their schedule: the 95th percentile, by nearest rank, in ms."""

from benchmark.core import nearest_rank


def read(run):
    v = run.counters.get("gen_late_ms")
    return nearest_rank(v, 0.95) if v else None
