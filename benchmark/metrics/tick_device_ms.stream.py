"""The card's time per tick: the device time of the tick's upload and of
its step (the program's ``mla.tick.upload`` and ``mla.tick.step`` spans
under each ``mla.tick``), summed per tick; the median over ticks, in ms."""

from collections import defaultdict

from benchmark import program_spans as ps


def read(run):
    ticks = ps.traced(run, "mla.tick")
    per_tick = defaultdict(list)
    for name in ("mla.tick.upload", "mla.tick.step"):
        for s in ps.children(run, ticks, name):
            if s.device_ms is not None:
                per_tick[s.parent].append(s.device_ms)
    return ps.median([sum(v) for v in per_tick.values() if len(v) == 2])
